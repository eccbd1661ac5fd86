"""General utilities (counterpart of ``hyperopt_tpu/utils.py``): the
bounded cache the suggesters keep their per-space proposal steps in,
the reference's timestamp helper, and the cache of small device
constants that keeps a proposal step free of host-to-device copies."""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import functools
import threading

import torch

from ._env import resolve_device

__all__ = ["LRUCache", "coarse_utcnow", "device_constant", "evaluation_device",
           "eval_device"]

_EVAL_DEVICE = contextvars.ContextVar("hyperopt_tpu_torch_eval_device", default=None)


@contextlib.contextmanager
def evaluation_device(device):
    """Within the block, :func:`eval_device` is ``device``.
    ``Domain.evaluate`` enters it with its trials' device, so an objective
    that makes its tensors from host numbers (the ML zoo domains) runs
    where the trials live: the worker threads and processes of the
    evaluation backends each enter it around their own evaluation."""
    token = _EVAL_DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _EVAL_DEVICE.reset(token)


def eval_device():
    """The device an objective given host numbers evaluates on: the one of
    the enclosing :func:`evaluation_device`, else the default device of
    the port (the CUDA card; without one this raises)."""
    dev = _EVAL_DEVICE.get()
    return dev if dev is not None else resolve_device(None)


_LRU_MISS = object()


@functools.lru_cache(maxsize=None)
def _constant(key, value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


def device_constant(value, dtype, device):
    """A tensor of the Python number or (nested) sequence ``value``, made
    once per (value, dtype, device) and cached for the process.

    Making a tensor from host data on a card copies it from the host,
    which a CUDA graph cannot record; a step that takes its constants from
    here makes them on its first (eager) run and only reads them after,
    so it can be captured.  The values come from search spaces and fixed
    constants, so the cache stays small, and its tensors live as long as
    any graph that reads them.  They are shared: never write to one.  The
    key is the value's ``repr``, so ``-0.0`` and ``0.0`` stay apart."""
    if isinstance(value, list):
        value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
    return _constant(repr(value), value, dtype, torch.device(device))


def coarse_utcnow():
    """Timestamp truncated to ms (hyperopt/utils.py sym: coarse_utcnow)."""
    now = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    return now.replace(microsecond=(now.microsecond // 1000) * 1000)


class LRUCache:
    """Bounded most-recently-used mapping; thread-safe.  ``hits`` and
    ``misses`` count :meth:`get` outcomes."""

    def __init__(self, maxsize):
        self.maxsize = int(maxsize)
        if self.maxsize < 1:
            raise ValueError(f"LRUCache maxsize must be >= 1, got {maxsize}")
        self._d = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        with self._lock:
            v = self._d.pop(key, _LRU_MISS)
            if v is _LRU_MISS:
                self.misses += 1
                return default
            self.hits += 1
            self._d[key] = v  # re-insert: most recently used at the end
            return v

    def put(self, key, value):
        with self._lock:
            self._d.pop(key, None)
            while len(self._d) >= self.maxsize:
                self._d.pop(next(iter(self._d)))
            self._d[key] = value

    def contains(self, key):
        """Membership without counting a hit or a miss or touching recency."""
        with self._lock:
            return key in self._d

    def values(self):
        """A snapshot of the cached values, least recently used first."""
        with self._lock:
            return list(self._d.values())

    def stats(self):
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "size": len(self._d), "maxsize": self.maxsize}
