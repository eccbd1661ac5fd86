"""General utilities (counterpart of ``hyperopt_tpu/utils.py``): the
bounded cache the suggesters keep their per-space proposal steps in,
the reference's timestamp helper, the cache of small device constants
that keeps a proposal step free of host-to-device copies, and upstream
hyperopt's host-only helpers (``import_tokens`` … ``get_closest_dir``),
copied."""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import functools
import os
import shutil
import threading

import numpy as np
import torch

from ._env import resolve_device

__all__ = ["LRUCache", "coarse_utcnow", "device_constant", "evaluation_device",
           "eval_device", "import_tokens", "json_call", "get_most_recent_inds", "fast_isin",
           "temp_dir", "working_dir", "path_split_all", "get_closest_dir"]

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


def import_tokens(tokens):
    """Import a dotted path given as a token list."""
    out = __import__(tokens[0])
    for t in tokens[1:]:
        out = getattr(out, t)
    return out


def json_call(json_spec, args=(), kwargs=None):
    """Call a function named by a dotted string or a ``(name, args,
    kwargs)`` spec."""
    kwargs = {} if kwargs is None else kwargs
    if isinstance(json_spec, str):
        return import_tokens(json_spec.split("."))(*args, **kwargs)
    if isinstance(json_spec, (list, tuple)):
        extra_args = json_spec[1] if len(json_spec) > 1 else []
        extra_kwargs = json_spec[2] if len(json_spec) > 2 else {}
        return import_tokens(json_spec[0].split("."))(
            *(list(args) + list(extra_args)), **{**kwargs, **extra_kwargs})
    raise TypeError(f"cannot json_call {json_spec!r}")


def get_most_recent_inds(obj):
    """Indices of the documents that are the latest version of their
    ``_id``."""
    ids = np.asarray([d["_id"] for d in obj])
    versions = np.asarray([d["version"] for d in obj])
    s = np.lexsort((versions, ids))  # by _id, then version
    recent = np.ones(len(s), dtype=bool)
    if len(s) > 1:
        recent[:-1] = ids[s][1:] != ids[s][:-1]
    return s[recent]


def fast_isin(X, Y):
    """Boolean mask of which entries of 1-D ``X`` appear in ``Y``."""
    return np.isin(np.asarray(X), np.asarray(Y))


@contextlib.contextmanager
def temp_dir(dir, erase_after=False, with_sentinel=True):
    """Create ``dir`` (with a sentinel marking it safe to delete), and
    remove it afterwards when ``erase_after`` and this call created it."""
    created_by_me = False
    if not os.path.exists(dir):
        os.makedirs(dir)
        created_by_me = True
        if with_sentinel:
            open(os.path.join(dir, ".hyperopt_temp_sentinel"), "w").close()
    try:
        yield dir
    finally:
        if erase_after and created_by_me and os.path.exists(dir):
            sentinel = os.path.join(dir, ".hyperopt_temp_sentinel")
            if not with_sentinel or os.path.exists(sentinel):
                shutil.rmtree(dir)


@contextlib.contextmanager
def working_dir(dir):
    """``chdir`` into ``dir`` for the block."""
    cwd = os.getcwd()
    os.chdir(dir)
    try:
        yield dir
    finally:
        os.chdir(cwd)


def path_split_all(path):
    """Every component of a path."""
    parts = []
    while True:
        path, tail = os.path.split(path)
        if tail:
            parts.append(tail)
        else:
            if path:
                parts.append(path)
            break
    parts.reverse()
    return parts


def get_closest_dir(workdir):
    """The deepest existing ancestor of ``workdir`` and the first missing
    component."""
    closest_dir = ""
    for wdi in path_split_all(workdir):
        if os.path.isdir(os.path.join(closest_dir, wdi)):
            closest_dir = os.path.join(closest_dir, wdi)
        else:
            break
    assert closest_dir != workdir
    return closest_dir, wdi
