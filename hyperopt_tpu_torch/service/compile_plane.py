"""The compile plane (counterpart of ``hyperopt_tpu/service/compile_plane.py``).

In the JAX package a new cohort key (space signature, TPE cfg, capacity
bucket) pays an XLA compile on the serving path, so its plane serves the
cohort's asks with flagged ``rand.suggest`` (the warming state) while a
background thread compiles, and replays a census of the keys users ask
for to compile the most used ones before a restarted server listens.

The port compiles nothing per key: a cohort's program is a sequence of
torch operators and two hand-written CUDA kernels, built once per
process from ``csrc/``.  So here:

* a cohort is always ready: no ask is ever served at the warming floor
  and no thread starts;
* :class:`SignatureCensus` is the JAX package's, byte for byte (sealed
  JSONL next to the WAL), so a census either package wrote feeds the
  other;
* :meth:`CompilePlane.warm_from_census` builds the CUDA kernel libraries
  (``_build.build_all``) and runs one tick of each of the top-N census
  cohorts at their recorded shapes on zero stacks, so the first request
  after a restart meets built kernels and a warm caching allocator;
* a WAL whose asks the JAX package's plane served while warming journals
  them as ``algo: "rand"``, and the scheduler's replay regenerates them
  through ``rand.suggest`` as it trusts every journaled algo.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

import numpy as np

from ..obs.metrics import get_metrics

__all__ = ["CompilePlane", "SignatureCensus", "census_path_for"]

logger = logging.getLogger(__name__)

#: census file name under a store root (next to the WAL)
CENSUS_BASENAME = "compile_census.jsonl"

#: append a census record when a key's in-process tick count crosses one
#: of these (bounded appends; the read side max-aggregates per key)
_MILESTONES = frozenset({1, 8, 64, 512, 4096, 32768})


def census_path_for(store_root):
    """The default census location for a scheduler persisting into
    ``store_root``."""
    return os.path.join(str(store_root), CENSUS_BASENAME)


class SignatureCensus:
    """Durable space-signature census: which cohort keys this service
    ticks, with approximate traffic counts.  Append-only sealed JSONL via
    ``O_APPEND`` single-line writes; best effort on the write side (a
    census I/O failure costs warm-start quality, never a request)."""

    def __init__(self, path):
        self.path = str(path)
        self._counts = {}  # key_id -> in-process tick count
        self._lock = threading.Lock()
        self._warned = False

    @staticmethod
    def key_id(spec, cfg, cap):
        """Canonical identity of one cohort class: the wire space spec,
        the TPE cfg and the capacity bucket (S and B drift with load; the
        census records the latest observed shape instead)."""
        return json.dumps([spec, sorted(cfg.items()), int(cap)],
                          sort_keys=True, separators=(",", ":"))

    def note(self, spec, cfg, cap, S, B, widen=False, kid=None):
        """Count one cohort tick for a key; journal at milestones.  A
        ``None`` spec (a direct-API study) is uncountable and skipped;
        ``kid`` is the cohort's cached :meth:`key_id`."""
        if not isinstance(spec, dict):
            return
        if kid is None:
            kid = self.key_id(spec, cfg, cap)
        with self._lock:
            n = self._counts.get(kid, 0) + 1
            self._counts[kid] = n
            if n in _MILESTONES:
                self._append({
                    "kind": "census", "spec": spec, "cfg": dict(cfg),
                    "cap": int(cap), "S": int(S), "B": int(B),
                    "widen": bool(widen), "count": n, "ts": time.time()})

    def _append(self, rec):
        from . import integrity

        line = (integrity.seal(rec) + "\n").encode()
        try:
            fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        except OSError as e:
            if not self._warned:
                self._warned = True
                logger.warning("census: cannot append to %s (%s); warm starts degrade",
                               self.path, e)

    def read(self):
        """Aggregate the on-disk census: one entry per key with the largest
        recorded count and the latest shape, most used first."""
        best = {}
        if os.path.exists(self.path):
            from . import integrity

            for chk in integrity.iter_checked_jsonl(self.path):
                if chk.status == integrity.CORRUPT:
                    logger.warning("census: %s:%d corrupt record skipped", self.path,
                                   chk.lineno)
                    continue
                if chk.rec is None:
                    continue
                rec = chk.rec
                if rec.get("kind") != "census":
                    continue
                spec, cfg = rec.get("spec"), rec.get("cfg")
                if not isinstance(spec, dict) or not isinstance(cfg, dict):
                    continue
                try:
                    kid = self.key_id(spec, cfg, rec.get("cap", 0))
                except TypeError:
                    continue
                cur = best.get(kid)
                if cur is None or rec.get("count", 0) >= cur.get("count", 0):
                    best[kid] = rec
        return sorted(best.values(),
                      key=lambda r: (-int(r.get("count", 0)), -float(r.get("ts", 0.0))))


def _space_from_wire(spec):
    """An hp space from a census record's spec wrapper (the WAL admit
    record's forms)."""
    if "zoo" in spec:
        from ..zoo import ZOO

        rec = ZOO.get(str(spec["zoo"]))
        return rec.space if rec is not None else None
    if "space" in spec:
        from .spacespec import space_from_spec

        return space_from_spec(spec["space"])
    return None


class CompilePlane:
    """The census and the pre-listener warm-up of one server process
    (module docstring).  ``device`` is where :meth:`warm_from_census`
    runs its ticks: the CUDA card unless ``device="cpu"``."""

    def __init__(self, census_path=None, metrics=None, device=None):
        from .._env import resolve_device

        self.device = resolve_device(device)
        self.census = SignatureCensus(census_path) if census_path else None
        self.metrics = metrics if metrics is not None else get_metrics("service")
        self._bank_keys = set()
        self.compiled = 0
        self.errors = 0

    def census_note(self, spec, cfg, cap, S, B, widen=False, kid=None):
        if self.census is not None:
            self.census.note(spec, cfg, cap, S, B, widen=widen, kid=kid)

    def _warm(self, rec):
        """One tick of a census cohort at its recorded shape, on zero
        stacks (every slot empty: its rows are no-ops)."""
        import torch

        from .. import quant
        from .._env import parse_hist_dtype
        from ..algos import tpe
        from ..base import Domain

        space = _space_from_wire(rec.get("spec") or {})
        if space is None:
            return False
        cs = Domain(None, space).cs
        S, cap, B = int(rec.get("S", 1)), int(rec.get("cap", 16)), int(rec.get("B", 1))
        hd, qp = quant.resolve(cs, parse_hist_dtype(), context="cohort")
        dev = self.device
        hist = {
            "vals": {l: torch.zeros((S, cap), dtype=quant.vals_dtype(hd), device=dev)
                     for l in cs.labels},
            "active": {l: torch.zeros((S, cap), dtype=torch.bool, device=dev)
                       for l in cs.labels},
            "losses": torch.full((S, cap), float("inf"), dtype=quant.losses_dtype(hd),
                                 device=dev),
            "has_loss": torch.zeros((S, cap), dtype=torch.bool, device=dev),
        }
        L = len(cs.labels)
        rows = np.zeros((S, 1, 2 * L + 3), np.float32)
        rows[:, :, 2 * L + 2] = float(cap)  # no-op rows
        run = tpe.build_suggest_batched(cs, rec.get("cfg") or {}, S, cap, B, hist_dtype=hd,
                                        fused=not bool(rec.get("widen", False)))
        _, packed = run(hist, rows, np.zeros((S, 2), np.uint32), np.zeros((S, B), np.uint32))
        packed.cpu()
        return True

    def warm_from_census(self, top_n=None):
        """Build the CUDA kernel libraries and run one tick of each of the
        ``top_n`` most used census cohorts (``HYPEROPT_TPU_COMPILE_BANK_TOP_N``
        by default) on this thread, before a server listens.  Returns
        ``(warmed, deferred)``: the rest warm on live traffic."""
        from .._env import parse_compile_bank_top_n

        if self.device.type == "cuda":
            from .._build import build_all

            build_all()
        if self.census is None:
            return 0, 0
        if top_n is None:
            top_n = parse_compile_bank_top_n()
        entries = self.census.read()
        warmed = 0
        for rec in entries[:top_n]:
            try:
                if self._warm(rec):
                    warmed += 1
                    self.compiled += 1
                    self._bank_keys.add(SignatureCensus.key_id(rec["spec"], rec["cfg"],
                                                               rec.get("cap", 0)))
            except Exception as e:  # noqa: BLE001 - a hostile census entry
                self.errors += 1
                self.metrics.counter("service.compile.errors").inc()
                logger.warning("compile plane: census warm-up failed: %s", e)
        self.metrics.gauge("service.compile.bank.keys").set(len(self._bank_keys))
        return warmed, max(0, len(entries) - top_n)

    def publish(self):
        """The ``/snapshot`` compile section, with the JAX package's keys
        (nothing queues here)."""
        g = self.metrics.gauge
        g("service.compile.queue_depth").set(0)
        g("service.compile.bank.keys").set(len(self._bank_keys))
        return {
            "queue_depth": 0,
            "ready_programs": self.compiled,
            "compiled": self.compiled,
            "errors": self.errors,
            "bank_keys": len(self._bank_keys),
            "bank_hits": 0,
            "census_path": self.census.path if self.census is not None else None,
        }
