"""The study scheduler: pack live studies into cohort slots and tick once
per ask wave (counterpart of ``hyperopt_tpu/service/scheduler.py``).

Studies sharing a search space, a TPE cfg and a capacity bucket land in
one **cohort**: a fixed-shape ``[S, cap]`` stack of device history slots.
Every ask wave runs one study-batched tell+ask program
(``tpe.build_suggest_batched``) per cohort instead of one tick per study.
For a space ``megakernel.supports``, that program draws and scores its
candidates in the fused CUDA kernel; every other numeric group scores in
``ei_diff``.  With ``widen`` on, a cohort of an unconditional space
(``tpe.widened_profile`` is not None) never takes the fused route, as in
the JAX package, and scores in grouped ``ei_diff``.  The JAX package's
positional slot layout, which lets every space of one widened profile
share a compiled program, has nothing to share here: the grouped cohort
already proposes as a widened slot does, bit for bit.

Determinism: a cohort of N studies proposes as N independent sequential
``fmin`` runs at the same per-study seeds would.  Each study's ask mirrors
``FMinIter``'s loop (ids from the study's trials, one seed per ask from
its ``rstate``, random search below ``n_startup_jobs``, the TPE cfg built
as ``tpe.suggest_async`` builds it), and per-id keys derive from the id
and the study seed, never from slot position or wave composition.  The
per-study host ``PaddedHistory`` arrays are authoritative; the cohort's
device stack mirrors them and an evicted study re-admits by re-upload.
Startup asks (below ``n_startup_jobs``) join the wave too and are drawn
in one batch per search space (``rand.suggest_many``), where the JAX
package draws each as it arrives: on the card a prior draw is some
hundred small launches whatever its width, and the docs and WAL records
are the same.

Durability and device faults, as in the JAX package: with a write-ahead
journal armed (``service/journal.py``; automatic under a store root) every
admit, ask and tell appends a record before the scheduler's state moves,
and :meth:`StudyScheduler.resume` replays it on construction, so a
restarted service re-admits every study and proposes as the run that was
not interrupted.  The journal's records are the JAX package's, so either
package resumes what the other wrote.  Device faults in a cohort tick
(the card out of memory, non-finite proposals, an injected ``tick``
fault) walk the :class:`~hyperopt_tpu_torch.service.overload.DegradeLadder`
down to a per-study ``rand.suggest`` floor and climb back after clean
waves; a fault of the kernels themselves is not one of them
(``overload.is_device_fault``).  Corrupt journal records quarantine their
study (410), never the process; a full disk sheds with 507.

The serving planes are armed by default, as in the JAX package: the
search-quality plane (``obs/quality.py``) and the tenant ledger
(``obs/tenant.py``) fold every settled tell, and the cost ledger
(``obs/load.py``) and the tenant ledger are charged each cohort tick's
measured dispatch+readback seconds (on the card the readback's host copy
waits for the kernels, so the sum is the tick's wall; nothing
synchronises for them).  A wave's asks pack by deficit-round-robin over
tenants.  None of them reads the RNG or a proposal, so armed and disarmed
schedulers propose the same streams bit for bit.

In a fleet (``service/fleet.py``) each shard's scheduler carries an
ownership ``fence``: a callable checked at every durability point (admit,
close, ask, wave start, tell), so a holder whose shard lease was
reclaimed refuses the mutation (:class:`StaleOwnershipError`, HTTP 503)
instead of journaling into a fenced epoch WAL.  ``fence is None`` outside
a fleet.

The compile plane has nothing to compile here: a cohort's program is
ready at once, so no ask is served at the warming floor (see
``service/compile_plane.py``).

Canary studies (``create_study(canary=True)``, the blackbox prober's,
``obs/prober.py``) serve exactly as a tenant study does, through the same
ask, tell and WAL path, but feed none of the quality, load and tenant
planes nor the census bank: probe traffic is free.  The flag rides the WAL
admit record, so a resumed canary stays one.

A scheduler given a ``profiler`` (the server passes the
:class:`~hyperopt_tpu_torch.obs.profiler.DeviceProfiler` it arms from
``HYPEROPT_TPU_PROFILE``) lets its wave leaders serve that profiler's
captures: the leader of a tick wave starts a pending capture's session
before its ticks and stops it after them, on its own thread, the only one
whose kernels a session records.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import chaos, quant
from .._env import (parse_compile_plane, parse_compile_widen, parse_hist_dtype,
                    parse_load, parse_quality, parse_service_degrade, parse_service_idle_sec,
                    parse_service_max_pending, parse_service_max_studies, parse_service_wal,
                    parse_shard, parse_store_gc, parse_store_watermark, parse_tenant,
                    parse_tenant_top_k, refuse_armed_knobs, resolve_device)
from ..algos import rand, tpe
from ..base import (JOB_STATE_DONE, STATUS_FAIL, STATUS_OK, Domain, Trials,
                    coarse_utcnow, spec_from_misc)
from ..obs import reqtrace
from ..obs.metrics import get_metrics
from ..obs.trace import Tracer
from . import integrity
from .integrity import StoreFullError
from .journal import JournalError, StudyJournal, wal_path_for
from .overload import (LADDER_LEVELS, DeadlineExceeded, DegradeLadder, NonFiniteProposal,
                       is_device_fault)

__all__ = ["StudyScheduler", "Study", "StudyQuotaError", "UnknownStudyError",
           "DuplicateTellError", "DrainingError", "QuarantinedStudyError",
           "StaleOwnershipError"]

log = logging.getLogger(__name__)


class UnknownStudyError(KeyError):
    """No live study with that id (never created, or closed)."""


class QuarantinedStudyError(RuntimeError):
    """The study's journal state was found corrupt and the study is
    quarantined: ask/tell/close answer HTTP 410 until an operator repairs
    the store (``python -m hyperopt_tpu_torch.service.scrub --repair``).
    Every other study on the same root keeps serving."""


class StudyQuotaError(RuntimeError):
    """An admission or per-study quota would be exceeded (HTTP 429)."""


class DrainingError(RuntimeError):
    """The service is draining: new studies and asks are refused (HTTP
    503 + ``Retry-After``), tells still land."""


class DuplicateTellError(RuntimeError):
    """The trial was already told (HTTP 409, a permanent conflict)."""


class StaleOwnershipError(RuntimeError):
    """The shard lease behind this scheduler was reclaimed (fleet mode):
    the mutation was refused before anything became durable, so the
    fenced epoch WAL gains no record the new owner's replay never saw.
    Retryable (HTTP 503): the retry meets the new owner's 307."""


def _refresh(study):
    """Rebuild the study's trials view from the docs it holds.  The base
    ``Trials.refresh``, also for a ``FileTrials``: the scheduler owns its
    store, every doc it lands or settles is written through and already
    held, so rescanning and unpickling the whole study directory (a
    ``FileTrials`` refresh) on every ask and tell would read back only
    what is in memory."""
    Trials.refresh(study.trials)


def _pow2(n):
    b = 1
    while b < n:
        b *= 2
    return b


#: wave and tick spans and degrade events feed the process flight ring
#: through a sink-less tracer (one span per wave, not per ask)
_tracer = Tracer()

#: bound on each study's in-memory audit timeline (the WAL is the
#: durable record, this ring the live ``GET /study/<id>/timeline`` view)
_STUDY_EVENT_CAP = 512

#: bound on each study's served-ask idempotency map
_SERVED_REQ_CAP = 128


def tpe_cfg(tpe_kwargs):
    """``tpe.suggest_async``'s cfg, field for field, from a study's TPE
    keyword arguments: each field it reads is popped from ``tpe_kwargs``,
    and the others take the defaults."""
    return {
        "prior_weight": float(tpe_kwargs.pop("prior_weight", tpe._default_prior_weight)),
        "n_EI_candidates": int(tpe_kwargs.pop("n_EI_candidates",
                                              tpe._default_n_EI_candidates)),
        "gamma": float(tpe_kwargs.pop("gamma", tpe._default_gamma)),
        "LF": int(tpe_kwargs.pop("linear_forgetting", tpe._default_linear_forgetting)),
        "ei_select": str(tpe_kwargs.pop("ei_select", "argmax")),
        "ei_tau": float(tpe_kwargs.pop("ei_tau", 1.0)),
        "prior_eps": float(tpe_kwargs.pop("prior_eps", 0.0)),
    }


class Study:
    """One study's serving state: compiled space, trials, RNG stream and
    quotas.  The ask/tell flow over these fields reproduces ``FMinIter``'s
    loop.  ``space_spec`` is the JSON-wire schema (or ``{"zoo": name}``)
    the study can be rebuilt from; None means a direct-API study that a
    replay cannot rebuild (journaled anyway, so replay counts it)."""

    def __init__(self, study_id, space, seed=0, n_startup_jobs=None,
                 max_trials=None, trials=None, space_spec=None, canary=False,
                 tenant=None, **tpe_kwargs):
        from ..obs.tenant import ANON, sanitize_tenant

        self.study_id = study_id
        # a blackbox prober's synthetic study: served as any other, kept
        # out of the planes' telemetry, charging and the census bank
        self.canary = bool(canary)
        # the principal the study's device time and tells are charged to;
        # "anon" is not stamped into the admit kwargs, so tenantless
        # journals stay byte-identical
        self.tenant = sanitize_tenant(tenant)
        self.domain = Domain(None, space)
        self.trials = trials if trials is not None else Trials()
        self.rstate = np.random.default_rng(seed)
        self.seed = int(seed)
        self.space_spec = space_spec
        # the WAL registry entry's kwargs, as the JAX package stamps them
        self.admit_kwargs = {}
        if self.canary:
            self.admit_kwargs["canary"] = True
        if self.tenant != ANON:
            self.admit_kwargs["tenant"] = self.tenant
        if n_startup_jobs is not None:
            self.admit_kwargs["n_startup_jobs"] = int(n_startup_jobs)
        if max_trials is not None:
            self.admit_kwargs["max_trials"] = int(max_trials)
        self.admit_kwargs.update(tpe_kwargs)
        self.n_startup_jobs = int(n_startup_jobs if n_startup_jobs is not None
                                  else tpe._default_n_startup_jobs)
        self.max_trials = None if max_trials is None else int(max_trials)
        self.cfg = tpe_cfg(tpe_kwargs)
        if tpe_kwargs:
            raise TypeError(f"unknown study kwargs: {sorted(tpe_kwargs)}")
        self.cfg_key = tuple(sorted(self.cfg.items()))
        self.state = "active"
        self.created = time.time()
        self.last_active = self.created
        self.n_asked = 0
        self.n_told = 0
        # the live audit timeline: admit, every ask, tell, void, evict,
        # resume boundary (pure metadata: never feeds the RNG)
        self.events = deque(maxlen=_STUDY_EVENT_CAP)
        self.events_dropped = 0
        # ask idempotency: client request id -> the tids that ask served;
        # journaled on the ask record, carried by snapshots
        self.served_reqs = {}
        self._best = None
        self._best_dirty = True

    def remember_req(self, req_id, tids):
        if not req_id:
            return
        self.served_reqs[str(req_id)] = [int(t) for t in tids]
        while len(self.served_reqs) > _SERVED_REQ_CAP:
            del self.served_reqs[next(iter(self.served_reqs))]

    def note(self, event, **attrs):
        """Append one audit-timeline event."""
        if len(self.events) == self.events.maxlen:
            self.events_dropped += 1
        rec = {"ts": time.time(), "event": event}
        rec.update({k: v for k, v in attrs.items() if v is not None})
        self.events.append(rec)

    def timeline_dict(self):
        """The ``GET /study/<id>/timeline`` payload."""
        return {
            "study_id": self.study_id,
            "state": self.state,
            "seed": self.seed,
            "created": self.created,
            "n_trials": self.n_trials,
            "n_asked": self.n_asked,
            "n_told": self.n_told,
            "best_loss": self.best_loss(),
            "events": list(self.events),
            "events_dropped": self.events_dropped,
        }

    def next_seed(self):
        """One suggest seed per ask: ``FMinIter``'s draw."""
        return int(self.rstate.integers(2**31 - 1))

    def touch(self):
        self.last_active = time.time()

    @property
    def n_trials(self):
        return len(self.trials._dynamic_trials)

    @property
    def n_pending(self):
        return self.n_asked - self.n_told

    def best_loss(self):
        """Best ok loss so far: one scan, then kept by :meth:`record_result`."""
        if self._best_dirty:
            oks = [r["loss"] for r in self.trials.results
                   if r.get("status") == STATUS_OK and r.get("loss") is not None]
            self._best = min(oks) if oks else None
            self._best_dirty = False
        return self._best

    def mark_best_dirty(self):
        self._best_dirty = True

    def record_result(self, loss):
        if loss is None or self._best_dirty:
            return
        if self._best is None or loss < self._best:
            self._best = float(loss)

    def status_dict(self):
        out = {
            "study_id": self.study_id,
            "state": self.state,
            "labels": list(self.domain.cs.labels),
            "n_trials": self.n_trials,
            "n_pending": self.n_pending,
            "n_asked": self.n_asked,
            "n_told": self.n_told,
            "best_loss": self.best_loss(),
            "max_trials": self.max_trials,
            "created": self.created,
            "last_active": self.last_active,
            "seed": self.seed,
            # the JAX package's compile-plane flag: a cohort is always
            # ready here, so no study ever warms
            "warming": False,
        }
        if self.canary:
            out["canary"] = True
        if self.tenant != "anon":
            out["tenant"] = self.tenant
        return out


class _AskReq:
    """One TPE ask waiting for a cohort tick.  ``algo`` records what
    served it ("tpe", or "rand" at the ladder's floor) for the WAL and the
    flagged answer; ``replay`` marks a WAL regeneration (already
    journaled); ``deadline`` is the request's monotonic budget."""

    __slots__ = ("study", "new_ids", "seed", "docs", "error", "algo", "degraded",
                 "replay", "deadline", "journaled", "trace", "wave", "req", "startup")

    def __init__(self, study, new_ids, seed, deadline=None, replay=False, trace=None,
                 req=None):
        self.study = study
        self.new_ids = new_ids
        self.seed = seed
        self.docs = None
        self.error = None
        self.algo = "tpe"
        self.degraded = False
        self.replay = replay
        self.deadline = deadline
        self.trace = trace
        self.req = req  # the client's idempotency token
        self.wave = None
        # True once the served ask is in the WAL: a later landing failure
        # must not journal a void record too (two records would replay
        # the one seed draw twice)
        self.journaled = False
        self.startup = False  # a random-search ask below n_startup_jobs


#: smallest cohort slot capacity: serving-scale studies hold tens of trials,
#: and proposals do not depend on the padded capacity (padding is masked),
#: so a slot runs a tighter bucket than ``PaddedHistory``'s host minimum.  A
#: study that outgrows its bucket migrates at its next ask.
_COHORT_CAP_FLOOR = 16


def _cohort_cap(n):
    """Power-of-two slot capacity for a study with ``n`` live trials (+1 so
    one settled trial between waves never forces a migration)."""
    cap = _COHORT_CAP_FLOOR
    while cap < n + 1:
        cap *= 2
    return cap


class _Cohort:
    """Fixed-shape device slots for studies sharing (space signature, TPE
    cfg, capacity bucket).  Owns the stacked ``[S, cap]`` device mirror;
    each study's host arrays stay authoritative: admission uploads them,
    ticks move only the pending tell rows.  A ``widen`` cohort keeps off
    the fused route."""

    _ROW_BUCKET = 16  # pending rows folded in place; past this, re-upload

    def __init__(self, cs, cfg, cap, hist_dtype, device, widen=False):
        self.cs = cs
        self.cfg = dict(cfg)
        self.cap = int(cap)
        self.device = device
        # int8/fp8 resolve to (name, qparams) when the space is codable,
        # else to bf16: hist_dtype is the storage the stack really has
        self.hist_dtype, self.qparams = quant.resolve(cs, str(hist_dtype), context="cohort")
        self.slots = [None]  # Study | None; a power-of-two count
        self.slot_of = {}    # study_id -> slot
        self._dev = None     # stacked history, or None (rebuild at next tick)
        self._mesh = None    # geometry of the mesh the stack is placed on
        self._synced = {}    # slot -> host rows already folded on the device
        self.widen = bool(widen)
        self.ticks = 0
        self._census_kid = None  # the compile plane's census key, cached

    @property
    def n_slots(self):
        return len(self.slots)

    @property
    def n_live(self):
        return len(self.slot_of)

    def fused(self):
        """Whether this cohort's ticks run the fused kernel."""
        from .. import megakernel

        return not self.widen and megakernel.armed(self.cs)

    def admit(self, study):
        """Place ``study`` in a free slot, doubling the slot count when full;
        the stack rebuilds at the next tick."""
        if study.study_id in self.slot_of:
            return self.slot_of[study.study_id]
        if None not in self.slots:
            self.slots.extend([None] * len(self.slots))
        slot = self.slots.index(None)
        self.slots[slot] = study
        self.slot_of[study.study_id] = slot
        self._dev = None
        return slot

    def evict(self, study_id):
        """Free the study's slot; an empty slot's rows are no-ops and its
        outputs are discarded, so the stack stays valid."""
        slot = self.slot_of.pop(study_id, None)
        if slot is not None:
            self.slots[slot] = None
            self._synced.pop(slot, None)
        return slot

    def _history(self, study):
        ph = study.trials.history_object(self.cs.labels)
        if self.qparams is not None:
            # snap-at-ingest: the study's host values become grid points, so
            # host uploads and in-place row folds encode to the same codes
            ph.ensure_qparams(self.cs)
        return ph

    def _upload_stack(self):
        """Build the stacked device mirror from every slotted study's host
        arrays (admission, growth, recovery)."""
        L = self.cs.labels
        S, cap = self.n_slots, self.cap
        vals = {l: np.zeros((S, cap), np.float32) for l in L}
        active = {l: np.zeros((S, cap), bool) for l in L}
        losses = np.full((S, cap), np.inf, np.float32)
        has_loss = np.zeros((S, cap), bool)
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            ph = self._history(st)
            host = ph.host_padded()
            c = min(cap, ph.cap)  # the live prefix; the rest stays padding
            for l in L:
                vals[l][slot, :c] = host["vals"][l][:c]
                active[l][slot, :c] = host["active"][l][:c]
            losses[slot, :c] = host["losses"][:c]
            has_loss[slot, :c] = host["has_loss"][:c]
            self._synced[slot] = ph.n
        dev = self.device

        def enc(x, label):
            if self.qparams is None:
                return torch.tensor(x, dtype=quant.vals_dtype(self.hist_dtype), device=dev)
            # host encode of snapped grid values: the same codes as the
            # in-place fold's quant.quantize
            return quant.quantize_np(x, self.qparams[label], self.hist_dtype) \
                .reshape(x.shape).to(dev)

        self._dev = {
            "vals": {l: enc(vals[l], l) for l in L},
            "active": {l: torch.tensor(active[l], device=dev) for l in L},
            "losses": torch.tensor(losses, dtype=quant.losses_dtype(self.hist_dtype), device=dev),
            "has_loss": torch.tensor(has_loss, device=dev),
        }

    def tick(self, demand, mesh=None, cand_scale=1.0):
        """One study-batched tell+ask launch sequence for the whole cohort.

        ``demand``: ``{slot: (ids uint32, seed)}``, at most one ask per slot.
        Every occupied slot's pending tell rows fold, asking or not.
        Returns the packed ``[S, B, L]`` device tensor, still in flight: the
        caller reads it back after every cohort of the wave has launched.
        ``mesh`` splits the slots over its entries
        (``build_suggest_batched(mesh=...)``); the stack is then placed
        on it, and re-placed when the mesh changes.  ``cand_scale < 1`` is
        the degrade ladder shrinking ``n_EI_candidates`` for this tick
        (the kernels then launch at the scaled candidate count)."""
        self.ticks += 1
        L = len(self.cs.labels)
        B = _pow2(max((len(ids) for ids, _ in demand.values()), default=1))
        # a study that outgrew this bucket leaves (its next ask re-admits
        # it to the right cohort); folding its rows would write past the slot
        phs = {}
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            ph = self._history(st)
            if ph.n > self.cap:
                self.evict(st.study_id)
                continue
            phs[slot] = ph
        delta = max([ph.n - self._synced.get(slot, 0) for slot, ph in phs.items()] or [0])
        geom = None if mesh is None else mesh.geometry()
        if self._dev is not None and (delta > self._ROW_BUCKET or geom != self._mesh):
            self._dev = None
        if self._dev is None:
            self._upload_stack()
            if mesh is not None:
                from ..parallel import sharding

                self._dev = sharding.place_history(self._dev, mesh, study_axis=True)
            self._mesh = geom
            delta = 0
        K = _pow2(max(delta, 1))

        S = self.n_slots
        R = 2 * L + 3
        rows = np.zeros((S, K, R), np.float32)
        rows[:, :, R - 1] = float(self.cap)  # padding rows are dropped
        seed_words = np.zeros((S, 2), np.uint32)
        ids = np.zeros((S, B), np.uint32)
        pending = {}
        for slot, ph in phs.items():
            rows[slot] = ph.pack_rows(self._synced.get(slot, 0), K, noop_index=self.cap)
            pending[slot] = ph.n
        for slot, (slot_ids, seed) in demand.items():
            seed_words[slot] = tpe._seed_words(seed)
            ids[slot, :len(slot_ids)] = slot_ids
            ids[slot, len(slot_ids):] = slot_ids[-1]  # pad by repeating the last id

        cfg = self.cfg
        if cand_scale != 1.0:
            cfg = dict(cfg)
            cfg["n_EI_candidates"] = max(1, int(cfg["n_EI_candidates"] * cand_scale))
        run = tpe.build_suggest_batched(self.cs, cfg, S, self.cap, B, mesh=mesh,
                                        hist_dtype=self.hist_dtype, fused=not self.widen)
        try:
            self._dev, packed = run(self._dev, rows, seed_words, ids)
        except BaseException:
            # a half-applied in-place fold: rebuild from the host arrays
            self.abandon_device()
            raise
        self._synced.update(pending)
        return packed

    def abandon_device(self):
        """Drop the device stack after a failed launch or readback."""
        self._dev = None
        self._synced = {}


class StudyScheduler:
    """Create/ask/tell over many studies, batched onto cohort ticks.

    Thread-safe.  Concurrent :meth:`ask` callers coalesce through the
    ``wave_window`` gather pause: the first thread to become the wave
    leader releases the lock for that window, every asker arriving
    meanwhile joins the same wave, and one tick per cohort serves them
    all.  With ``wave_window=0`` (direct in-process use) asks serialize;
    :meth:`ask_many` expresses a wave explicitly.  The HTTP server runs
    a small window.

    ``device`` is where the cohorts' histories live and tick: the CUDA
    card unless ``device="cpu"`` (without a card the default raises).
    ``hist_dtype`` names their storage (``HYPEROPT_TPU_HIST_DTYPE`` by
    default).  ``widen`` (``HYPEROPT_TPU_COMPILE_WIDEN`` by default)
    widens the cohorts of unconditional spaces: they keep off the fused
    route.

    ``store_root`` keeps every study in a ``FileTrials`` under
    ``<store_root>/<study_id>``.  ``wal`` arms the write-ahead journal:
    None resolves ``HYPEROPT_TPU_SERVICE_WAL`` (auto: under the store
    root when there is one), False disarms, a path or a
    :class:`~hyperopt_tpu_torch.service.journal.StudyJournal` arms it.  An
    armed journal replays on construction (``auto_resume=False`` defers to
    :meth:`resume`).  ``degrade`` is the ladder's patience (None:
    ``HYPEROPT_TPU_SERVICE_DEGRADE``, default 8 clean waves; False: a tick
    fault fails its asks).  ``overload`` is an optional
    :class:`~hyperopt_tpu_torch.service.overload.AdmissionGuard` fed the
    wave times.  ``compile_plane`` (None: ``HYPEROPT_TPU_COMPILE_PLANE``,
    off by default) keeps the signature census.

    ``quality``, ``load`` and ``tenants`` are the serving planes: None
    resolves ``HYPEROPT_TPU_QUALITY`` / ``_LOAD`` / ``_TENANT`` (each on
    by default), False disarms (the attribute is then None), an instance
    arms it explicitly.  They are built before the WAL replays, so a
    resume rebuilds their state.  ``profiler`` (a
    :class:`~hyperopt_tpu_torch.obs.profiler.DeviceProfiler`) has the wave
    leaders serve its captures, one wave each."""

    def __init__(self, max_studies=None, max_pending=None, idle_sec=None,
                 device=None, hist_dtype=None, store_root=None, wave_window=0.0,
                 wal=None, degrade=None, overload=None, auto_resume=True,
                 compile_plane=None, widen=None, quality=None, load=None, tenants=None,
                 profiler=None):
        refuse_armed_knobs("StudyScheduler")
        self.device = resolve_device(device)
        self.hist_dtype = str(hist_dtype) if hist_dtype else parse_hist_dtype()
        quant.vals_dtype(self.hist_dtype)  # an unknown name raises here
        self.max_studies = (parse_service_max_studies() if max_studies is None
                            else int(max_studies))
        self.max_pending = (parse_service_max_pending() if max_pending is None
                            else int(max_pending))
        self.idle_sec = parse_service_idle_sec() if idle_sec is None else float(idle_sec)
        if self.idle_sec <= 0:
            self.idle_sec = math.inf  # 0 means never evict on idleness
        self.widen = parse_compile_widen() if widen is None else bool(widen)
        self.store_root = None if store_root is None else str(store_root)
        self.wave_window = float(wave_window)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._studies = {}
        self._cohorts = {}  # (signature, cfg_key, cap) -> _Cohort
        self._wave_reqs = []
        self._tick_running = False
        self._draining = False
        self._wave_seq = 0
        self.metrics = get_metrics("service")
        self.overload = overload
        # the fleet's ownership fence: a callable answering "does this
        # shard's lease still stand?", checked at every durability point;
        # None outside a fleet
        self.fence = None
        self.profiler = None
        self.set_profiler(profiler)

        self._owns_plane = False
        if compile_plane is None and parse_compile_plane():
            from .compile_plane import CompilePlane, census_path_for

            compile_plane = CompilePlane(
                census_path=census_path_for(store_root) if store_root is not None else None,
                metrics=self.metrics, device=self.device)
            self._owns_plane = True
        self.compile_plane = compile_plane or None

        if wal is None:
            mode = parse_service_wal()
            if mode == "auto":
                self.journal = (StudyJournal(wal_path_for(store_root))
                                if store_root is not None else None)
            elif mode is None:
                self.journal = None
            else:
                self.journal = StudyJournal(mode)
        elif wal is False:
            self.journal = None
        elif isinstance(wal, StudyJournal):
            self.journal = wal
        else:
            self.journal = StudyJournal(wal)

        if degrade is None:
            patience = parse_service_degrade()
        elif degrade is False:
            patience = None
        else:
            patience = int(degrade)
        self.degrade = (DegradeLadder(patience, metrics=self.metrics)
                        if patience is not None else None)

        # storage integrity: the per-study quarantine map (durable through
        # `quarantine` WAL records), the disk watermark over the durable
        # root and the store-full shed latch the ENOSPC path arms
        self._quarantined = {}
        self._gc_enabled = parse_store_gc()
        self._store_full = False
        self._store_full_src = None  # "watermark" | "enospc" | None
        self._last_rung = 0.0
        self._rung_running = False
        self.last_gc = None
        self.watermark = None
        wm_root = (store_root if store_root is not None
                   else (os.path.dirname(self.journal.path) or "."
                         if self.journal is not None else None))
        if wm_root is not None:
            self.watermark = integrity.DiskWatermark(
                wm_root, threshold=parse_store_watermark(), metrics=self.metrics)

        if quality is None:
            from ..obs.quality import QualityPlane

            quality = QualityPlane(metrics=self.metrics, tracer=_tracer) \
                if parse_quality() else False
        self.quality = quality or None
        if load is None:
            from ..obs.load import CostLedger

            load = CostLedger(metrics=self.metrics) if parse_load() else False
        self.load = load or None
        if tenants is None:
            from ..obs.tenant import TenantLedger

            tenants = TenantLedger(metrics=self.metrics, top_k=parse_tenant_top_k()) \
                if parse_tenant() else False
        self.tenants = tenants or None

        self.last_resume = None  # stats of the latest WAL replay
        if auto_resume and self.journal is not None:
            self.resume()

    def set_profiler(self, profiler):
        """Have this scheduler's wave leaders serve ``profiler``'s captures
        (None: none)."""
        if self.profiler is not None:
            self.profiler.detach_waves()
        self.profiler = profiler
        if profiler is not None:
            profiler.attach_waves()

    # -- study lifecycle ---------------------------------------------------

    def create_study(self, space, seed=0, study_id=None, space_spec=None, _replay=False,
                     **kwargs):
        """Admit a new study and return its id.  ``kwargs`` are
        ``n_startup_jobs``, ``max_trials`` and ``tpe.suggest``'s tuning
        arguments; ``space_spec`` (the wire schema the space was built
        from) makes the study resumable from the WAL.  Raises
        :class:`StudyQuotaError` past ``max_studies`` (replayed admissions
        bypass it)."""
        from ..filestore import FileTrials, new_run_id

        chaos.point("admit", self.metrics)
        with self._lock:
            if self._draining and not _replay:
                raise DrainingError("service is draining; not admitting new studies")
            if not _replay and self.fence is not None and not self.fence():
                # an admit journaled into a fenced epoch WAL would mint a
                # study no later owner learns of
                raise StaleOwnershipError("shard lease lost; study admission refused")
            live = sum(1 for s in self._studies.values() if s.state == "active")
            if live >= self.max_studies and not _replay:
                raise StudyQuotaError(f"study quota reached ({self.max_studies} live studies)")
            study_id = study_id or new_run_id("study")
            if study_id in self._studies:
                raise StudyQuotaError(f"study id {study_id!r} already exists")
            if self.store_root is not None:
                trials = FileTrials(os.path.join(self.store_root, study_id), device=self.device)
                trials.hist_dtype = self.hist_dtype
            else:
                trials = Trials(device=self.device, hist_dtype=self.hist_dtype)
            st = Study(study_id, space, seed=seed, trials=trials, space_spec=space_spec,
                       **kwargs)
            trace = reqtrace.current_trace_id()
            if self.journal is not None and not _replay:
                try:
                    self.journal.append(StudyJournal.admit_rec(
                        study_id, space_spec, st.seed, st.admit_kwargs, trace=trace))
                    self.journal.sync()  # admits are rare; durable now
                except StoreFullError as e:
                    self._enter_store_full(f"admit WAL append: {e}")
                    raise
            st.note("admit", trace=trace, replay=True if _replay else None)
            self._studies[study_id] = st
            if self.tenants is not None and not st.canary:
                # replay included: WAL replay rebuilds the tenant tables
                self._plane_call("tenant note_study", self.tenants.note_study, st.tenant)
            self.metrics.counter("service.studies_created").inc()
            self.metrics.gauge("service.studies_live").set(live + 1)
            return study_id

    def close_study(self, study_id):
        """Mark a study closed and free its cohort slot (its trials stay
        readable; the quota counts active studies only).  A settled study
        compacts the WAL."""
        with self._lock:
            st = self._get(study_id)
            if self.fence is not None and not self.fence():
                raise StaleOwnershipError(f"{study_id}: shard lease lost; close refused")
            st.state = "closed"
            trace = reqtrace.current_trace_id()
            if self.journal is not None:
                self.journal.append(StudyJournal.close_rec(study_id, trace=trace))
                self.journal.sync()
            st.note("close", trace=trace)
            if self.tenants is not None and not st.canary:
                self._plane_call("tenant forget_study", self.tenants.forget_study, st.tenant)
            self._evict_from_cohort(st)
            self._gc_cohorts()
            self.metrics.gauge("service.studies_live").set(
                sum(1 for s in self._studies.values() if s.state == "active"))
            self._maybe_compact()

    @staticmethod
    def _plane_call(what, fn, *args, **kwargs):
        """Feed an observability plane; a plane fault is logged, never
        raised (it must not fail an admit, a wave or a tell)."""
        try:
            fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            log.warning("%s failed: %s", what, e)

    def _get(self, study_id):
        if study_id in self._quarantined:
            raise QuarantinedStudyError(
                f"{study_id} is quarantined "
                f"({self._quarantined[study_id].get('reason', 'corrupt')})")
        st = self._studies.get(study_id)
        if st is None:
            raise UnknownStudyError(study_id)
        return st

    # -- storage integrity -------------------------------------------------

    def _quarantine_study(self, sid, reason):
        """A per-study corruption fault: 410 on ask/tell, listed in
        ``/studies``, its slot freed; its trials stay on disk as
        evidence."""
        if sid in self._quarantined:
            return
        self._quarantined[sid] = {"reason": str(reason), "ts": time.time()}
        st = self._studies.get(sid)
        if st is not None:
            st.state = "quarantined"
            self._evict_from_cohort(st)
            st.note("quarantine", reason=str(reason))
        self.metrics.counter("service.integrity.quarantines").inc()
        log.warning("service: study %s QUARANTINED (%s); every other study keeps serving",
                    sid, reason)

    def _enter_store_full(self, reason, retry_after=1.0, source="enospc"):
        """Arm the store-full shed (507 + Retry-After at the admission
        guard for one latch window, then a probe request re-tests the
        disk) and start the space rung (compaction + bounded GC) off the
        request path.  A ``watermark`` latch clears when statvfs says
        space returned; an ``enospc`` latch only on a durable write that
        succeeds."""
        self._run_space_rung_async()
        self._store_full = True
        self._store_full_src = source
        self.metrics.gauge("store.full").set(1)
        if self.overload is not None:
            self.overload.set_store_full(True, reason=reason, retry_after=retry_after)

    def _exit_store_full(self):
        if not self._store_full:
            return
        self._store_full = False
        self._store_full_src = None
        self.metrics.gauge("store.full").set(0)
        if self.overload is not None:
            self.overload.set_store_full(False)

    def _run_space_rung_async(self, cooldown=5.0):
        """The space-pressure rung on a daemon thread: compact the
        quiescent WAL and run the bounded store GC (cooldown-limited,
        single-flight)."""
        now = time.monotonic()
        if now - self._last_rung < cooldown or self._rung_running:
            return
        self._last_rung = now
        self._rung_running = True

        def rung():
            try:
                try:
                    with self._lock:
                        self._maybe_compact()
                except Exception:  # noqa: BLE001 - full disks fail this
                    pass
                if self._gc_enabled and self.store_root is not None:
                    try:
                        self.last_gc = integrity.gc_store_root(self.store_root,
                                                               metrics=self.metrics)
                    except Exception:  # noqa: BLE001
                        log.warning("service: store gc failed", exc_info=True)
            finally:
                self._rung_running = False

        threading.Thread(target=rung, name="hyperopt-store-rung", daemon=True).start()

    def _check_store(self, force=False):
        """The per-wave / per-scrape watermark poll (statvfs at most once a
        second): entering low space arms the shed, staying low re-arms
        its latch, leaving it clears a watermark-armed latch."""
        if self.watermark is None:
            return None
        state = self.watermark.sample(force=force)
        if state is None:
            return None
        if state["low"]:
            reason = (f"disk watermark: {state['free_bytes']} bytes free "
                      f"({state['free_frac']:.1%})")
            if not self._store_full:
                self._enter_store_full(reason, source="watermark")
            elif self.overload is not None:
                self.overload.set_store_full(True, reason=reason, retry_after=1.0)
        elif self._store_full and self._store_full_src == "watermark":
            self._exit_store_full()
        return state

    def store_health(self, force=False):
        """The ``/snapshot`` and ``/metrics`` storage block."""
        with self._lock:
            state = self._check_store(force=force)
            out = {"store_full": self._store_full, "quarantined": len(self._quarantined)}
            if state is not None:
                out.update({k: state[k] for k in ("free_bytes", "used_frac", "low")})
            if self.last_gc is not None:
                out["gc"] = self.last_gc
            return out

    # -- cohort packing ----------------------------------------------------

    def _cohort_for(self, st):
        """The cohort of the study's (space, cfg, capacity bucket), moving
        the study there when its bucket grew."""
        ph = st.trials.history_object(st.domain.cs.labels)
        cap = _cohort_cap(ph.n)
        key = (st.domain.cs.signature(), st.cfg_key, cap)
        cohort = self._cohorts.get(key)
        if cohort is None:
            cs = st.domain.cs
            widen = self.widen and tpe.widened_profile(cs) is not None
            cohort = self._cohorts[key] = _Cohort(cs, st.cfg, cap, self.hist_dtype,
                                                  self.device, widen=widen)
        if st.study_id not in cohort.slot_of:
            self._evict_from_cohort(st)  # from a smaller bucket it may hold
            cohort.admit(st)
            st.note("cohort_admit", cap=cohort.cap)
        return cohort

    def _evict_from_cohort(self, st):
        for cohort in self._cohorts.values():
            if cohort.evict(st.study_id) is not None:
                self.metrics.counter("service.evictions").inc()
                st.note("evict", cap=cohort.cap)

    def evict_idle(self, now=None):
        """Free the slots of studies idle past ``idle_sec`` (the study
        survives; its next ask re-admits it from the host arrays)."""
        now = time.time() if now is None else now
        with self._lock:
            for st in self._studies.values():
                if st.state == "active" and now - st.last_active > self.idle_sec:
                    self._evict_from_cohort(st)

    def _gc_cohorts(self):
        """Drop cohorts with no live slot (studies migrate between buckets;
        an abandoned cohort would pin its stack)."""
        with self._lock:
            for key in [k for k, c in self._cohorts.items() if c.n_live == 0]:
                del self._cohorts[key]

    def slot_utilization(self):
        """Occupied fraction of all cohort slots."""
        with self._lock:
            total = sum(c.n_slots for c in self._cohorts.values())
            live = sum(c.n_live for c in self._cohorts.values())
            return (live / total) if total else 0.0

    # -- ask / tell --------------------------------------------------------

    def _prepare_ask(self, st, n, deadline=None, req_id=None):
        """Draw ids and a seed for one ask as ``FMinIter`` would.  Returns
        an :class:`_AskReq`: for a cohort tick, or marked ``startup`` (below
        ``n_startup_jobs``, random search) for :meth:`_serve_startup`.
        ``req_id`` is the client's idempotency token: a retried ask whose
        first attempt was served answers the same trials (returned as its
        docs), checked before anything else."""
        if req_id is not None:
            tids = st.served_reqs.get(str(req_id))
            if tids is not None:
                by_tid = {d["tid"]: d for d in st.trials._dynamic_trials}
                docs = [by_tid[t] for t in tids if t in by_tid]
                if len(docs) == len(tids):
                    self.metrics.counter("service.asks_deduped").inc(len(tids))
                    st.note("ask_dedupe", tids=tids, trace=reqtrace.current_trace_id())
                    return docs
        if st.state != "active":
            raise UnknownStudyError(f"{st.study_id} is {st.state}")
        if self._draining:
            raise DrainingError("service is draining; not admitting new asks")
        if self.fence is not None and not self.fence():
            raise StaleOwnershipError(f"{st.study_id}: shard lease lost; ask refused")
        n = int(n)
        if n < 1:
            raise ValueError("ask n must be >= 1")
        if st.n_pending + n > self.max_pending:
            raise StudyQuotaError(
                f"{st.study_id}: {st.n_pending} pending + {n} asked would exceed "
                f"the per-study quota ({self.max_pending})")
        if st.max_trials is not None and st.n_trials + n > st.max_trials:
            raise StudyQuotaError(
                f"{st.study_id}: budget exhausted ({st.n_trials}/{st.max_trials} trials)")
        new_ids = st.trials.new_trial_ids(n)
        _refresh(st)
        seed = st.next_seed()
        st.touch()
        st.n_asked += n
        self.metrics.counter("service.asks").inc()
        req = _AskReq(st, new_ids, seed, deadline=deadline, trace=reqtrace.current_trace_id(),
                      req=req_id)
        req.startup = len(st.trials.trials) < st.n_startup_jobs
        return req

    def _serve_startup(self, reqs):
        """Serve startup asks: one batched prior draw per search space
        (``rand.suggest_many``, the docs ``rand.suggest`` gives each ask),
        then, in request order, the WAL record and the landing each has
        when served alone, and one fsync.  A failure errors the asks it
        reaches (``r.error``); the caller releases their quotas and
        journals the burned draws void, as for a failed tick."""
        by_space = {}
        for r in reqs:
            by_space.setdefault(r.study.domain.cs.signature(), []).append(r)
        for group in by_space.values():
            try:
                docs = rand.suggest_many([(r.new_ids, r.study.domain, r.study.trials, r.seed)
                                          for r in group])
            except Exception as e:  # noqa: BLE001 - errors this space's asks only
                for r in group:
                    r.error = e
                continue
            for r, d in zip(group, docs):
                r.docs = d
        served = []
        for r in reqs:
            if r.error is not None:
                continue
            try:
                r.algo = "rand"
                self._journal_ask(r.study, r.new_ids, r.seed, "rand", trace=r.trace, req=r.req)
                r.journaled = True
                self._land(r.study, r.docs)
                r.study.remember_req(r.req, r.new_ids)
                r.study.note("ask", tids=[int(t) for t in r.new_ids], algo="rand",
                             startup=True, trace=r.trace)
                served.append(r)
            except Exception as e:  # noqa: BLE001 - per-req isolation
                r.error = e
        if self.journal is not None and served:
            try:
                self.journal.sync()
            except JournalError as e:
                for r in served:
                    r.error = e

    def _journal_ask(self, st, new_ids, seed, algo, trace=None, req=None):
        """WAL the served ask before its docs land."""
        if self.journal is not None:
            self.journal.append(StudyJournal.ask_rec(st.study_id, new_ids, seed, algo,
                                                     trace=trace, req=req))

    def _journal_void_ask(self, st, new_ids, seed, trace=None, reason=None):
        """A failed or shed ask still consumed one seed draw and its trial
        ids: record them as a ``void`` ask so replay advances the stream
        and retires the same ids.  Best effort on the WAL side."""
        st.note("void", tids=[int(t) for t in new_ids], trace=trace, reason=reason)
        if self.journal is None:
            return
        try:
            self.journal.append(StudyJournal.ask_rec(st.study_id, new_ids, seed, "void",
                                                     trace=trace))
            self.journal.sync()
        except JournalError as e:
            log.warning("service: could not journal void ask for %s: %s", st.study_id, e)

    def _land(self, st, docs):
        st.trials.insert_trial_docs(docs)
        _refresh(st)

    def _answers(self, st, docs, algo="tpe", degraded=False, wave=None):
        out = [{"study_id": st.study_id, "tid": d["tid"],
                "params": spec_from_misc(d["misc"])} for d in docs]
        if wave is not None:
            for a in out:
                a["wave"] = int(wave)
        if degraded:
            # in-band: the client learns its proposal came from the ladder
            for a in out:
                a["degraded"] = True
                a["algo"] = algo
        return out

    def _ladder_spec(self):
        return self.degrade.spec() if self.degrade is not None else LADDER_LEVELS[0]

    def _serve_rand_fallback(self, r):
        """The ladder's floor: serve one TPE ask on the host through
        ``rand.suggest`` with the same ids and seed (the WAL records
        ``algo="rand"`` so a replay regenerates the same docs)."""
        docs = rand.suggest(r.new_ids, r.study.domain, r.study.trials, r.seed)
        r.algo = "rand"
        r.degraded = True
        self.metrics.counter("service.degraded_asks").inc(len(r.new_ids))
        return docs

    def _finish_req(self, r, docs):
        """Journal (write-ahead) and land one served ask; replay reqs are
        in the WAL already."""
        if not r.replay:
            self._journal_ask(r.study, r.new_ids, r.seed, r.algo, trace=r.trace, req=r.req)
            r.journaled = True
        self._land(r.study, docs)
        r.study.remember_req(r.req, r.new_ids)
        r.docs = docs
        r.study.note("ask", tids=[int(t) for t in r.new_ids], algo=r.algo, wave=r.wave,
                     trace=r.trace, degraded=True if r.degraded else None,
                     replay=True if r.replay else None)

    def _cohort_mesh(self, cohort):
        """The mesh ``HYPEROPT_TPU_SHARD`` splits a cohort's slots over, or
        None: unset, a one-entry mesh, a widened cohort, or a slot count
        the mesh does not divide (small cohorts stay on one device rather
        than padding slots)."""
        n_shard = parse_shard()
        if n_shard is None or cohort.widen:
            return None
        from ..parallel import sharding

        mesh = sharding.suggest_mesh(n_shard, device=self.device)
        if mesh.size > 1 and cohort.n_slots % mesh.size == 0:
            return mesh
        return None

    def _census_note(self, cohort, cohort_reqs):
        """Count one live tick in the compile plane's signature census."""
        plane = self.compile_plane
        spec0 = next((r.study.space_spec for r in cohort_reqs
                      if r.study.space_spec is not None), None)
        if plane.census is None or spec0 is None:
            return
        from .compile_plane import SignatureCensus

        if cohort._census_kid is None:
            cohort._census_kid = SignatureCensus.key_id(spec0, cohort.cfg, cohort.cap)
        B = _pow2(max(len(r.new_ids) for r in cohort_reqs))
        plane.census_note(spec0, cohort.cfg, cohort.cap, cohort.n_slots, B,
                          widen=cohort.widen, kid=cohort._census_kid)

    def _dispatch_cohort(self, cohort, cohort_reqs, mesh, spec):
        """One cohort tick at ladder level ``spec``.  Returns the in-flight
        packed tensor, or None when this level serves the cohort on the
        host (the rand floor, or a capacity bucket over the level's
        limit)."""
        if spec["rand"] or (spec["cap_limit"] is not None and cohort.cap > spec["cap_limit"]):
            return None
        if (self.compile_plane is not None and spec["cand_scale"] == 1.0
                and not any(r.replay for r in cohort_reqs)
                and not all(r.study.canary for r in cohort_reqs)):
            # a canary-only tick never feeds the census bank
            self._census_note(cohort, cohort_reqs)
        chaos.io_point("tick", self.metrics)
        self.metrics.gauge("suggest.megakernel").set(1.0 if cohort.fused() else 0.0)
        demand = {}
        for r in cohort_reqs:
            slot = cohort.slot_of[r.study.study_id]
            demand[slot] = (np.asarray([int(i) & 0xFFFFFFFF for i in r.new_ids],
                                       np.uint32), r.seed)
        wave = next((r.wave for r in cohort_reqs if r.wave is not None), None)
        links = sorted({r.trace for r in cohort_reqs if r.trace})
        with _tracer.span("service.tick", wave=wave, cap=cohort.cap,
                          n_asks=len(cohort_reqs), ladder=spec["name"],
                          **({"links": links} if links else {})):
            return cohort.tick(demand, mesh=mesh, cand_scale=spec["cand_scale"])

    def _readback_cohort(self, cohort, cohort_reqs, packed):
        """Block on one cohort's tick and land every req's docs (a landing
        failure errors that req only).  Raises on a readback failure or
        non-finite proposals; the caller decides whether to retry down
        the ladder."""
        try:
            mat = packed.cpu().numpy()
        except BaseException:
            cohort.abandon_device()
            raise
        # chaos `corrupt@tick`: a seeded silent perturbation of the
        # read-back proposals (a no-op check when chaos is off)
        mat = chaos.corrupt_floats("tick", mat, self.metrics)
        live = [mat[cohort.slot_of[r.study.study_id], :len(r.new_ids)]
                for r in cohort_reqs if r.study.study_id in cohort.slot_of]
        if live and not all(np.isfinite(x).all() for x in live):
            cohort.abandon_device()
            raise NonFiniteProposal("cohort tick read back non-finite proposals")
        for r in cohort_reqs:
            try:
                m = mat[cohort.slot_of[r.study.study_id], :len(r.new_ids)]
                flats = rand.unpack_flats(cohort.cs, m, len(r.new_ids))
                docs = rand.flat_to_new_trial_docs(r.study.domain, r.study.trials,
                                                   r.new_ids, flats)
                if self.degrade is not None and self.degrade.degraded:
                    r.degraded = True
                self._finish_req(r, docs)
            except Exception as e:  # noqa: BLE001 - per-req isolation
                r.error = e
        self.metrics.counter("service.ticks").inc()
        self.metrics.counter("service.tick_asks").inc(len(cohort_reqs))

    def _serve_cohort_host_side(self, cohort_reqs):
        """Serve a cohort's reqs at the ladder's rand floor."""
        for r in cohort_reqs:
            try:
                self._finish_req(r, self._serve_rand_fallback(r))
            except Exception as e:  # noqa: BLE001
                r.error = e

    def _retry_cohort_down_ladder(self, cohort, cohort_reqs, mesh, exc):
        """A cohort tick faulted: while the fault is a device fault, step
        the ladder down and retry until the cohort serves (the rand floor
        always does).  Returns the faults absorbed; any other fault
        errors the reqs."""
        faults = 0
        while True:
            if self.degrade is None or not is_device_fault(exc):
                for r in cohort_reqs:
                    if r.docs is None and r.error is None:
                        r.error = exc
                return faults
            faults += 1
            self.degrade.record_fault()
            spec = self._ladder_spec()
            _tracer.event("service.degrade", level=spec["name"],
                          fault=f"{type(exc).__name__}: {exc}"[:200],
                          wave=next((r.wave for r in cohort_reqs if r.wave is not None), None),
                          links=sorted({r.trace for r in cohort_reqs if r.trace}))
            try:
                packed = self._dispatch_cohort(cohort, cohort_reqs, mesh, spec)
                if packed is None:
                    self._serve_cohort_host_side(cohort_reqs)
                else:
                    self._readback_cohort(cohort, cohort_reqs, packed)
                return faults
            except Exception as e:  # noqa: BLE001
                exc = e

    def _run_wave(self, reqs):
        """Serve queued asks: one tick per cohort, at most one ask per study
        per tick (a study asked twice waits for a follow-up round).  Every
        cohort's tick is launched before any is read back, so the host's
        doc building overlaps the device work of the cohorts behind it.
        Device faults walk the degrade ladder; the wave's wall time feeds
        the overload guard; served asks journal before they land and the
        WAL fsyncs once per wave, before any asker unblocks.  The wave's
        startup asks are served first (:meth:`_serve_startup`); a wave of
        startup asks alone is not a tick and takes no wave number.  A
        fenced scheduler refuses the whole wave before any journal append
        or landing: the seeds drawn stay in memory only, so the new
        owner's replayed stream never diverges."""
        if self.fence is not None and not self.fence():
            err = StaleOwnershipError("shard lease lost; wave refused")
            for r in reqs:
                if r.docs is None and r.error is None:
                    r.error = err
            return
        startup = [r for r in reqs if r.startup]
        if startup:
            self._serve_startup(startup)
            reqs = [r for r in reqs if not r.startup]
            if not reqs:
                return
        self._wave_seq += 1
        wave = self._wave_seq
        for r in reqs:
            r.wave = wave
        attrs = {"wave": wave, "n_reqs": len(reqs)}
        links = sorted({r.trace for r in reqs if r.trace})
        if links:
            attrs["links"] = links
        prof = self.profiler
        cap = prof.wave_begin() if prof is not None else None
        try:
            with _tracer.span("service.wave", **attrs):
                self._run_wave_inner(reqs)
        finally:
            if cap is not None:
                prof.wave_end(cap)

    def _charge_wave(self, cohort, cohort_reqs, device_sec):
        """Charge one cohort tick's measured dispatch+readback seconds to
        the cost ledger and the tenant ledger, by each ask's share of the
        tick's rows.  The history bytes follow the JAX package's float32
        formula (per label a float32 value plane and a bool active plane,
        plus the losses and has_loss planes, all ``[n_slots, cap]``),
        whatever the storage dtype.  Canary asks are never charged."""
        cohort_reqs = [r for r in cohort_reqs if not r.study.canary]
        if not cohort_reqs:
            return
        hbm = float(cohort.n_slots * cohort.cap * (len(cohort.cs.labels) * 5 + 5))
        if self.load is not None:
            entries = [(r.study.study_id, len(r.new_ids)) for r in cohort_reqs]
            cand = float(sum(k for _, k in entries) * cohort.cfg.get("n_EI_candidates", 24))
            self._plane_call("load observe_tick", self.load.observe_tick, entries, device_sec,
                             cand=cand, hbm_bytes=hbm, cohort=f"cap{cohort.cap}")
        if self.tenants is not None:
            self._plane_call("tenant observe_tick", self.tenants.observe_tick,
                             [(r.study.tenant, len(r.new_ids)) for r in cohort_reqs],
                             device_sec, hbm_bytes=hbm)

    def _run_wave_inner(self, reqs):
        t_wave = time.perf_counter()
        wave_faults = 0
        served_any = False
        self._check_store()
        self.evict_idle()
        # either attribution plane armed: time each cohort tick
        charge = self.load is not None or self.tenants is not None
        if self.tenants is not None and len(reqs) > 1:
            # weighted-fair packing: a stable reorder by deficit-round-
            # robin over tenants.  A study has one tenant, so the one-ask-
            # per-study round split below picks the same req per study;
            # per-id keys never depend on order, so proposals do not move
            try:
                rank = {t: i for i, t in enumerate(
                    self.tenants.drr_order([r.study.tenant for r in reqs]))}
                reqs = sorted(reqs, key=lambda r: rank.get(r.study.tenant, len(rank)))
            except Exception as e:  # noqa: BLE001 - packing is advisory
                log.warning("tenant drr_order failed (first-come order): %s", e)
        while reqs:
            this_round, leftover, seen = [], [], set()
            for r in reqs:
                (leftover if r.study.study_id in seen else this_round).append(r)
                seen.add(r.study.study_id)
            by_cohort = {}
            for r in this_round:
                try:
                    cohort = self._cohort_for(r.study)
                except Exception as e:  # noqa: BLE001 - per-req isolation
                    r.error = e
                    continue
                by_cohort.setdefault(id(cohort), (cohort, []))[1].append(r)
            launched = []
            for cohort, cohort_reqs in by_cohort.values():
                mesh = self._cohort_mesh(cohort)
                spec = self._ladder_spec()
                t_c = time.perf_counter() if charge else 0.0
                try:
                    packed = self._dispatch_cohort(cohort, cohort_reqs, mesh, spec)
                except Exception as e:  # noqa: BLE001
                    wave_faults += self._retry_cohort_down_ladder(cohort, cohort_reqs, mesh, e)
                    served_any = True
                    if charge:
                        self._charge_wave(cohort, cohort_reqs, time.perf_counter() - t_c)
                    continue
                if packed is None:  # the ladder's floor
                    self._serve_cohort_host_side(cohort_reqs)
                    served_any = True
                    if charge:
                        # no device time, but the asks and the wave count
                        self._charge_wave(cohort, cohort_reqs, 0.0)
                    continue
                dt_disp = time.perf_counter() - t_c if charge else 0.0
                launched.append((cohort, cohort_reqs, mesh, packed, dt_disp))
            for cohort, cohort_reqs, mesh, packed, dt_disp in launched:
                served_any = True
                t_c = time.perf_counter() if charge else 0.0
                try:
                    self._readback_cohort(cohort, cohort_reqs, packed)
                except Exception as e:  # noqa: BLE001
                    wave_faults += self._retry_cohort_down_ladder(cohort, cohort_reqs, mesh, e)
                if charge:
                    self._charge_wave(cohort, cohort_reqs,
                                      dt_disp + (time.perf_counter() - t_c))
            reqs = leftover
        if self.journal is not None:
            try:
                self.journal.sync()
                if self._store_full and self._store_full_src == "enospc":
                    self._exit_store_full()  # a durable write succeeded
            except JournalError as e:
                # the docs landed already: failing the answers now would
                # desync clients from served state
                log.warning("service: WAL sync failed after wave: %s", e)
                self.metrics.counter("service.wal.sync_errors").inc()
                if isinstance(e, StoreFullError):
                    self._enter_store_full(f"wave WAL sync: {e}")
        if self.degrade is not None and served_any and not wave_faults:
            self.degrade.record_clean_wave()
        dt = time.perf_counter() - t_wave
        self.metrics.histogram("service.wave_sec").observe(dt)
        if self.overload is not None:
            self.overload.observe_wave(dt)
        self._gc_cohorts()
        stats = tpe.cohort_cache_stats()
        self.metrics.gauge("suggest.cohort_cache.hits").set(stats["hits"])
        self.metrics.gauge("suggest.cohort_cache.misses").set(stats["misses"])
        self.metrics.gauge("service.slot_utilization").set(self.slot_utilization())

    def ask(self, study_id, n=1, deadline=None, req_id=None):
        """Propose ``n`` new trials for one study.  Concurrent callers
        coalesce: the first to reach a quiescent scheduler leads the wave
        and serves every queued ask in one tick per cohort.  ``deadline``
        (an :class:`~hyperopt_tpu_torch.service.overload.Deadline`) sheds
        the ask while it is still queued once expired; ``req_id`` makes the
        ask idempotent across client retries."""
        chaos.point("ask", self.metrics)
        t0 = time.perf_counter()
        if deadline is not None:
            deadline.check("ask")
        with self._cond:
            st = self._get(study_id)
            res = self._prepare_ask(st, n, deadline=deadline, req_id=req_id)
            if not isinstance(res, _AskReq):  # a retried ask's trials
                self.metrics.histogram("service.ask_sec").observe(time.perf_counter() - t0)
                return self._answers(st, res)
            req = res
            self._wave_reqs.append(req)
            while req.docs is None and req.error is None:
                if (req.deadline is not None and req.deadline.expired()
                        and req in self._wave_reqs):
                    # still queued: shed cleanly (nothing served or journaled)
                    self._wave_reqs.remove(req)
                    req.error = DeadlineExceeded(f"{study_id}: ask deadline expired while queued")
                    break
                if self._tick_running:
                    self._cond.wait(timeout=0.25)
                    continue
                self._tick_running = True
                if self.wave_window > 0:
                    # the gather window: concurrent askers join this wave
                    self._cond.wait(timeout=self.wave_window)
                batch, self._wave_reqs = self._wave_reqs, []
                try:
                    self._run_wave(batch)
                except Exception as e:  # noqa: BLE001
                    # never strand a wave: an unresolved req would spin its
                    # asker for ever
                    for r in batch:
                        if r.docs is None and r.error is None:
                            r.error = e
                finally:
                    self._tick_running = False
                    self._cond.notify_all()
            if req.error is not None:
                # release the quota and journal the burned draw inside the
                # lock, before a concurrent compaction could snapshot the
                # advanced stream
                req.study.n_asked -= len(req.new_ids)
                if isinstance(req.error, StoreFullError):
                    self._enter_store_full(f"wave WAL append: {req.error}")
                if not req.journaled and not isinstance(req.error, StaleOwnershipError):
                    # a fenced req never voids: its journal is dead to every
                    # later replay and the draw was in memory only
                    self._journal_void_ask(
                        req.study, req.new_ids, req.seed, trace=req.trace,
                        reason=("deadline_shed" if isinstance(req.error, DeadlineExceeded)
                                else None))
        if req.error is not None:
            raise req.error
        self.metrics.histogram("service.ask_sec").observe(time.perf_counter() - t0)
        return self._answers(req.study, req.docs, algo=req.algo, degraded=req.degraded,
                             wave=None if req.startup else req.wave)

    def ask_many(self, requests):
        """One explicit wave: ``[(study_id, n), ...]`` asked in one tick per
        cohort.  Returns ``{study_id: [answers]}``.  A study whose tick or
        landing failed is absent from the result (its pending quota
        released, its draw journaled void); only a wave in which every
        study failed raises."""
        with self._lock:
            out = {}
            reqs, startup, served = [], [], []

            def serve_startup():
                self._serve_startup(startup)
                served.extend(startup)
                startup.clear()

            try:
                for study_id, n in requests:
                    st = self._get(study_id)
                    if any(r.study is st for r in startup):
                        serve_startup()  # a study asked twice: its first ask lands first
                    res = self._prepare_ask(st, n)
                    if not isinstance(res, _AskReq):  # a retried ask's trials
                        out.setdefault(study_id, []).extend(self._answers(st, res))
                    else:
                        (startup if res.startup else reqs).append(res)
                serve_startup()
            except BaseException:
                # the asks drawn before the failing request are served, as
                # they would have been one at a time
                serve_startup()
                self._settle_failed(served)
                raise
            self._run_wave(reqs)
            failed = self._settle_failed(served + reqs)
            for r in served + reqs:
                if r.error is None:
                    out.setdefault(r.study.study_id, []).extend(
                        self._answers(r.study, r.docs, algo=r.algo, degraded=r.degraded,
                                      wave=None if r.startup else r.wave))
            if failed:
                if not out:
                    raise failed[0].error
                log.warning("ask_many: %d of %d asks failed this wave (first: %s: %s); "
                            "returning the successes", len(failed), len(served) + len(reqs),
                            type(failed[0].error).__name__, failed[0].error)
            return out

    def _settle_failed(self, reqs):
        """Release the pending quota of every failed req and journal its
        burned draw void (unless its ask record is in the WAL already);
        returns the failed reqs."""
        failed = [r for r in reqs if r.error is not None]
        for r in failed:
            r.study.n_asked -= len(r.new_ids)
            if not r.journaled and not isinstance(r.error, StaleOwnershipError):
                self._journal_void_ask(r.study, r.new_ids, r.seed, trace=r.trace)
        return failed

    def tell(self, study_id, tid, loss=None, status=None):
        """Report one trial's result: ok with a finite loss, fail otherwise.
        The WAL record appends (and fsyncs) before the state moves, so a
        tell is never acknowledged un-durably."""
        chaos.point("tell", self.metrics)
        with self._lock:
            st = self._get(study_id)
            if self.fence is not None and not self.fence():
                raise StaleOwnershipError(f"{study_id}: shard lease lost; tell refused")
            tid = int(tid)
            doc = next((d for d in st.trials._dynamic_trials if d["tid"] == tid), None)
            if doc is None and self.fence is not None \
                    and getattr(st.trials, "store", None) is not None:
                # fleet mode only: the doc may have landed in the shared
                # store a heartbeat before this owner's adoption scan, so
                # rescan once before answering 404 (a single server keeps
                # the cheap 404: no migration races it)
                st.trials.refresh()
                st.mark_best_dirty()
                doc = next((d for d in st.trials._dynamic_trials if d["tid"] == tid), None)
            if doc is None:
                raise UnknownStudyError(f"{study_id}: no trial with tid {tid}")
            if doc["state"] == JOB_STATE_DONE:
                raise DuplicateTellError(f"{study_id}: trial {tid} was already told")
            trace = reqtrace.current_trace_id()
            if self.journal is not None:
                try:
                    self.journal.append(StudyJournal.tell_rec(study_id, tid, loss, status,
                                                              trace=trace))
                    self.journal.sync()
                except StoreFullError as e:
                    # not applied (write-ahead): a typed, retryable 507
                    self._enter_store_full(f"tell WAL append: {e}")
                    raise
                if self._store_full and self._store_full_src == "enospc":
                    self._exit_store_full()
            st.note("tell", tid=tid, trace=trace)
            self._apply_tell(st, doc, loss, status)
            if st.state == "done":
                self._maybe_compact()

    def _apply_tell(self, st, doc, loss, status, replay=False):
        """Settle one told doc (the live path and WAL replay alike) and
        feed the planes: the quality plane and the tenant ledger fold
        replayed tells too (replay is their rebuild), the cost ledger only
        live ones (adopted heat comes from the heat ledger)."""
        ok = (loss is not None and math.isfinite(float(loss))
              and (status is None or status == STATUS_OK))
        doc["result"] = ({"loss": float(loss), "status": STATUS_OK} if ok
                         else {"status": STATUS_FAIL})
        doc["state"] = JOB_STATE_DONE
        doc["refresh_time"] = coarse_utcnow()
        store = getattr(st.trials, "store", None)
        if store is not None:
            store.settle(doc)
        _refresh(st)
        st.n_told += 1
        st.touch()
        ok_loss = float(loss) if ok else None
        st.record_result(ok_loss)
        self.metrics.counter("service.tells").inc()
        if not st.canary:  # probe traffic feeds no plane
            if self.quality is not None:
                self._plane_call("quality observe_tell", self.quality.observe_tell, st, ok_loss,
                                 replay=replay)
            if self.load is not None and not replay:
                self._plane_call("load observe_tell", self.load.observe_tell, st.study_id)
            if self.tenants is not None:
                self._plane_call("tenant observe_tell", self.tenants.observe_tell, st.tenant)
        if st.max_trials is not None and st.n_trials >= st.max_trials and st.n_pending == 0:
            st.state = "done"
            self._evict_from_cohort(st)

    # -- WAL resume / compaction / drain -----------------------------------

    def _space_from_admit(self, rec):
        """The ``hp`` space of an admit/snapshot record's spec
        (``{"space": <schema>}`` or ``{"zoo": <name>}``), or None."""
        spec = rec.get("spec")
        if not isinstance(spec, dict):
            return None
        if "zoo" in spec:
            from ..zoo import ZOO

            zrec = ZOO.get(str(spec["zoo"]))
            return zrec.space if zrec is not None else None
        if "space" in spec:
            from .spacespec import space_from_spec

            return space_from_spec(spec["space"])
        return None

    def resume(self, source=None):
        """Replay a WAL into this (fresh) scheduler: re-admit every
        journaled study, advance each seed stream draw for draw, re-land
        any doc the store does not hold (regenerated through the path
        that served it) and re-apply unsettled tells once.  Corrupt
        records quarantine their study.  Returns a stats dict (also
        ``last_resume``); None when no WAL is armed.  ``source`` replays
        another journal while this scheduler's own stays the append
        target."""
        journal = self.journal if source is None else source
        if journal is None:
            return None
        t0 = time.perf_counter()
        stats = {"studies": 0, "asks": 0, "regenerated": 0, "tells": 0,
                 "duplicate_tells": 0, "skipped": 0, "errors": 0,
                 "seed_mismatches": 0, "verified": 0, "unchecked": 0,
                 "torn": 0, "corrupt_records": 0, "corrupt_unattributed": 0,
                 "quarantined": 0, "quarantine_skipped": 0,
                 "snapshot_corrupt_recovered": 0, "reconciled_tells": 0}
        # which (sid, tid) tells this replay accounted, and the highest
        # void tid per study (ids a failed ask retired)
        self._replay_ctx = {"told": set(), "void_max": {}}
        corrupt = {}
        keep_raw = source is None and self.store_root is None
        healthy = [] if keep_raw else None
        with self._lock:
            for chk in journal.checked_records():
                if chk.status == integrity.TORN:
                    stats["torn"] += 1
                    continue
                if chk.status == integrity.CORRUPT:
                    stats["corrupt_records"] += 1
                    rec = chk.rec or {}
                    sid = rec.get("sid") or integrity.salvage_sid(chk.raw)
                    if sid is None:
                        stats["corrupt_unattributed"] += 1
                        log.warning("service: %s:%d: corrupt WAL record with no salvageable "
                                    "study id; record lost", journal.path, chk.lineno)
                        continue
                    if rec.get("kind") == "snapshot" and sid in self._studies \
                            and sid not in corrupt:
                        # the earlier chain rebuilt this study already
                        stats["snapshot_corrupt_recovered"] += 1
                        continue
                    corrupt.setdefault(sid, f"corrupt record at {journal.path}:{chk.lineno}")
                    continue
                stats["verified" if chk.status == integrity.OK else "unchecked"] += 1
                rec = chk.rec
                sid = rec.get("sid")
                if sid is not None and (sid in corrupt or sid in self._quarantined):
                    stats["quarantine_skipped"] += 1
                    continue
                try:
                    self._replay_record(rec, stats)
                except Exception as e:  # noqa: BLE001 - per-record isolation
                    stats["errors"] += 1
                    log.warning("service: WAL replay failed for %r: %s", rec, e)
                    continue
                if healthy is not None:
                    healthy.append(rec)
            for sid, reason in corrupt.items():
                self._quarantine_study(sid, reason)
                stats["quarantined"] += 1
            if corrupt:
                self._quarantine_wal_segment(journal, corrupt, healthy)
            # store-ahead reconciliation: a DONE doc whose tell record the
            # journal lost (a destroyed durable line) realigns the counter
            for st in self._studies.values():
                if getattr(st.trials, "store", None) is None \
                        or st.study_id in self._quarantined:
                    continue
                done = sum(1 for d in st.trials._dynamic_trials
                           if d["state"] == JOB_STATE_DONE)
                if done > st.n_told:
                    stats["reconciled_tells"] += done - st.n_told
                    log.warning("service: %s: %d acknowledged tell(s) missing from the "
                                "journal; reconciled from the store's DONE docs",
                                st.study_id, done - st.n_told)
                    st.n_told = done
                    if (st.max_trials is not None and st.n_trials >= st.max_trials
                            and st.n_pending == 0):
                        st.state = "done"
            for st in self._studies.values():
                st.note("resume", n_trials=st.n_trials, n_told=st.n_told)
            self.metrics.gauge("service.studies_live").set(
                sum(1 for s in self._studies.values() if s.state == "active"))
            for st in self._studies.values():
                # reclaim tid gaps left by asks that died un-journaled (per
                # trial keys derive from the id value), and set a counter a
                # killed process left empty back up; void ids stay retired
                store = getattr(st.trials, "store", None)
                if store is not None:
                    tids = [d["tid"] for d in st.trials._dynamic_trials]
                    nxt = max(max(tids, default=-1),
                              self._replay_ctx["void_max"].get(st.study_id, -1)) + 1
                    store.reset_counter(nxt)
            self._maybe_compact()
        del self._replay_ctx
        stats["replay_sec"] = time.perf_counter() - t0
        for key in ("studies", "asks", "regenerated", "tells", "duplicate_tells", "skipped",
                    "errors"):
            if stats[key]:
                self.metrics.counter(f"service.wal.replay_{key}").inc(stats[key])
        for key, name in (("verified", "service.integrity.verified"),
                          ("unchecked", "service.integrity.unchecked"),
                          ("torn", "service.integrity.torn"),
                          ("corrupt_records", "service.integrity.corrupt_records"),
                          ("corrupt_unattributed", "service.integrity.corrupt_unattributed"),
                          ("quarantine_skipped", "service.integrity.quarantine_skipped"),
                          ("snapshot_corrupt_recovered", "service.integrity.snapshot_recovered"),
                          ("reconciled_tells", "service.integrity.reconciled_tells")):
            if stats[key]:
                self.metrics.counter(name).inc(stats[key])
        self.metrics.gauge("service.wal.replay_sec").set(stats["replay_sec"])
        self.last_resume = stats
        if stats["studies"] or stats["errors"]:
            log.warning("service: WAL resume: %d studies, %d asks (%d regenerated), %d tells "
                        "(%d duplicates skipped), %d skipped, %d errors in %.3fs",
                        stats["studies"], stats["asks"], stats["regenerated"], stats["tells"],
                        stats["duplicate_tells"], stats["skipped"], stats["errors"],
                        stats["replay_sec"])
        return stats

    def _quarantine_wal_segment(self, journal, corrupt, healthy):
        """Keep the corrupt journal file as evidence (``*.quarantined``)
        and leave a clean live WAL: rebuilt from snapshots by compaction
        when a store exists, else by rewriting the verified records."""
        reasons = "; ".join(f"{sid}: {r}" for sid, r in sorted(corrupt.items()))
        journal.quarantine_segment(reasons)
        if journal is not self.journal or self.journal is None:
            return
        if self.store_root is None and healthy is not None:
            recs = list(healthy) + [
                StudyJournal.quarantine_rec(sid, info.get("reason", ""))
                for sid, info in sorted(self._quarantined.items())]
            try:
                self.journal.rewrite(recs, verify_old=False)
            except JournalError as e:
                log.warning("service: could not rewrite WAL after quarantine: %s", e)

    def _replay_record(self, rec, stats):
        kind = rec.get("kind")
        sid = rec.get("sid")
        if kind == "quarantine":
            self._quarantine_study(sid, rec.get("reason", "journaled"))
            return
        if kind in ("admit", "snapshot"):
            if sid in self._studies:
                return  # a duplicate admit (compaction raced a crash)
            space = self._space_from_admit(rec)
            if space is None:
                stats["skipped"] += 1
                log.warning("service: WAL study %s has no resumable space spec; skipping it",
                            sid)
                return
            self.create_study(space, seed=rec.get("seed", 0), study_id=sid,
                              space_spec=rec.get("spec"), _replay=True,
                              **(rec.get("kwargs") or {}))
            st = self._studies[sid]
            if kind == "snapshot":
                st.rstate.bit_generator.state = rec["rstate"]
                st.n_asked = int(rec.get("n_asked", 0))
                st.n_told = int(rec.get("n_told", 0))
                st.state = rec.get("state", "active")
                for rid, tids in (rec.get("served") or {}).items():
                    st.remember_req(rid, tids)
                if self.quality is not None and st.n_told and not st.canary:
                    # a compacted WAL holds no tell records for the settled
                    # history: fold the store's DONE docs in tid order (docs
                    # past the snapshot's n_told fold through their records)
                    done = [d for d in st.trials._dynamic_trials
                            if d["state"] == JOB_STATE_DONE][:st.n_told]
                    for d in done:
                        res = d.get("result") or {}
                        self._plane_call("quality snapshot fold", self.quality.observe_tell,
                                         st, res.get("loss") if res.get("status") == STATUS_OK
                                         else None, replay=True)
            stats["studies"] += 1
            return
        st = self._studies.get(sid)
        if st is None:
            stats["skipped"] += 1
            return
        if kind == "ask":
            drawn = st.next_seed()  # the live draw, replayed exactly
            seed = int(rec.get("seed", drawn))
            if drawn != seed:
                # trust the record (it produced the served docs)
                stats["seed_mismatches"] += 1
            tids = [int(t) for t in rec.get("tids") or []]
            if rec.get("algo") == "void" or not tids:
                if tids:
                    st.trials._ids.update(tids)
                    self._replay_ctx["void_max"][sid] = max(
                        max(tids), self._replay_ctx["void_max"].get(sid, -1))
                return
            st.n_asked += len(tids)
            st.remember_req(rec.get("req"), tids)
            existing = {d["tid"] for d in st.trials._dynamic_trials}
            if all(t in existing for t in tids):
                stats["asks"] += 1
                return  # the store holds this ask's docs
            # in flight at the crash: regenerate through the journaled algo
            # (the JAX package's compile plane journals its warming asks as
            # "rand", and they replay through rand.suggest here too)
            if rec.get("algo") == "rand":
                docs = rand.suggest(tids, st.domain, st.trials, seed)
                self._land(st, docs)
                st.note("ask", tids=tids, algo="rand", replay=True, trace=rec.get("trace"))
            else:
                req = _AskReq(st, tids, seed, replay=True, trace=rec.get("trace"))
                self._run_wave([req])
                if req.error is not None:
                    raise req.error
            stats["asks"] += 1
            stats["regenerated"] += 1
        elif kind == "tell":
            tid = int(rec["tid"])
            key = (sid, tid)
            doc = next((d for d in st.trials._dynamic_trials if d["tid"] == tid), None)
            if doc is None:
                stats["skipped"] += 1
            elif key in self._replay_ctx["told"]:
                stats["duplicate_tells"] += 1  # the same tell twice: once only
            elif doc["state"] == JOB_STATE_DONE:
                # store-ahead: settled before the crash; replay only the
                # scheduler's bookkeeping
                self._replay_ctx["told"].add(key)
                st.n_told += 1
                st.note("tell", tid=tid, replay=True, trace=rec.get("trace"))
                stats["tells"] += 1
                res = doc.get("result") or {}
                ok_loss = res.get("loss") if res.get("status") == STATUS_OK else None
                st.record_result(ok_loss)
                # the tell-time bookkeeping still folds it: once per told
                # trial on both replay branches
                if self.quality is not None and not st.canary:
                    self._plane_call("quality observe_tell", self.quality.observe_tell, st,
                                     ok_loss, replay=True)
                if self.tenants is not None and not st.canary:
                    self._plane_call("tenant observe_tell", self.tenants.observe_tell,
                                     st.tenant)
                if (st.max_trials is not None and st.n_trials >= st.max_trials
                        and st.n_pending == 0):
                    st.state = "done"
            else:
                self._replay_ctx["told"].add(key)
                st.note("tell", tid=tid, replay=True, trace=rec.get("trace"))
                self._apply_tell(st, doc, rec.get("loss"), rec.get("status"), replay=True)
                stats["tells"] += 1
        elif kind == "close":
            st.state = "closed"
            self._evict_from_cohort(st)
        # unknown kinds: forward compatibility, ignored

    def _maybe_compact(self):
        """Compact the WAL to one snapshot record per live study (plus the
        quarantine markers): only with a store (without one the ask
        records are the trial data) and only when no wave is in flight."""
        if self.journal is None or self.store_root is None:
            return False
        if self._tick_running or self._wave_reqs:
            return False
        recs = [StudyJournal.snapshot_rec(s) for s in self._studies.values()
                if s.state == "active"]
        recs += [StudyJournal.quarantine_rec(sid, info.get("reason", ""))
                 for sid, info in sorted(self._quarantined.items())]
        try:
            self.journal.rewrite(recs)
        except JournalError as e:
            log.warning("service: WAL compaction failed: %s", e)
            self.metrics.counter("service.wal.compact_errors").inc()
            return False
        self.metrics.counter("service.wal.compactions").inc()
        return True

    def drain(self, timeout=30.0):
        """Stop admitting (new studies and asks answer 503; tells still
        land), wait for in-flight waves, then compact and close the WAL.
        Returns True when the scheduler quiesced within ``timeout``."""
        with self._cond:
            self.set_profiler(None)  # a capture waiting for a wave goes back
            self._draining = True
            deadline = time.monotonic() + float(timeout)
            while self._tick_running or self._wave_reqs:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(timeout=min(0.25, left))
            quiesced = not (self._tick_running or self._wave_reqs)
            if self.journal is not None:
                if quiesced:
                    self._maybe_compact()
                try:
                    self.journal.close()
                except JournalError:
                    pass
        return quiesced

    # -- status ------------------------------------------------------------

    def study_status(self, study_id):
        with self._lock:
            return self._get(study_id).status_dict()

    def study_timeline(self, study_id):
        """The ``GET /study/<id>/timeline`` payload (a quarantined study
        stays inspectable)."""
        with self._lock:
            st = self._studies.get(study_id)
            if st is not None:
                return st.timeline_dict()
            return self._get(study_id).timeline_dict()

    def studies_status(self):
        """The ``GET /studies`` payload: per-study status (with its quality
        and cost sections), the cohort roll-up and the tenant table."""
        with self._lock:
            cohorts = [{"space_sig": repr(key[0])[:64], "cap": c.cap, "n_slots": c.n_slots,
                        "n_live": c.n_live, "ticks": c.ticks}
                       for key, c in self._cohorts.items()]
            studies = [s.status_dict() for s in self._studies.values()]
            for plane, key in ((self.quality, "quality"), (self.load, "load")):
                if plane is not None:
                    for s in studies:
                        sec = plane.study_status(s.get("study_id"))
                        if sec is not None:
                            s[key] = sec
            for sid, info in sorted(self._quarantined.items()):
                if sid not in self._studies:
                    studies.append({"study_id": sid, "state": "quarantined",
                                    "quarantine_reason": info.get("reason")})
            out = {
                "ts": time.time(),
                "n_studies": len(self._studies),
                "slot_utilization": self.slot_utilization(),
                "cohort_cache": tpe.cohort_cache_stats(),
                "cohorts": cohorts,
                "studies": studies,
                "draining": self._draining,
            }
            if self.tenants is not None:
                out["tenants"] = self.tenants.status()
            if self._quarantined:
                out["quarantined"] = {sid: info.get("reason")
                                      for sid, info in sorted(self._quarantined.items())}
            out["store"] = self.store_health()
            if self.degrade is not None:
                out["degrade"] = self.degrade.status()
            if self.compile_plane is not None:
                comp = self.compile_plane.publish()
                comp["warming_studies"] = 0
                comp["widen"] = self.widen
                out["compile"] = comp
            if self.journal is not None:
                out["wal"] = {
                    "path": self.journal.path,
                    "appends": self.journal.appends,
                    "compactions": self.journal.compactions,
                    "size_bytes": self.journal.size_bytes(),
                    "last_resume": self.last_resume,
                }
            return out
