"""The study scheduler: pack live studies into cohort slots and tick once
per ask wave (counterpart of the in-memory core of
``hyperopt_tpu/service/scheduler.py``).

Studies sharing a search space, a TPE cfg and a capacity bucket land in
one **cohort**: a fixed-shape ``[S, cap]`` stack of device history slots.
Every ask wave runs one study-batched tell+ask program
(``tpe.build_suggest_batched``) per cohort instead of one tick per study.
For a space ``megakernel.supports``, that program draws and scores its
candidates in the fused CUDA kernel.  With ``widen`` on, a cohort of an
unconditional space (``tpe.widened_profile`` is not None) never takes the
fused route, as in the JAX package, and scores in grouped ``ei_diff``.
The JAX package's positional slot layout, which lets every space of one
widened profile share a compiled program, has nothing to share here: the
grouped cohort already proposes as a widened slot does, bit for bit.

Determinism: a cohort of N studies proposes as N independent sequential
``fmin`` runs at the same per-study seeds would.  Each study's ask mirrors
``FMinIter``'s loop (ids from the study's trials, one seed per ask from
its ``rstate``, random search below ``n_startup_jobs``, the TPE cfg built
as ``tpe.suggest_async`` builds it), and per-id keys derive from the id
and the study seed, never from slot position or wave composition.  The
per-study host ``PaddedHistory`` arrays are authoritative; the cohort's
device stack mirrors them and an evicted study re-admits by re-upload.

Not ported yet: the write-ahead journal, the store and resume, the
compile plane, the overload guard and degrade ladder, quarantine, the
prober's canary studies and the HTTP server (ROADMAP.md, queue 1, item
13), and the quality, cost and tenant planes (item 14).  Their options
raise.
"""

from __future__ import annotations

import math
import threading
import time
import uuid

import numpy as np
import torch

from .. import quant
from .._env import (not_ported, parse_compile_widen, parse_hist_dtype,
                    parse_service_idle_sec, parse_service_max_pending,
                    parse_service_max_studies, parse_shard, refuse_armed_knobs,
                    resolve_device)
from ..algos import rand, tpe
from ..base import (JOB_STATE_DONE, STATUS_FAIL, STATUS_OK, Domain, Trials,
                    coarse_utcnow, spec_from_misc)

__all__ = ["StudyScheduler", "Study", "StudyQuotaError", "UnknownStudyError",
           "DuplicateTellError"]


class UnknownStudyError(KeyError):
    """No live study with that id (never created, or closed)."""


class StudyQuotaError(RuntimeError):
    """An admission or per-study quota would be exceeded."""


class DuplicateTellError(RuntimeError):
    """The trial was already told."""


def _pow2(n):
    b = 1
    while b < n:
        b *= 2
    return b


class Study:
    """One study's serving state: compiled space, trials, RNG stream and
    quotas.  The ask/tell flow over these fields reproduces ``FMinIter``'s
    loop."""

    def __init__(self, study_id, space, seed=0, n_startup_jobs=None,
                 max_trials=None, trials=None, **tpe_kwargs):
        self.study_id = study_id
        self.domain = Domain(None, space)
        self.trials = trials if trials is not None else Trials()
        self.rstate = np.random.default_rng(seed)
        self.seed = int(seed)
        self.n_startup_jobs = int(n_startup_jobs if n_startup_jobs is not None
                                  else tpe._default_n_startup_jobs)
        self.max_trials = None if max_trials is None else int(max_trials)
        # tpe.suggest_async's cfg, field for field
        self.cfg = {
            "prior_weight": float(tpe_kwargs.pop("prior_weight", tpe._default_prior_weight)),
            "n_EI_candidates": int(tpe_kwargs.pop("n_EI_candidates",
                                                  tpe._default_n_EI_candidates)),
            "gamma": float(tpe_kwargs.pop("gamma", tpe._default_gamma)),
            "LF": int(tpe_kwargs.pop("linear_forgetting", tpe._default_linear_forgetting)),
            "ei_select": str(tpe_kwargs.pop("ei_select", "argmax")),
            "ei_tau": float(tpe_kwargs.pop("ei_tau", 1.0)),
            "prior_eps": float(tpe_kwargs.pop("prior_eps", 0.0)),
        }
        if tpe_kwargs:
            raise TypeError(f"unknown study kwargs: {sorted(tpe_kwargs)}")
        self.cfg_key = tuple(sorted(self.cfg.items()))
        self.state = "active"
        self.created = time.time()
        self.last_active = self.created
        self.n_asked = 0
        self.n_told = 0
        self._best = None
        self._best_dirty = True

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

    def record_result(self, loss):
        if loss is None or self._best_dirty:
            return
        if self._best is None or loss < self._best:
            self._best = float(loss)

    def status_dict(self):
        return {
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
        }


class _AskReq:
    """One TPE ask waiting for a cohort tick."""

    __slots__ = ("study", "new_ids", "seed", "docs", "error", "wave")

    def __init__(self, study, new_ids, seed):
        self.study = study
        self.new_ids = new_ids
        self.seed = seed
        self.docs = None
        self.error = None
        self.wave = None


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

    @property
    def n_slots(self):
        return len(self.slots)

    @property
    def n_live(self):
        return len(self.slot_of)

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

    def tick(self, demand, mesh=None):
        """One study-batched tell+ask launch sequence for the whole cohort.

        ``demand``: ``{slot: (ids uint32, seed)}``, at most one ask per slot.
        Every occupied slot's pending tell rows fold, asking or not.
        Returns the packed ``[S, B, L]`` device tensor, still in flight: the
        caller reads it back after every cohort of the wave has launched.
        ``mesh`` splits the slots over its entries
        (``build_suggest_batched(mesh=...)``); the stack is then placed
        on it, and re-placed when the mesh changes."""
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

        run = tpe.build_suggest_batched(self.cs, self.cfg, S, self.cap, B, mesh=mesh,
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

    Thread-safe: calls serialize on the scheduler's lock.  A wave of asks
    over many studies is one :meth:`ask_many` call, served by one tick per
    cohort.  (The reference's gather window, which coalesces concurrent
    :meth:`ask` calls for its HTTP front end, comes with that front end.)

    ``device`` is where the cohorts' histories live and tick: the CUDA
    card unless ``device="cpu"`` (without a card the default raises).
    ``hist_dtype`` names their storage (``HYPEROPT_TPU_HIST_DTYPE`` by
    default): float32, bfloat16, or int8/fp8 codes with bf16 losses.
    ``widen`` (``HYPEROPT_TPU_COMPILE_WIDEN`` by default, read once here)
    widens the cohorts of unconditional spaces: they keep off the fused
    route."""

    def __init__(self, max_studies=None, max_pending=None, idle_sec=None,
                 device=None, hist_dtype=None, store_root=None,
                 wal=None, degrade=None, overload=None, compile_plane=None,
                 widen=None, quality=None, load=None, tenants=None):
        for what, value, item in (("store_root=", store_root, 13), ("wal=", wal, 13),
                                  ("degrade=", degrade, 13), ("overload=", overload, 13),
                                  ("compile_plane=", compile_plane, 13),
                                  ("quality=", quality, 14),
                                  ("load=", load, 14), ("tenants=", tenants, 14)):
            if value is not None and value is not False:
                raise not_ported(f"StudyScheduler({what}...)", item)
        refuse_armed_knobs("StudyScheduler")
        self.device = resolve_device(device)
        self.hist_dtype = str(hist_dtype) if hist_dtype else parse_hist_dtype()
        quant.vals_dtype(self.hist_dtype)  # an unknown name raises here
        self.max_studies = (parse_service_max_studies() if max_studies is None
                            else int(max_studies))
        self.max_pending = (parse_service_max_pending() if max_pending is None
                            else int(max_pending))
        self.idle_sec = parse_service_idle_sec() if idle_sec is None else float(idle_sec)
        self.widen = parse_compile_widen() if widen is None else bool(widen)
        if self.idle_sec <= 0:
            self.idle_sec = math.inf  # 0 means never evict on idleness
        self._lock = threading.RLock()
        self._studies = {}
        self._cohorts = {}  # (signature, cfg_key, cap) -> _Cohort
        self._wave_seq = 0

    # -- study lifecycle ---------------------------------------------------

    def create_study(self, space, seed=0, study_id=None, **kwargs):
        """Admit a new study and return its id.  ``kwargs`` are
        ``n_startup_jobs``, ``max_trials`` and ``tpe.suggest``'s tuning
        arguments.  Raises :class:`StudyQuotaError` past ``max_studies``."""
        for what, item in (("space_spec", 13), ("canary", 13), ("tenant", 14)):
            if kwargs.pop(what, None) is not None:
                raise not_ported(f"create_study({what}=...)", item)
        with self._lock:
            live = sum(1 for s in self._studies.values() if s.state == "active")
            if live >= self.max_studies:
                raise StudyQuotaError(f"study quota reached ({self.max_studies} live studies)")
            study_id = study_id or f"study-{uuid.uuid4().hex[:12]}"
            if study_id in self._studies:
                raise StudyQuotaError(f"study id {study_id!r} already exists")
            trials = Trials(device=self.device, hist_dtype=self.hist_dtype)
            self._studies[study_id] = Study(study_id, space, seed=seed, trials=trials,
                                            **kwargs)
            return study_id

    def close_study(self, study_id):
        """Mark a study closed and free its cohort slot (its trials stay
        readable; the quota counts active studies only)."""
        with self._lock:
            st = self._get(study_id)
            st.state = "closed"
            self._evict_from_cohort(st)
            self._gc_cohorts()

    def _get(self, study_id):
        st = self._studies.get(study_id)
        if st is None:
            raise UnknownStudyError(study_id)
        return st

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
        return cohort

    def _evict_from_cohort(self, st):
        for cohort in self._cohorts.values():
            cohort.evict(st.study_id)

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
        for key in [k for k, c in self._cohorts.items() if c.n_live == 0]:
            del self._cohorts[key]

    # -- ask / tell --------------------------------------------------------

    def _prepare_ask(self, st, n):
        """Draw ids and a seed for one ask as ``FMinIter`` would.  Returns
        the docs of a startup (random search) ask, served at once, or an
        :class:`_AskReq` for a cohort tick."""
        if st.state != "active":
            raise UnknownStudyError(f"{st.study_id} is {st.state}")
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
        st.trials.refresh()
        seed = st.next_seed()
        st.touch()
        st.n_asked += n
        if len(st.trials.trials) < st.n_startup_jobs:
            try:
                docs = rand.suggest(new_ids, st.domain, st.trials, seed)
                self._land(st, docs)
            except BaseException:
                st.n_asked -= n
                raise
            return docs
        return _AskReq(st, new_ids, seed)

    def _land(self, st, docs):
        st.trials.insert_trial_docs(docs)
        st.trials.refresh()

    def _answers(self, st, docs, wave=None):
        out = [{"study_id": st.study_id, "tid": d["tid"],
                "params": spec_from_misc(d["misc"])} for d in docs]
        if wave is not None:
            for a in out:
                a["wave"] = int(wave)
        return out

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

    def _dispatch_cohort(self, cohort, cohort_reqs):
        demand = {}
        for r in cohort_reqs:
            slot = cohort.slot_of[r.study.study_id]
            demand[slot] = (np.asarray([int(i) & 0xFFFFFFFF for i in r.new_ids],
                                       np.uint32), r.seed)
        return cohort.tick(demand, mesh=self._cohort_mesh(cohort))

    def _readback_cohort(self, cohort, cohort_reqs, packed):
        """Block on one cohort's proposals and land every req's docs
        (a landing failure errors that req only)."""
        try:
            mat = packed.cpu().numpy()
        except BaseException:
            cohort.abandon_device()
            raise
        live = [mat[cohort.slot_of[r.study.study_id], :len(r.new_ids)] for r in cohort_reqs]
        if not all(np.isfinite(x).all() for x in live):
            cohort.abandon_device()
            raise FloatingPointError("cohort tick read back non-finite proposals")
        for r, m in zip(cohort_reqs, live):
            try:
                flats = rand.unpack_flats(cohort.cs, m, len(r.new_ids))
                docs = rand.flat_to_new_trial_docs(r.study.domain, r.study.trials,
                                                   r.new_ids, flats)
                self._land(r.study, docs)
                r.docs = docs
            except Exception as e:  # noqa: BLE001 - per-req isolation
                r.error = e

    def _run_wave(self, reqs):
        """Serve queued asks: one tick per cohort, at most one ask per study
        per tick (a study asked twice waits for a follow-up round).  Every
        cohort's tick is launched before any is read back, so the host's
        doc building overlaps the device work of the cohorts behind it.  A
        failing cohort errors its own reqs only."""
        self._wave_seq += 1
        for r in reqs:
            r.wave = self._wave_seq
        self.evict_idle()
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
                try:
                    launched.append((cohort, cohort_reqs,
                                     self._dispatch_cohort(cohort, cohort_reqs)))
                except Exception as e:  # noqa: BLE001
                    for r in cohort_reqs:
                        r.error = e
            for cohort, cohort_reqs, packed in launched:
                try:
                    self._readback_cohort(cohort, cohort_reqs, packed)
                except Exception as e:  # noqa: BLE001
                    for r in cohort_reqs:
                        if r.docs is None and r.error is None:
                            r.error = e
            reqs = leftover
        self._gc_cohorts()

    def ask(self, study_id, n=1):
        """Propose ``n`` new trials for one study: a wave of one ask."""
        with self._lock:
            st = self._get(study_id)
            res = self._prepare_ask(st, n)
            if not isinstance(res, _AskReq):
                return self._answers(st, res)
            self._run_wave([res])
            if res.error is not None:
                st.n_asked -= len(res.new_ids)
                raise res.error
            return self._answers(st, res.docs, wave=res.wave)

    def ask_many(self, requests):
        """One explicit wave: ``[(study_id, n), ...]`` asked in one tick per
        cohort.  Returns ``{study_id: [answers]}``.  A study whose tick or
        landing failed is absent from the result (its pending quota
        released); only a wave in which every study failed raises."""
        with self._lock:
            out = {}
            reqs = []
            for study_id, n in requests:
                st = self._get(study_id)
                res = self._prepare_ask(st, n)
                if isinstance(res, _AskReq):
                    reqs.append(res)
                else:
                    out.setdefault(study_id, []).extend(self._answers(st, res))
            self._run_wave(reqs)
            failed = []
            for r in reqs:
                if r.error is not None:
                    r.study.n_asked -= len(r.new_ids)
                    failed.append(r)
                else:
                    out.setdefault(r.study.study_id, []).extend(
                        self._answers(r.study, r.docs, wave=r.wave))
            if failed and not out:
                raise failed[0].error
            return out

    def tell(self, study_id, tid, loss=None, status=None):
        """Report one trial's result: ok with a finite loss, fail otherwise.
        The doc settles DONE and folds into the study's history at its next
        ask."""
        with self._lock:
            st = self._get(study_id)
            tid = int(tid)
            doc = next((d for d in st.trials._dynamic_trials if d["tid"] == tid), None)
            if doc is None:
                raise UnknownStudyError(f"{study_id}: no trial with tid {tid}")
            if doc["state"] == JOB_STATE_DONE:
                raise DuplicateTellError(f"{study_id}: trial {tid} was already told")
            ok = (loss is not None and math.isfinite(float(loss))
                  and (status is None or status == STATUS_OK))
            doc["result"] = ({"loss": float(loss), "status": STATUS_OK} if ok
                             else {"status": STATUS_FAIL})
            doc["state"] = JOB_STATE_DONE
            doc["refresh_time"] = coarse_utcnow()
            st.trials.refresh()
            st.n_told += 1
            st.touch()
            st.record_result(float(loss) if ok else None)
            if (st.max_trials is not None and st.n_trials >= st.max_trials
                    and st.n_pending == 0):
                st.state = "done"
                self._evict_from_cohort(st)

    def study_status(self, study_id):
        with self._lock:
            return self._get(study_id).status_dict()
