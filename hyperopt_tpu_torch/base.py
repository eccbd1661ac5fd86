"""Core runtime: trial documents, the trial store, Domain, Ctrl, and the
padded history (counterpart of ``hyperopt_tpu/base.py``).

``Trials`` keeps the reference's list-of-documents API and folds finished
trials into a ``PaddedHistory``: per label ``vals[f32, cap]`` and
``active[bool, cap]`` plus ``losses``/``has_loss``, with power-of-two
capacity buckets.  The numpy arrays are the source of truth; the device
mirror is a dict of torch tensors on the trials' device that each TPE tick
updates in place (``index_put_``) with the rows finished since the last
tick.  ``HYPEROPT_TPU_HIST_DTYPE`` picks the mirror's storage: float32,
bf16, or int8/fp8 codes of ``quant.py`` with bf16 losses.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import numbers

import numpy as np
import torch

from . import quant
from ._env import parse_hist_dtype, resolve_device
from .exceptions import (
    AllTrialsFailed,
    InvalidLoss,
    InvalidResultStatus,
    InvalidTrial,
    StaleHistoryError,
)
from .spaces import CompiledSpace, as_expr, compile_space
from .obs.devmem import register_owner
from .utils import coarse_utcnow, evaluation_device

__all__ = [
    "JOB_STATE_NEW",
    "JOB_STATE_RUNNING",
    "JOB_STATE_DONE",
    "JOB_STATE_ERROR",
    "JOB_STATE_CANCEL",
    "JOB_STATES",
    "STATUS_NEW",
    "STATUS_RUNNING",
    "STATUS_SUSPENDED",
    "STATUS_OK",
    "STATUS_FAIL",
    "STATUS_STRINGS",
    "SONify",
    "miscs_update_idxs_vals",
    "miscs_to_idxs_vals",
    "spec_from_misc",
    "Trials",
    "trials_from_docs",
    "trials_from_flat_history",
    "Ctrl",
    "Domain",
    "PaddedHistory",
    "coarse_utcnow",
]

JOB_STATE_NEW = 0
JOB_STATE_RUNNING = 1
JOB_STATE_DONE = 2
JOB_STATE_ERROR = 3
JOB_STATE_CANCEL = 4
JOB_STATES = [JOB_STATE_NEW, JOB_STATE_RUNNING, JOB_STATE_DONE, JOB_STATE_ERROR, JOB_STATE_CANCEL]

STATUS_NEW = "new"
STATUS_RUNNING = "running"
STATUS_SUSPENDED = "suspended"
STATUS_OK = "ok"
STATUS_FAIL = "fail"
STATUS_STRINGS = (STATUS_NEW, STATUS_RUNNING, STATUS_SUSPENDED, STATUS_OK, STATUS_FAIL)

# Smallest padded-history capacity bucket (the JAX package's _MIN_CAP).
_MIN_CAP = 128


def SONify(arg):
    """Coerce to JSON/BSON-safe python types (hyperopt/base.py sym: SONify);
    numpy arrays and torch tensors become nested lists."""
    if isinstance(arg, dict):
        return {SONify(k): SONify(v) for k, v in arg.items()}
    if isinstance(arg, (list, tuple)):
        return [SONify(a) for a in arg]
    if isinstance(arg, torch.Tensor):
        return SONify(arg.detach().cpu().numpy().tolist())
    if isinstance(arg, np.ndarray):
        return SONify(arg.tolist())
    if isinstance(arg, (np.bool_, bool)):
        return bool(arg)
    if isinstance(arg, numbers.Integral):
        return int(arg)
    if isinstance(arg, numbers.Real):
        return float(arg)
    if isinstance(arg, (str, bytes, type(None), datetime.datetime)):
        return arg
    raise TypeError(f"cannot SONify {type(arg)}: {arg!r}")


def miscs_update_idxs_vals(miscs, idxs, vals, assert_all_vals_used=True, idxs_map=None):
    """Write per-label sparse (idxs, vals) into trial misc documents."""
    if idxs_map is None:
        idxs_map = {}
    misc_by_id = {m["tid"]: m for m in miscs}
    for m in miscs:
        m.setdefault("idxs", {})
        m.setdefault("vals", {})
        for label in idxs:
            m["idxs"].setdefault(label, [])
            m["vals"].setdefault(label, [])
    for label in idxs:
        for tid, val in zip(idxs[label], vals[label]):
            tid = idxs_map.get(tid, tid)
            if tid in misc_by_id:
                misc_by_id[tid]["idxs"][label] = [tid]
                misc_by_id[tid]["vals"][label] = [val]
            elif assert_all_vals_used:
                raise InvalidTrial(f"no misc with tid {tid}")
    return miscs


def miscs_to_idxs_vals(miscs, keys=None):
    """Gather per-label sparse (idxs, vals) from trial misc documents."""
    if keys is None:
        if len(miscs) == 0:
            raise ValueError("cannot infer keys from empty miscs")
        keys = list(miscs[0]["idxs"].keys())
    idxs = {k: [] for k in keys}
    vals = {k: [] for k in keys}
    for m in miscs:
        for k in keys:
            t = m["idxs"].get(k, [])
            v = m["vals"].get(k, [])
            if len(t) != len(v):
                raise InvalidTrial(f"idxs/vals length mismatch for {k!r}")
            idxs[k].extend(t)
            vals[k].extend(v)
    return idxs, vals


def spec_from_misc(misc):
    """Flat ``{label: value}`` config from one misc; inactive conditional
    params are absent."""
    spec = {}
    for k, v in misc["vals"].items():
        if len(v) == 0:
            continue
        if len(v) == 1:
            spec[k] = v[0]
        else:
            raise InvalidTrial(f"multiple values for {k} in one trial")
    return spec


def _validate_trial_doc(doc):
    required = ("tid", "spec", "result", "misc", "state", "exp_key", "owner", "version")
    for k in required:
        if k not in doc:
            raise InvalidTrial(f"trial document missing key {k!r}: {sorted(doc)}")
    if doc["state"] not in JOB_STATES:
        raise InvalidTrial(f"invalid state {doc['state']!r}")
    misc = doc["misc"]
    for k in ("tid", "cmd", "idxs", "vals"):
        if k not in misc:
            raise InvalidTrial(f"trial misc missing key {k!r}")
    if misc["tid"] != doc["tid"]:
        raise InvalidTrial(f"tid mismatch: {misc['tid']} != {doc['tid']}")
    return doc


def _bucket_cap(n: int) -> int:
    """Smallest power-of-two bucket ≥ n (min _MIN_CAP)."""
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


class PaddedHistory:
    """Dense, padded structure-of-arrays view of trial history.

    Per label ``vals[cap]``/``active[cap]``, plus ``losses[cap]`` (``+inf``
    in padding) and ``has_loss[cap]``; ``n`` rows are live.  The numpy
    arrays are authoritative (appends, pickling); :meth:`device_state`
    hands a tick the device mirror plus the packed rows it has not folded
    yet, and the tick folds them in place (``tpe._apply_rows``) before
    :meth:`commit_device` marks them synced.
    """

    # pending rows fold in one vectorized scatter per array; past this
    # many the mirror is re-uploaded instead
    _MAX_FOLD_ROWS = 16

    def __init__(self, labels, device=None, hist_dtype=None):
        self.labels = tuple(labels)
        self.device = resolve_device(device)
        # the mirror's storage name (HYPEROPT_TPU_HIST_DTYPE by default);
        # int8/fp8 store codes only once ensure_qparams arms them, bf16
        # until then
        self.hist_dtype = str(hist_dtype) if hist_dtype else parse_hist_dtype()
        self.qparams = None  # {label: (scale, zero, islog)} once armed
        self.n = 0
        self.cap = _MIN_CAP
        self._vals = {l: np.zeros(self.cap, np.float32) for l in self.labels}
        self._active = {l: np.zeros(self.cap, bool) for l in self.labels}
        self._losses = np.full(self.cap, np.inf, np.float32)
        self._has_loss = np.zeros(self.cap, bool)
        self._dev = None
        self._dev_synced = 0
        self._pending = None  # row count handed to a tick not yet committed

    def _grow(self, need):
        new_cap = _bucket_cap(need)
        if new_cap <= self.cap:
            return
        pad = new_cap - self.cap
        for l in self.labels:
            self._vals[l] = np.concatenate([self._vals[l], np.zeros(pad, np.float32)])
            self._active[l] = np.concatenate([self._active[l], np.zeros(pad, bool)])
        self._losses = np.concatenate([self._losses, np.full(pad, np.inf, np.float32)])
        self._has_loss = np.concatenate([self._has_loss, np.zeros(pad, bool)])
        self.cap = new_cap
        self._dev = None  # shapes changed: full re-upload at next use

    def append(self, flat_vals: dict, loss):
        """Record one finished trial (flat {label: value}; absent =
        inactive).  Under armed qparams the stored value is the snapped
        grid point the device mirror decodes (``quant.snap_np``)."""
        self._grow(self.n + 1)
        i = self.n
        for l in self.labels:
            if l in flat_vals and flat_vals[l] is not None:
                v = float(flat_vals[l])
                if self.qparams is not None:
                    v = float(quant.snap_np(v, self.qparams[l], self.hist_dtype))
                self._vals[l][i] = v
                self._active[l][i] = True
        if loss is not None and math.isfinite(float(loss)):
            self._losses[i] = float(loss)
            self._has_loss[i] = True
        self.n += 1

    def _pack_row(self, i):
        L = len(self.labels)
        row = np.empty(2 * L + 3, np.float32)
        for j, l in enumerate(self.labels):
            row[j] = self._vals[l][i]
            row[L + j] = 1.0 if self._active[l][i] else 0.0
        row[2 * L] = self._losses[i]
        row[2 * L + 1] = 1.0 if self._has_loss[i] else 0.0
        row[2 * L + 2] = float(i)  # cap ≤ 2^24: exact in f32
        return row

    def pack_rows(self, start, K=None, noop_index=None):
        """float32 rows for trials ``start..n`` in the ``_pack_row`` layout:
        ``[n - start, 2L+3]``, or with ``K`` padded to ``K`` rows whose
        index is ``noop_index`` (default ``cap``), a slot past the end that
        the folds drop."""
        L = len(self.labels)
        rows = np.zeros((self.n - start if K is None else K, 2 * L + 3), np.float32)
        rows[:, 2 * L + 2] = float(self.cap if noop_index is None else noop_index)
        for j, i in enumerate(range(start, self.n)):
            rows[j] = self._pack_row(i)
        return rows

    def host_padded(self):
        """Full-capacity views of the authoritative host arrays (``vals``,
        ``active``, ``losses``, ``has_loss``), padding included: what a
        cohort stacks into its ``[S, cap]`` mirror.  Read-only."""
        return {"vals": self._vals, "active": self._active,
                "losses": self._losses, "has_loss": self._has_loss}

    def _mirror_plan(self):
        """``(storage name, qparams or None)`` of the device mirror: a code
        name stores codes once :meth:`ensure_qparams` armed them, and bf16
        until then."""
        if quant.is_quant_name(self.hist_dtype):
            if self.qparams is not None:
                return self.hist_dtype, self.qparams
            return "bfloat16", None
        return self.hist_dtype, None

    def ensure_qparams(self, cs):
        """Arm the space's int8/fp8 code once: a no-op unless ``hist_dtype``
        is a code name not armed yet.  A space the code cannot represent
        degrades this history to bf16 (``quant.resolve`` warns once).  On
        success the recorded rows are snapped to the grid retroactively and
        the mirror re-uploads as codes."""
        if self.qparams is not None or not quant.is_quant_name(self.hist_dtype):
            return
        if self._pending is not None:
            raise StaleHistoryError("PaddedHistory.ensure_qparams during an "
                                    "uncommitted tick")
        _, qp = quant.resolve(cs, self.hist_dtype, context="history")
        if qp is None or any(l not in qp for l in self.labels):
            self.hist_dtype = "bfloat16"
            return
        self.qparams = {l: qp[l] for l in self.labels}
        for l in self.labels:
            m = self._active[l][: self.n]
            if m.any():
                v = self._vals[l][: self.n]
                v[m] = quant.snap_np(v[m], self.qparams[l], self.hist_dtype)
        self._dev = None

    def _full_upload(self):
        dev = self.device
        name, qp = self._mirror_plan()
        if qp is not None:
            vals = {l: quant.quantize_np(self._vals[l], qp[l], name).to(dev)
                    for l in self.labels}
        else:
            vals = {l: torch.tensor(self._vals[l], dtype=quant.vals_dtype(name), device=dev)
                    for l in self.labels}
        self._dev = {
            "vals": vals,
            "active": {l: torch.tensor(self._active[l], device=dev) for l in self.labels},
            "losses": torch.tensor(self._losses, dtype=quant.losses_dtype(name), device=dev),
            "has_loss": torch.tensor(self._has_loss, device=dev),
        }
        self._dev_synced = self.n
        # the cap-sized mirror, for the device-memory census (obs/devmem.py);
        # uploads are rare (first view, growth), so this is off the tick
        register_owner("history", *vals.values(), *self._dev["active"].values(),
                       self._dev["losses"], self._dev["has_loss"])

    def device_state(self):
        """``(dev, rows)`` for one tick: the device mirror as of the last
        commit and a ``[K, 2L+3]`` float32 tensor of the K rows it lacks
        (no padding rows: an eager fold has no shape to keep stable).
        The tick folds ``rows`` into ``dev`` in place and then calls
        :meth:`commit_device` (or :meth:`abandon_device` if it failed)."""
        if self._pending is not None:
            raise StaleHistoryError(
                "PaddedHistory.device_state: the previous tick neither "
                "committed (commit_device) nor abandoned (abandon_device) "
                "its update of the device mirror")
        if self._dev is None or self.n - self._dev_synced > self._MAX_FOLD_ROWS:
            self._full_upload()
        rows = torch.from_numpy(self.pack_rows(self._dev_synced)).to(self.device)
        self._pending = self.n
        return self._dev, rows

    def commit_device(self):
        """Mark the rows handed out by :meth:`device_state` as folded."""
        self._dev_synced, self._pending = self._pending, None

    def abandon_device(self):
        """Drop the mirror after a failed tick; the next one re-uploads."""
        self._dev = None
        self._pending = None

    def device_view(self):
        """The device mirror with every row folded in (re-uploaded when rows
        are pending), plus ``n`` and ``cap``."""
        if self._pending is not None:
            raise StaleHistoryError("PaddedHistory.device_view during an "
                                    "uncommitted tick")
        if self._dev is None or self._dev_synced < self.n:
            self._full_upload()
        return {**self._dev, "n": self.n, "cap": self.cap}


class Ctrl:
    """Control object handed to low-level objectives
    (hyperopt/base.py sym: Ctrl)."""

    def __init__(self, trials, current_trial=None):
        self.trials = trials
        self.current_trial = current_trial

    @property
    def attachments(self):
        return self.trials.attachments

    def checkpoint(self, result=None):
        """Record a partial result for the in-flight trial and persist it
        through the backend (``Trials.checkpoint_trial``)."""
        if self.current_trial is None:
            return
        if result is not None:
            self.current_trial["result"] = result
        self.trials.checkpoint_trial(self.current_trial)

    def inject_results(self, specs, results, miscs, new_tids=None):
        if new_tids is None:
            new_tids = self.trials.new_trial_ids(len(specs))
        docs = self.trials.new_trial_docs(new_tids, specs, results, miscs)
        for doc in docs:
            doc["state"] = JOB_STATE_DONE
        return self.trials.insert_trial_docs(docs)


class Trials:
    """In-memory trial store, document-compatible with the reference
    (hyperopt/base.py sym: Trials), plus the padded history its
    suggesters read.  ``device`` is where that history lives and where
    the suggesters run: CUDA unless ``device="cpu"``.  ``hist_dtype``
    names the history mirror's storage (``HYPEROPT_TPU_HIST_DTYPE`` when
    None)."""

    asynchronous = False

    def __init__(self, exp_key=None, refresh=True, device=None, hist_dtype=None):
        self.device = resolve_device(device)
        self.hist_dtype = hist_dtype
        self._ids = set()
        self._dynamic_trials = []
        self._exp_key = exp_key
        self.attachments = {}
        self._history = None
        self._history_synced = 0
        self._history_pending = []
        if refresh:
            self.refresh()

    def __len__(self):
        return len(self._trials)

    def __iter__(self):
        return iter(self._trials)

    def __getitem__(self, item):
        return self._trials[item]

    def refresh(self):
        if self._exp_key is None:
            self._trials = [d for d in self._dynamic_trials if d["state"] != JOB_STATE_ERROR]
        else:
            self._trials = [
                d for d in self._dynamic_trials
                if d["state"] != JOB_STATE_ERROR and d["exp_key"] == self._exp_key
            ]
        self._ids.update(d["tid"] for d in self._dynamic_trials)

    def insert_trial_doc(self, doc):
        doc = _validate_trial_doc(doc)
        self._dynamic_trials.append(doc)
        return doc["tid"]

    def insert_trial_docs(self, docs):
        return [self.insert_trial_doc(d) for d in docs]

    def delete_all(self):
        self._dynamic_trials = []
        self._ids = set()
        self.attachments = {}
        self._history = None
        self._history_synced = 0
        self._history_pending = []
        self.refresh()

    def checkpoint_trial(self, doc):
        """Persist a mid-trial partial result (the ``Ctrl.checkpoint``
        hook).  In-memory trials share doc objects with the evaluator, so
        the mutation is already visible; the file store and the executor
        override this."""

    def new_trial_ids(self, n):
        aa = len(self._ids)
        rval = list(range(aa, aa + n))
        self._ids.update(rval)
        return rval

    def new_trial_docs(self, tids, specs, results, miscs):
        rval = []
        for tid, spec, result, misc in zip(tids, specs, results, miscs):
            rval.append({
                "state": JOB_STATE_NEW,
                "tid": tid,
                "spec": spec,
                "result": result,
                "misc": misc,
                "exp_key": self._exp_key,
                "owner": None,
                "version": 0,
                "book_time": None,
                "refresh_time": None,
            })
        return rval

    @property
    def trials(self):
        return self._trials

    @property
    def tids(self):
        return [d["tid"] for d in self._trials]

    @property
    def specs(self):
        return [d["spec"] for d in self._trials]

    @property
    def results(self):
        return [d["result"] for d in self._trials]

    @property
    def miscs(self):
        return [d["misc"] for d in self._trials]

    @property
    def idxs_vals(self):
        return miscs_to_idxs_vals(self.miscs)

    @property
    def idxs(self):
        return self.idxs_vals[0]

    @property
    def vals(self):
        return self.idxs_vals[1]

    def losses(self, bandit=None):
        return [r.get("loss") for r in self.results]

    def statuses(self, bandit=None):
        return [r.get("status") for r in self.results]

    def count_by_state_synced(self, arg, trials=None):
        if trials is None:
            trials = self._trials
        if isinstance(arg, int):
            return sum(1 for d in trials if d["state"] == arg)
        return sum(1 for d in trials if d["state"] in arg)

    def count_by_state_unsynced(self, arg):
        if self._exp_key is not None:
            exp_trials = [d for d in self._dynamic_trials if d["exp_key"] == self._exp_key]
        else:
            exp_trials = self._dynamic_trials
        return self.count_by_state_synced(arg, trials=exp_trials)

    @property
    def best_trial(self):
        candidates = [
            d for d in self._trials
            if d["result"].get("status") == STATUS_OK and d["result"].get("loss") is not None
        ]
        if not candidates:
            raise AllTrialsFailed()
        return min(candidates, key=lambda d: d["result"]["loss"])

    @property
    def argmin(self):
        return spec_from_misc(self.best_trial["misc"])

    def trial_attachments(self, trial):
        """Per-trial attachment dict view keyed under ``ATTACH::<tid>::``."""
        tid = trial["tid"]
        store = self.attachments
        prefix = f"ATTACH::{tid}::"

        class _View:
            def __setitem__(_, k, v):
                store[prefix + k] = v

            def __getitem__(_, k):
                return store[prefix + k]

            def __contains__(_, k):
                return (prefix + k) in store

            def __delitem__(_, k):
                del store[prefix + k]

            def keys(_):
                return [k[len(prefix):] for k in store if k.startswith(prefix)]

        return _View()

    def padded_history(self, labels):
        """The device view of the folded history (see :meth:`history_object`
        and ``PaddedHistory.device_view``)."""
        return self.history_object(labels).device_view()

    def history_object(self, labels):
        """Fold DONE trials into the padded history and return it.

        Settled docs fold as soon as they are seen; NEW/RUNNING ones wait in
        a pending list revisited on every call, so fold order is completion
        order."""
        if self._history is None or self._history.labels != tuple(labels):
            self._history = PaddedHistory(labels, self.device,
                                          getattr(self, "hist_dtype", None))
            self._history_synced = 0
            self._history_pending = []
        docs = self._dynamic_trials

        def fold(doc):
            if doc["state"] != JOB_STATE_DONE:
                return
            result = doc["result"]
            loss = result.get("loss") if result.get("status") == STATUS_OK else None
            self._history.append(spec_from_misc(doc["misc"]), loss)

        still_pending = []
        for doc in self._history_pending:
            if doc["state"] in (JOB_STATE_NEW, JOB_STATE_RUNNING):
                still_pending.append(doc)
            else:
                fold(doc)
        self._history_pending = still_pending
        while self._history_synced < len(docs):
            doc = docs[self._history_synced]
            self._history_synced += 1
            if doc["state"] in (JOB_STATE_NEW, JOB_STATE_RUNNING):
                self._history_pending.append(doc)
            else:
                fold(doc)
        return self._history

    def fmin(self, fn, space, **kwargs):
        """``fmin`` over these trials (hyperopt/base.py sym: Trials.fmin);
        ``kwargs`` are :func:`hyperopt_tpu_torch.fmin.fmin`'s."""
        from .fmin import fmin as _fmin

        return _fmin(fn, space, trials=self, **kwargs)

    # pickle: drop the history (rebuilt lazily), the live obs handles fmin
    # installs (the run's bundle and its capture plane: per-run, with
    # locks and an open sink; fmin re-installs them on resume) and the live
    # Domain attachment, which closes over the user objective; an
    # asynchronous backend's pickled Domain blob is kept
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_history"] = None
        state["_history_synced"] = 0
        state["_history_pending"] = []
        state.pop("obs_health", None)
        state.pop("obs_profiler", None)
        attachments = dict(state.get("attachments", {}))
        dom = attachments.get("FMinIter_Domain")
        if dom is not None and not isinstance(dom, (bytes, bytearray)):
            del attachments["FMinIter_Domain"]
        state["attachments"] = attachments
        return state


def trials_from_docs(docs, validate=True, **kwargs):
    """Build Trials from documents (hyperopt/base.py sym: trials_from_docs);
    ``kwargs`` go to :class:`Trials` (``device=`` among them)."""
    rval = Trials(**kwargs)
    if validate:
        for doc in docs:
            _validate_trial_doc(doc)
    rval._dynamic_trials = list(docs)
    rval.refresh()
    return rval


def trials_from_flat_history(cs, vals, active, losses, cmd, device=None):
    """A reference-shaped :class:`Trials` (on ``device``) from a dense flat
    history: one DONE document per trial, sparse idxs/vals from the active
    masks (an inactive conditional label gets empty lists), a finite loss
    → STATUS_OK, anything else → STATUS_FAIL.  ``vals``/``active`` are
    ``{label: array[n]}``, ``losses`` ``array[n]``, and ``cmd`` the
    ``misc["cmd"]`` tag of the driver that produced them
    (``device_fmin.fmin_device(return_trials=True)``)."""
    docs = []
    for i in range(len(losses)):
        idxs, vs = {}, {}
        for l in cs.labels:
            if active[l][i]:
                v = vals[l][i]
                v = int(round(float(v))) if cs.params[l].is_int else float(v)
                idxs[l], vs[l] = [i], [v]
            else:
                idxs[l], vs[l] = [], []
        loss = float(losses[i])
        result = ({"loss": loss, "status": STATUS_OK}
                  if np.isfinite(loss) else {"status": STATUS_FAIL})
        docs.append({
            "state": JOB_STATE_DONE, "tid": i, "spec": None, "result": result,
            "misc": {"tid": i, "cmd": (cmd, None), "idxs": idxs, "vals": vs},
            "exp_key": None, "owner": None, "version": 0,
            "book_time": None, "refresh_time": None,
        })
    trials = Trials(device=device)
    trials.insert_trial_docs(docs)
    trials.refresh()
    return trials


class Domain:
    """Binds objective + compiled search space
    (hyperopt/base.py sym: Domain.__init__, Domain.evaluate)."""

    def __init__(self, fn, expr, workdir=None, pass_expr_memo_ctrl=None,
                 name=None, loss_target=None):
        self.fn = fn
        self.space = expr
        self.expr = as_expr(expr)
        self.cs: CompiledSpace = compile_space(expr)
        self.params = self.cs.params
        self.workdir = workdir
        self.name = name
        self.loss_target = loss_target
        self.pass_expr_memo_ctrl = bool(
            pass_expr_memo_ctrl if pass_expr_memo_ctrl is not None
            else getattr(fn, "fmin_pass_expr_memo_ctrl", False)
        )

    @property
    def labels(self):
        return self.cs.labels

    def evaluate(self, config, ctrl, attach_attachments=True):
        """Run the objective on one flat config.  It runs inside
        ``utils.evaluation_device`` of the trials' device, so an objective
        that makes tensors from host numbers (``utils.eval_device``) runs
        where the trials live."""
        device = getattr(getattr(ctrl, "trials", None), "device", None)
        with (evaluation_device(device) if device is not None
              else contextlib.nullcontext()):
            if self.pass_expr_memo_ctrl:
                rval = self.fn(expr=self.expr, memo=dict(config), ctrl=ctrl)
            else:
                rval = self.fn(self.cs.assemble(config))

        if isinstance(rval, (float, int, np.floating, np.integer)) or (
            isinstance(rval, (np.ndarray, torch.Tensor)) and np.ndim(rval) == 0
        ):
            loss = float(rval)
            if math.isnan(loss):
                raise InvalidLoss(f"objective returned NaN for config {config}")
            dict_rval = {"loss": loss, "status": STATUS_OK}
        else:
            dict_rval = dict(rval)
            status = dict_rval.get("status")
            if status not in STATUS_STRINGS:
                raise InvalidResultStatus(f"invalid status {status!r}")
            if status == STATUS_OK:
                if "loss" not in dict_rval:
                    raise InvalidLoss("ok result without loss")
                loss = float(dict_rval["loss"])
                if math.isnan(loss):
                    raise InvalidLoss(f"objective returned NaN for config {config}")
                dict_rval["loss"] = loss

        if attach_attachments and ctrl is not None:
            attachments = dict_rval.pop("attachments", {})
            if ctrl.current_trial is not None:
                view = ctrl.trials.trial_attachments(ctrl.current_trial)
                for k, v in attachments.items():
                    view[k] = v
        return dict_rval

    def make_batch_eval(self):
        """``(flat_batch) -> losses`` for an objective written in torch
        ops: ``torch.func.vmap`` over the traced assemble and the
        objective, the counterpart of the JAX package's
        ``jax.jit(jax.vmap(one))``.  ``flat_batch`` maps each label to a
        ``[B]`` tensor (int32 for integer labels)."""

        def one(flat):
            return self.fn(self.cs.assemble(flat, traced=True))

        return torch.func.vmap(one)

    def new_result(self):
        return {"status": STATUS_NEW}
