"""The search-quality plane (counterpart of ``hyperopt_tpu/obs/quality.py``,
copied: host-only).

:class:`QualityPlane` (one per
:class:`~hyperopt_tpu_torch.service.scheduler.StudyScheduler`) folds each
settled tell into its study's convergence state: the best-so-far curve,
the simple regret against the zoo entry's known ``optimum`` and
``loss_target`` (for a study created from ``{"zoo": name}``), an
improvement-rate EWMA, the trials since the last improvement, and a
plateau detector with ``early_stop.no_progress_loss``'s improvement test,
edge-triggered once per plateau.  An edge lands on the study's timeline
and the flight ring; the ``quality.*`` gauges refresh per (algo, space)
cohort at scrape time; and a stagnant-fraction objective feeds the
server's SLO plane.  It reads settled losses only, never the RNG or a
proposal: armed and disarmed schedulers propose the same streams bit for
bit, and disarmed (``HYPEROPT_TPU_QUALITY=off``) means
``scheduler.quality is None``.

:func:`summarize_run` summarizes one finished run for the per-algorithm
quality table.  :func:`quality_record`, the trajectory store's record,
needs ``obs/trajectory.py``, which is not ported yet (ROADMAP.md, queue
1, item 14): it raises ``not_ported``.
"""

from __future__ import annotations

import hashlib
import threading

__all__ = ["DEFAULT_PLATEAU_WINDOW", "DEFAULT_PLATEAU_PCT", "DEFAULT_EWMA_ALPHA",
           "QUALITY_ALGOS", "StudyQuality", "QualityPlane", "merge_status", "summarize_run",
           "quality_record"]

#: tells without an improvement before the plateau detector fires
#: (``no_progress_loss``'s ``iteration_stop_count``)
DEFAULT_PLATEAU_WINDOW = 20

#: required relative improvement in percent (``no_progress_loss``'s
#: ``percent_increase``): 0.0 means any strictly better loss
DEFAULT_PLATEAU_PCT = 0.0

#: improvement-rate EWMA weight
DEFAULT_EWMA_ALPHA = 0.3

#: bound on a study's stored best-so-far change points
_CURVE_CAP = 128

#: the algorithms of the per-algorithm quality table
QUALITY_ALGOS = ("tpe", "rand", "anneal", "mix", "atpe")


def _sanitize(label):
    """Metric-name-safe cohort label."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in str(label))


class StudyQuality:
    """One study's convergence state, folded at tell time by
    :meth:`observe` (O(1), no I/O, no RNG).  The improvement test is
    ``loss < best - |best| * pct / 100``; the stagnation flag fires once
    when the trials since an improvement reach ``window`` and clears on
    the next improvement."""

    __slots__ = ("study_id", "cohort", "optimum", "loss_target", "window", "pct", "alpha",
                 "best", "n_told", "since_improvement", "stagnant", "improvements",
                 "stagnations", "ewma", "trials_to_target", "solved", "curve")

    def __init__(self, study_id, cohort, optimum=None, loss_target=None,
                 window=DEFAULT_PLATEAU_WINDOW, pct=DEFAULT_PLATEAU_PCT,
                 alpha=DEFAULT_EWMA_ALPHA):
        self.study_id = study_id
        self.cohort = cohort
        self.optimum = None if optimum is None else float(optimum)
        self.loss_target = None if loss_target is None else float(loss_target)
        self.window = int(window)
        self.pct = float(pct)
        self.alpha = float(alpha)
        self.best = None
        self.n_told = 0
        self.since_improvement = 0
        self.stagnant = False
        self.improvements = 0
        self.stagnations = 0
        self.ewma = None  # improvement-rate EWMA (loss units per tell)
        self.trials_to_target = None
        self.solved = False
        self.curve = []  # best-so-far change points: (n_told, best)

    def observe(self, loss):
        """Fold one told result (``loss`` the ok loss, None for a failed
        trial).  Returns ``"improvement"``, ``"stagnation"`` or None."""
        self.n_told += 1
        prev = self.best
        if loss is not None:
            loss = float(loss)
            if prev is None or loss < prev:
                self.best = loss
        improved = loss is not None and (
            prev is None or loss < prev - abs(prev) * (self.pct / 100.0))
        if improved:
            delta = 0.0 if prev is None else max(prev - loss, 0.0)
            self.ewma = (delta if self.ewma is None
                         else self.alpha * delta + (1.0 - self.alpha) * self.ewma)
            self.since_improvement = 0
            self.stagnant = False
            self.improvements += 1
            if len(self.curve) < _CURVE_CAP:
                self.curve.append((self.n_told, self.best))
            if (not self.solved and self.loss_target is not None
                    and self.best <= self.loss_target):
                self.solved = True
                self.trials_to_target = self.n_told
            return "improvement"
        if self.ewma is not None:
            # a tell that does not improve decays the rate toward zero
            self.ewma *= (1.0 - self.alpha)
        self.since_improvement += 1
        if not self.stagnant and self.since_improvement >= self.window:
            self.stagnant = True
            self.stagnations += 1
            return "stagnation"
        return None

    @property
    def regret(self):
        """Simple regret against the known optimum (clamped at 0), or None
        when either side is unknown."""
        if self.best is None or self.optimum is None:
            return None
        return max(self.best - self.optimum, 0.0)

    def status_dict(self):
        """The per-study quality section (``GET /studies``)."""
        out = {
            "cohort": self.cohort,
            "n_told": self.n_told,
            "best_loss": self.best,
            "stagnant": self.stagnant,
            "trials_since_improvement": self.since_improvement,
            "improvement_ewma": self.ewma,
        }
        if self.optimum is not None:
            out["regret"] = self.regret
        if self.loss_target is not None:
            out["solved"] = self.solved
            out["trials_to_target"] = self.trials_to_target
        return out


class QualityPlane:
    """Per-study convergence telemetry of a scheduler (no threads).

    ``metrics`` is the registry the ``quality.*`` gauges publish into at
    scrape time (:meth:`publish`); ``tracer`` takes the improvement and
    stagnation events; ``slo`` is an
    :class:`~hyperopt_tpu_torch.obs.slo.SLOPlane` with a ``stagnation``
    objective (installed by the server), fed one observation per live
    tell.  Every mutation arrives under the scheduler's lock; the plane's
    own lock guards only tracker admission."""

    def __init__(self, metrics=None, tracer=None, slo=None, window=DEFAULT_PLATEAU_WINDOW,
                 pct=DEFAULT_PLATEAU_PCT, alpha=DEFAULT_EWMA_ALPHA):
        self.metrics = metrics
        self.tracer = tracer
        self.slo = slo
        self.window = int(window)
        self.pct = float(pct)
        self.alpha = float(alpha)
        self._studies = {}
        self._lock = threading.Lock()

    def _admit(self, st):
        """Build one study's tracker.  Its cohort key is (serving algo,
        space): the zoo name for a ``{"zoo": ...}`` study (which also gives
        the optimum and target), else a short hash of the space
        signature."""
        optimum = target = label = None
        spec = getattr(st, "space_spec", None)
        if isinstance(spec, dict) and "zoo" in spec:
            from ..zoo import ZOO

            zrec = ZOO.get(str(spec["zoo"]))
            if zrec is not None:
                label = zrec.name
                optimum = zrec.optimum
                target = zrec.loss_target
        if label is None:
            try:
                sig = repr(st.domain.cs.signature())
            except Exception:  # noqa: BLE001 - the cohort label is best effort
                sig = repr(getattr(st, "study_id", "?"))
            label = "sig_" + hashlib.sha1(sig.encode()).hexdigest()[:10]
        # service studies are TPE-served (rand only below n_startup_jobs
        # and at the ladder's floor)
        q = StudyQuality(st.study_id, _sanitize(f"tpe.{label}"), optimum=optimum,
                         loss_target=target, window=self.window, pct=self.pct,
                         alpha=self.alpha)
        self._studies[st.study_id] = q
        return q

    def forget(self, study_id):
        with self._lock:
            self._studies.pop(study_id, None)

    def study_status(self, study_id):
        """Quality section of one study, or None if never told."""
        q = self._studies.get(study_id)
        return None if q is None else q.status_dict()

    def observe_tell(self, st, loss, replay=False):
        """Fold one settled tell (``loss`` the ok loss, None for a failed
        trial), live or replayed, once per told trial; emit its edge
        events.  Replayed tells do not feed the SLO."""
        q = self._studies.get(st.study_id)
        if q is None:
            with self._lock:
                q = self._studies.get(st.study_id)
                if q is None:
                    q = self._admit(st)
        event = q.observe(loss)
        if event is not None:
            st.note(event, best=q.best, regret=q.regret, n_told=q.n_told,
                    since=q.since_improvement if event == "stagnation" else None,
                    replay=True if replay else None)
            if self.metrics is not None:
                self.metrics.counter(f"quality.{event}s").inc()
            if self.tracer is not None:
                self.tracer.event(f"quality.{event}", study=st.study_id, cohort=q.cohort,
                                  best=q.best, regret=q.regret, n_told=q.n_told)
        if self.slo is not None and not replay:
            try:
                self.slo.record_quality(q.stagnant)
            except Exception:  # noqa: BLE001 - observability never fails a tell
                pass
        return event

    def status(self):
        """The quality roll-up (``/snapshot``): counts and the per-cohort
        table."""
        qs = list(self._studies.values())
        cohorts = {}
        for q in qs:
            c = cohorts.setdefault(q.cohort, {"studies": 0, "stagnant": 0, "solved": 0,
                                              "best_loss": None, "best_regret": None})
            c["studies"] += 1
            c["stagnant"] += 1 if q.stagnant else 0
            c["solved"] += 1 if q.solved else 0
            if q.best is not None and (c["best_loss"] is None or q.best < c["best_loss"]):
                c["best_loss"] = q.best
            r = q.regret
            if r is not None and (c["best_regret"] is None or r < c["best_regret"]):
                c["best_regret"] = r
        n = len(qs)
        stagnant = sum(1 for q in qs if q.stagnant)
        return {
            "studies": n,
            "stagnant": stagnant,
            "stagnant_frac": (stagnant / n) if n else 0.0,
            "solved": sum(1 for q in qs if q.solved),
            "improvements": sum(q.improvements for q in qs),
            "stagnations": sum(q.stagnations for q in qs),
            "cohorts": cohorts,
        }

    def publish(self):
        """Refresh the ``quality.*`` gauges and return :meth:`status`."""
        st = self.status()
        if self.metrics is not None:
            g = self.metrics.gauge
            for k in ("studies", "stagnant", "stagnant_frac", "solved"):
                g(f"quality.{k}").set(st[k])
            for key, c in st["cohorts"].items():
                base = f"quality.cohort.{key}"
                g(f"{base}.studies").set(c["studies"])
                g(f"{base}.stagnant").set(c["stagnant"])
                g(f"{base}.solved").set(c["solved"])
                if c["best_regret"] is not None:
                    g(f"{base}.best_regret").set(c["best_regret"])
        return st


def merge_status(statuses):
    """Merge per-scheduler :meth:`QualityPlane.status` dicts (one plane
    per held shard)."""
    statuses = [s for s in statuses if s]
    if not statuses:
        return None
    if len(statuses) == 1:
        return statuses[0]
    out = {"studies": 0, "stagnant": 0, "solved": 0, "improvements": 0, "stagnations": 0,
           "cohorts": {}}
    for s in statuses:
        for k in ("studies", "stagnant", "solved", "improvements", "stagnations"):
            out[k] += int(s.get(k) or 0)
        for key, c in (s.get("cohorts") or {}).items():
            m = out["cohorts"].setdefault(key, {"studies": 0, "stagnant": 0, "solved": 0,
                                                "best_loss": None, "best_regret": None})
            for k in ("studies", "stagnant", "solved"):
                m[k] += c.get(k, 0)
            for fld in ("best_loss", "best_regret"):
                v = c.get(fld)
                if v is not None and (m[fld] is None or v < m[fld]):
                    m[fld] = v
    out["stagnant_frac"] = out["stagnant"] / out["studies"] if out["studies"] else 0.0
    return out


def summarize_run(losses, budget, loss_target=None, optimum=None):
    """One finished run for the quality table: ``best``, ``solved``,
    ``trials_to_target`` (the 1-based index of the first loss at or under
    the target; ``budget`` when unsolved) and ``final_regret`` (None when
    the optimum is unknown).  ``losses`` is in tell order, None for a
    failed trial."""
    best = t2t = None
    for i, loss in enumerate(losses):
        if loss is None:
            continue
        loss = float(loss)
        if best is None or loss < best:
            best = loss
            if t2t is None and loss_target is not None and best <= float(loss_target):
                t2t = i + 1
    solved = t2t is not None
    return {
        "best": best,
        "solved": solved,
        "trials_to_target": t2t if solved else int(budget),
        "final_regret": (max(best - float(optimum), 0.0)
                         if best is not None and optimum is not None else None),
        "budget": int(budget),
    }


def quality_record(source, algos, config=None, root=None):
    """The trajectory store's ``kind="quality"`` record: it stamps the git
    revision through ``obs/trajectory.py``, which is not ported yet."""
    from .._env import not_ported

    raise not_ported("obs.quality.quality_record (obs/trajectory.py)", 14)
