"""SLO error-budget plane for the serving fleet (counterpart of
``hyperopt_tpu/obs/slo.py``, copied: host-only).

The overload guard answers "is this request servable *right
now*"; this module answers the operator's question — "is the service
meeting its objectives *over time*, and how fast is it spending the
error budget".  Three declarative objectives over the traffic the
server already observes:

* **availability** — fraction of requests that did not 5xx (target
  e.g. 99.9%: the error budget is the 0.1% that may);
* **ask_latency** — fraction of served asks faster than a threshold
  (a count-based latency SLO: "99% of asks under 500ms", not a single
  quantile estimate, so the budget math is exact);
* **shed_rate** — fraction of offered asks NOT shed (backpressure is
  correct behavior under overload, but a service shedding 20% of its
  asks for six hours is failing its users even though every 429 was
  individually right).

**Burn rates, not raw error rates.**  Following the multi-window
multi-burn-rate pattern (Google SRE workbook ch. 5): the *burn rate* of
a window is ``bad_fraction / (1 - target)`` — 1.0 means "spending the
budget exactly as fast as the SLO allows", N means the budget dies in
``period/N``.  Two window pairs:

* **fast** (5m AND 1h both over ``FAST_BURN`` = 14.4) — page-grade: at
  that rate a 30-day budget is gone in ~2 days, and the 5m window means
  it is happening *now* (the 1h guard keeps a single bad minute from
  paging);
* **slow** (30m AND 6h both over ``SLOW_BURN`` = 6) — ticket-grade
  sustained burn.

A pair may alert (and the budget may report exhausted) only once its
long window holds :data:`MIN_ALERT_EVENTS` events — at lower volume
both windows of a pair contain the same few events, the long window
stops guarding the short one, and a single slow request (the first
tick's kernel build, every server start) would page.

Counting is time-bucketed (60s buckets, bounded ring per objective) and
the clock is injectable, so tier-1 tests drive rotation, exhaustion and
recovery on a fake clock without sleeping.  Evaluation is pull-based
(the scrape and snapshot paths call :meth:`SLOPlane.publish`; the
record path re-evaluates at most once per ``eval_interval``) — the
plane starts **zero threads**, armed or not.

**Escalation.**  When the fast pair trips, the plane fires its
escalation hook ONCE per episode (edge-triggered, with a cooldown) —
the server wires it to one bounded device-profiler capture
(``obs/profiler.py``), closing the loop from "SLO violated" to "here is
the device trace of the slow wave".

Gauges (``slo.<objective>.*`` on the service registry, exposed as
``hyperopt_tpu_slo_*`` on ``/metrics``): ``burn_fast`` / ``burn_slow``
(the worse window of each pair), ``budget_remaining_frac`` (over the
long 6h window), ``fast_alerting`` / ``slow_alerting`` / ``exhausted``
(0/1).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

__all__ = ["SLOPlane", "Objective", "DEFAULT_TARGETS", "QUALITY_TARGETS",
           "LOAD_TARGETS", "PROBE_TARGETS", "TENANT_TARGETS", "WINDOWS",
           "FAST_BURN", "SLOW_BURN"]

logger = logging.getLogger(__name__)

#: (fast pair, slow pair) window lengths in seconds
WINDOWS = {"fast": (300.0, 3600.0), "slow": (1800.0, 21600.0)}

#: page-grade burn threshold: both fast windows at/above this alert
FAST_BURN = 14.4
#: ticket-grade sustained-burn threshold for the slow pair
SLOW_BURN = 6.0

#: one bucket per minute; the ring must cover the longest window
_BUCKET_SEC = 60.0
_MAX_BUCKETS = int(max(max(WINDOWS.values())) / _BUCKET_SEC) + 2

#: minimum events in a pair's LONG window before it may alert (or report
#: the budget exhausted): at low traffic both windows of a pair hold the
#: SAME handful of events, so the long window stops guarding the short
#: one and a single slow request (the first tick's kernel build, every
#: server start) would page.  Below this volume the burn rates still
#: report — they just cannot alert or escalate.
MIN_ALERT_EVENTS = 10

#: default objective targets (overridable via the
#: ``HYPEROPT_TPU_SERVICE_SLO`` spec grammar — see ``_env.py``):
#: availability 99.9%, 99% of asks under 500ms, ≤5% of offered asks shed
DEFAULT_TARGETS = {
    "availability": {"target": 0.999},
    "ask_latency": {"target": 0.99, "threshold_ms": 500.0},
    "shed_rate": {"target": 0.95},
}

#: the search-quality objective:
#: one event per LIVE tell, good = the told study is not stagnant after
#: folding the result.  Target 90% — a fleet where >10% of recent tells
#: land on plateaued studies is burning trial budget, not optimizing.
#: Kept out of DEFAULT_TARGETS: it only makes sense when the quality
#: plane is armed, so the server installs it separately.
QUALITY_TARGETS = {
    "stagnation": {"target": 0.90},
}

#: the fleet-imbalance objective: an observation is GOOD
#: when the heat-skew scalar (max/mean shard heat) sits at or under
#: ``skew_max``.  ``skew_max`` rides the spec dict — ``add_objective``
#: only reads target/threshold_ms, so the server keeps the bound and
#: feeds pre-judged booleans via ``record_load``.
LOAD_TARGETS = {
    "imbalance": {"target": 0.90, "skew_max": 3.0},
}

#: blackbox-prober objectives — the CLIENT-view signals,
#: deliberately distinct from the server-side ``availability`` /
#: ``ask_latency`` pair: they are measured through the real HTTP path
#: (retries and redirect hops included), so a wedged listener — which
#: server-side objectives never see — burns budget here.
#: ``probe_golden_match`` is the correctness objective: the fraction of
#: probe cycles whose canary proposal-stream digest matched golden.
PROBE_TARGETS = {
    "probe_avail": {"target": 0.99},
    "probe_golden_match": {"target": 0.999},
    "probe_ask_p99_ms": {"target": 0.99, "threshold_ms": 2000.0},
}


#: per-tenant golden-signal objectives — installed per TOP-K tenant as
#: ``tenant:<id>:<name>`` via :meth:`SLOPlane.add_objective` at
#: gauge-refresh time (idempotent; the cardinality bound on the tenant
#: ledger bounds the objective count too), fed pre-judged booleans via
#: :meth:`SLOPlane.record_event` from the server's response path.
#: Probe-tagged canary traffic never reaches them.
TENANT_TARGETS = {
    "availability": {"target": 0.99},
    "ask_p99": {"target": 0.99, "threshold_ms": 2000.0},
    "shed_rate": {"target": 0.90},
}


class Objective:
    """One SLO: a name, a target fraction of GOOD events, and the
    bounded ring of per-minute (bucket_start, good, bad) counts it is
    evaluated over."""

    __slots__ = ("name", "target", "threshold_ms", "_buckets")

    def __init__(self, name, target, threshold_ms=None):
        self.name = str(name)
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1), got {target!r} for {name}")
        self.threshold_ms = (None if threshold_ms is None
                             else float(threshold_ms))
        self._buckets = deque(maxlen=_MAX_BUCKETS)  # [bucket_ts, good, bad]

    @property
    def budget(self):
        """The error budget as a fraction of events (``1 - target``)."""
        return 1.0 - self.target

    def record(self, ok, now):
        """Count one event into the current minute bucket."""
        b = (now // _BUCKET_SEC) * _BUCKET_SEC
        if self._buckets and self._buckets[-1][0] == b:
            slot = self._buckets[-1]
        elif self._buckets and self._buckets[-1][0] > b:
            # a clock step backwards (or cross-thread skew): fold into
            # the newest bucket rather than corrupting ring order
            slot = self._buckets[-1]
        else:
            slot = [b, 0, 0]
            self._buckets.append(slot)
        slot[1 if ok else 2] += 1

    def window_counts(self, window_sec, now):
        """(good, bad) over the trailing ``window_sec``."""
        cutoff = now - float(window_sec)
        good = bad = 0
        for b, g, bd in reversed(self._buckets):
            if b + _BUCKET_SEC <= cutoff:
                break
            good += g
            bad += bd
        return good, bad

    def burn_rate(self, window_sec, now):
        """``bad_fraction / budget`` over the window; 0.0 with no
        traffic (an idle service is not burning budget)."""
        good, bad = self.window_counts(window_sec, now)
        total = good + bad
        if not total:
            return 0.0
        return (bad / total) / self.budget

    def status(self, now):
        fast = [self.burn_rate(w, now) for w in WINDOWS["fast"]]
        slow = [self.burn_rate(w, now) for w in WINDOWS["slow"]]
        fg, fb = self.window_counts(WINDOWS["fast"][1], now)
        good, bad = self.window_counts(WINDOWS["slow"][1], now)
        total = good + bad
        bad_frac = (bad / total) if total else 0.0
        remaining = 1.0 - bad_frac / self.budget
        # the volume guard (MIN_ALERT_EVENTS) applies to each pair's
        # LONG window: with fewer events the two windows are the same
        # sample and the pair's one-bad-minute veto is void
        return {
            "target": self.target,
            "threshold_ms": self.threshold_ms,
            "window_events": total,
            "burn_fast": min(fast),   # the PAIR alerts on its min: both
            "burn_slow": min(slow),   # windows must exceed the threshold
            "budget_remaining_frac": remaining,
            "fast_alerting": (min(fast) >= FAST_BURN
                              and fg + fb >= MIN_ALERT_EVENTS),
            "slow_alerting": (min(slow) >= SLOW_BURN
                              and total >= MIN_ALERT_EVENTS),
            "exhausted": remaining <= 0.0 and total >= MIN_ALERT_EVENTS,
        }


class SLOPlane:
    """The service's objectives + their gauges + the escalation hook.

    ``targets`` is a ``{name: {"target": .., ...}}`` dict (see
    :data:`DEFAULT_TARGETS`); unknown names are allowed (they count only
    what :meth:`record_request` routes to them — nothing, by default).
    ``metrics`` is the service :class:`~hyperopt_tpu_torch.obs.metrics
    .MetricsRegistry` the ``slo.*`` gauges publish into.  ``clock`` is
    injectable wall time (fake-clock tests).  Thread-safe; no threads of
    its own."""

    def __init__(self, targets=None, metrics=None, clock=time.time,
                 escalation=None, eval_interval=1.0,
                 escalation_cooldown=600.0):
        targets = DEFAULT_TARGETS if targets is None else targets
        self.objectives = {}
        for name, spec in targets.items():
            self.objectives[name] = Objective(
                name, spec["target"],
                threshold_ms=spec.get("threshold_ms"))
        self.metrics = metrics
        self._clock = clock
        self.escalation = escalation
        self.eval_interval = float(eval_interval)
        self.escalation_cooldown = float(escalation_cooldown)
        self._lock = threading.Lock()
        self._last_eval = None
        self._fast_was_alerting = False
        self._last_escalation = None
        self.escalations = 0

    # -- recording ---------------------------------------------------------

    def record_request(self, endpoint, status, latency_sec=None,
                       shed=False, now=None):
        """Feed one finished request.  ``endpoint`` is the metric-label
        endpoint name (``ask``/``tell``/...); ``status`` the HTTP
        status; ``shed`` marks an overload shed (the 429s that came from
        the admission guard, not quota conflicts).  Routing:

        * availability counts EVERY request, bad = 5xx;
        * ask_latency counts served asks (2xx), bad = slower than its
          threshold;
        * shed_rate counts offered asks, bad = shed.
        """
        now = self._clock() if now is None else now
        with self._lock:
            avail = self.objectives.get("availability")
            if avail is not None:
                avail.record(status < 500, now)
            if endpoint == "ask":
                lat = self.objectives.get("ask_latency")
                if (lat is not None and 200 <= status < 300
                        and latency_sec is not None):
                    ok = (lat.threshold_ms is None
                          or latency_sec * 1e3 <= lat.threshold_ms)
                    lat.record(ok, now)
                sr = self.objectives.get("shed_rate")
                if sr is not None:
                    sr.record(not shed, now)
        self._maybe_evaluate(now)

    def add_objective(self, name, spec):
        """Install one more objective after construction (the server
        adds the quality plane's ``stagnation`` objective this way when
        both planes are armed).  Idempotent: an existing objective keeps
        its ring."""
        with self._lock:
            if name not in self.objectives:
                self.objectives[name] = Objective(
                    name, spec["target"],
                    threshold_ms=spec.get("threshold_ms"))

    def record_quality(self, stagnant, now=None):
        """Feed one live tell into the ``stagnation`` objective: good =
        the study is NOT stagnant after folding the result.  No-op when
        the objective was never installed (quality SLO disarmed)."""
        now = self._clock() if now is None else now
        with self._lock:
            obj = self.objectives.get("stagnation")
            if obj is None:
                return
            obj.record(not stagnant, now)
        self._maybe_evaluate(now)

    def record_load(self, balanced, now=None):
        """Feed one load observation into the ``imbalance`` objective:
        good = the fleet's heat skew sat within its bound when the load
        gauges refreshed.  No-op when the objective was never installed
        (load SLO disarmed)."""
        now = self._clock() if now is None else now
        with self._lock:
            obj = self.objectives.get("imbalance")
            if obj is None:
                return
            obj.record(bool(balanced), now)
        self._maybe_evaluate(now)

    def record_event(self, objective, ok, now=None):
        """Feed one pre-judged boolean into any installed objective by
        name (the per-tenant ``tenant:<id>:<name>`` objectives ride
        this — the server judges good/bad from the response it already
        has and this plane only does the burn math).  No-op when the
        objective was never installed."""
        now = self._clock() if now is None else now
        with self._lock:
            obj = self.objectives.get(str(objective))
            if obj is None:
                return
            obj.record(bool(ok), now)
        self._maybe_evaluate(now)

    def record_probe(self, objective, ok, now=None):
        """Feed one blackbox-probe observation into a ``probe_*``
        objective (the prober judges good/bad client-side — request
        succeeded, ask under threshold, cycle matched golden — and this
        plane only does the burn math).  No-op when the objective was
        never installed (probe SLO disarmed)."""
        now = self._clock() if now is None else now
        with self._lock:
            obj = self.objectives.get(str(objective))
            if obj is None:
                return
            obj.record(bool(ok), now)
        self._maybe_evaluate(now)

    # -- evaluation --------------------------------------------------------

    def status(self, now=None):
        """Per-objective status dict (the ``/snapshot`` + report
        section)."""
        now = self._clock() if now is None else now
        with self._lock:
            return {name: obj.status(now)
                    for name, obj in sorted(self.objectives.items())}

    def any_exhausted(self, now=None):
        return any(s["exhausted"] and s["window_events"]
                   for s in self.status(now).values())

    def publish(self, now=None):
        """Evaluate every objective and set the ``slo.*`` gauges;
        returns the status dict.  Called from the scrape/snapshot paths
        and (rate-limited) from :meth:`record_request`."""
        now = self._clock() if now is None else now
        st = self.status(now)
        if self.metrics is not None:
            for name, s in st.items():
                g = f"slo.{name}"
                self.metrics.gauge(f"{g}.burn_fast").set(s["burn_fast"])
                self.metrics.gauge(f"{g}.burn_slow").set(s["burn_slow"])
                self.metrics.gauge(f"{g}.budget_remaining_frac").set(
                    s["budget_remaining_frac"])
                self.metrics.gauge(f"{g}.fast_alerting").set(
                    1.0 if s["fast_alerting"] else 0.0)
                self.metrics.gauge(f"{g}.slow_alerting").set(
                    1.0 if s["slow_alerting"] else 0.0)
                self.metrics.gauge(f"{g}.exhausted").set(
                    1.0 if s["exhausted"] else 0.0)
        self._check_escalation(st, now)
        return st

    def _maybe_evaluate(self, now):
        """Rate-limited publish on the record path, so gauges and the
        escalation edge stay live even when nothing scrapes."""
        with self._lock:
            if (self._last_eval is not None
                    and now - self._last_eval < self.eval_interval):
                return
            self._last_eval = now
        self.publish(now)

    def _check_escalation(self, st, now):
        """Edge-triggered, cooled-down escalation: fire ONCE when the
        fast pair newly alerts on any objective with real traffic (the
        hook runs a bounded profiler capture — firing it per scrape
        would melt the thing it is trying to observe)."""
        alerting = any(s["fast_alerting"] and s["window_events"]
                       for s in st.values())
        fire = False
        with self._lock:
            if alerting and not self._fast_was_alerting:
                if (self._last_escalation is None
                        or now - self._last_escalation
                        >= self.escalation_cooldown):
                    self._last_escalation = now
                    self.escalations += 1
                    fire = True
            self._fast_was_alerting = alerting
        if fire:
            if self.metrics is not None:
                self.metrics.counter("slo.escalations").inc()
            hook = self.escalation
            if hook is not None:
                try:
                    hook()
                except Exception as e:  # noqa: BLE001 - never cascade
                    logger.warning("slo escalation hook failed: %s", e)
