"""Overload control for the ask/tell service (counterpart of
``hyperopt_tpu/service/overload.py``, copied: host-only): request
deadlines, a bounded admission queue with load-shedding, and the
device-fault degrade ladder's policy object.

Design:

* **Deadlines are monotonic.**  A request may carry ``X-Deadline-Ms``;
  the server clamps it to its own default
  (``HYPEROPT_TPU_SERVICE_DEADLINE_MS``).  The deadline is stamped once
  at ingress against ``time.monotonic()`` and checked at every wait
  point — an NTP step or suspend never extends (or collapses) a
  request's budget.  An expired ask answers 429 with ``Retry-After``
  (the work was never started; retrying later is exactly right).

* **Bounded admission, shed don't queue.**  At most
  ``HYPEROPT_TPU_SERVICE_QUEUE`` asks may be admitted (waiting for a
  wave or inside one).  Past the bound the server answers 429
  immediately instead of building an unbounded latency queue — the
  overloaded state costs each shed client one cheap round trip, and
  the served ``study_ask_p99_ms`` stays bounded (the overload pin).

* **Sheds /ask before /tell.**  Tells are cheap (a dict update + one
  journal line) and PRESERVE state — shedding a tell loses a client's
  finished work, shedding an ask loses nothing.  The breaker therefore
  gives tells 4x the ask bound, so a saturated service drains results
  while refusing new work.

* **Retry-After is measured, not guessed.**  A live EWMA of wave
  latency (updated by the scheduler after every cohort wave) sizes the
  hint: ``excess waves x wave EWMA``, floored at 50ms — clients built
  on :mod:`hyperopt_tpu_torch.service.client` honor it with deterministic
  jittered backoff.

Everything here is pure policy over an injectable monotonic clock, so
tier-1 tests drive it with a fake clock; the scheduler/server own the
actual waiting.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Deadline", "OverloadError", "DeadlineExceeded",
           "StoreFullShed", "AdmissionGuard", "DegradeLadder",
           "LADDER_LEVELS", "NonFiniteProposal", "is_device_fault"]


class OverloadError(RuntimeError):
    """Load shed (HTTP 429 + ``Retry-After: retry_after`` seconds)."""

    def __init__(self, message, retry_after=0.05):
        super().__init__(message)
        self.retry_after = float(retry_after)


class DeadlineExceeded(OverloadError):
    """The request's deadline expired before (or while) serving it.
    Subclasses :class:`OverloadError` so the HTTP mapping (429 +
    ``Retry-After``) rides along — the client should come back when the
    service is less loaded, which is the same remedy."""


class StoreFullShed(OverloadError):
    """Ask shed because the store is (or just was) out of disk space
   : HTTP **507** + ``Retry-After``.  Distinct from 429 so
    clients and dashboards can tell load pressure from disk pressure;
    retryable either way.  Tells are NOT shed on this state — they
    preserve client work and shed last (the existing 4x policy), only
    a genuinely failing WAL append refuses one (also 507)."""


class Deadline:
    """A monotonic request deadline.  ``None`` budget means no deadline
    (both the header and the server default disabled)."""

    __slots__ = ("t_deadline", "_clock")

    def __init__(self, budget_ms, clock=time.monotonic):
        self._clock = clock
        self.t_deadline = (None if budget_ms is None
                           else clock() + float(budget_ms) / 1e3)

    @classmethod
    def from_request(cls, header_ms, default_ms, clock=time.monotonic):
        """Combine the ``X-Deadline-Ms`` header with the server default:
        the TIGHTER of the two wins (a client may shrink its budget,
        never extend the server's).  An unparseable header is ignored —
        a malformed hint must not turn into an infinite budget."""
        budget = default_ms
        if header_ms is not None:
            try:
                ms = float(header_ms)
                if ms > 0 and (budget is None or ms < budget):
                    budget = ms
            except (TypeError, ValueError):
                pass
        return cls(budget, clock=clock)

    def remaining(self):
        """Seconds left, ``None`` when unbounded (never negative)."""
        if self.t_deadline is None:
            return None
        return max(0.0, self.t_deadline - self._clock())

    def expired(self):
        return (self.t_deadline is not None
                and self._clock() >= self.t_deadline)

    def check(self, what="request"):
        if self.expired():
            raise DeadlineExceeded(f"{what} deadline exceeded")


class AdmissionGuard:
    """Bounded admission queue + shed policy + wave-latency EWMA (module
    docstring).  Thread-safe; the scheduler/server call :meth:`admit_ask`
    / :meth:`admit_tell` at ingress and MUST pair each successful admit
    with :meth:`release` (use ``try/finally``)."""

    #: tells shed only past this multiple of the ask bound
    TELL_SLACK = 4

    def __init__(self, max_queue=None, metrics=None, clock=time.monotonic,
                 tenant_quota=None):
        from .._env import parse_service_queue, parse_tenant_quota

        self.max_queue = (parse_service_queue() if max_queue is None
                          else int(max_queue))
        # the per-tenant ask budget, checked before the global bound: a
        # noisy tenant sheds while the others still admit.  None resolves
        # HYPEROPT_TPU_TENANT_QUOTA (off by default), False disarms, an
        # int arms.  Entries drop at zero in flight, so the map is bounded
        # by concurrency, not by tenant cardinality.
        if tenant_quota is None:
            tenant_quota = parse_tenant_quota()
        self.tenant_quota = None if not tenant_quota else max(1, int(tenant_quota))
        self._tenant_inflight = {}
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = {"ask": 0, "tell": 0}
        self._wave_ewma = None  # seconds; None until the first wave lands
        # store-full shed latch: armed by the scheduler when
        # a WAL/store write hit ENOSPC (or the disk watermark tripped);
        # expires after its window so ONE probe request reaches the
        # scheduler and re-tests the disk, re-arming on failure —
        # recovery is automatic when space returns, no operator needed
        self._store_full_until = None
        self._store_full_reason = ""
        self._store_retry_after = 1.0
        self.metrics = metrics

    # -- store-full latch ---------------------------------------

    def set_store_full(self, full, reason="", retry_after=1.0):
        """Arm/disarm the store-full ask shed for one latch window
        (``2 x retry_after``, so shed clients retrying on the hint meet
        an open probe window)."""
        with self._lock:
            if full:
                self._store_full_until = (self._clock()
                                          + 2.0 * float(retry_after))
                self._store_full_reason = str(reason)
                self._store_retry_after = float(retry_after)
            else:
                self._store_full_until = None
            self._gauge("service.store_full",
                        1.0 if full else 0.0)

    def _store_full_locked(self):
        until = self._store_full_until
        if until is None:
            return False
        if self._clock() >= until:
            # latch window over: let the next ask through as the probe
            self._store_full_until = None
            self._gauge("service.store_full", 0.0)
            return False
        return True

    # -- admission ---------------------------------------------------------

    def admit_ask(self, deadline=None, tenant=None):
        """Admit one ask or shed.  Sheds when the queue is full OR when
        the request's remaining deadline cannot cover even the predicted
        wait (``queued waves x wave EWMA``) — refusing up front beats
        burning a wave slot on an answer the client will have abandoned.
        A store-full latch sheds with 507 before either; with a
        ``tenant_quota`` armed, a tenant past its own budget sheds a
        per-tenant 429 before it contends for the global queue."""
        with self._lock:
            if self._store_full_locked():
                self._count("service.shed.store_full")
                raise StoreFullShed(
                    f"store full: {self._store_full_reason or 'disk'}"
                    " — retry after space frees",
                    retry_after=self._store_retry_after)
            depth = self._inflight["ask"]
            if self.tenant_quota is not None and tenant is not None:
                t_depth = self._tenant_inflight.get(tenant, 0)
                if t_depth >= self.tenant_quota:
                    self._count("service.shed.tenant")
                    raise OverloadError(
                        f"tenant {tenant!r} over its ask budget "
                        f"({t_depth}/{self.tenant_quota} admitted)",
                        retry_after=self._retry_after_locked(depth))
            if depth >= self.max_queue:
                self._count("service.shed.ask")
                raise OverloadError(
                    f"ask queue full ({depth}/{self.max_queue} admitted)",
                    retry_after=self._retry_after_locked(depth))
            if deadline is not None:
                remaining = deadline.remaining()
                predicted = self._predicted_wait_locked(depth)
                if remaining is not None and predicted > remaining:
                    self._count("service.shed.ask")
                    self._count("service.shed.deadline")
                    raise OverloadError(
                        f"deadline too tight: ~{predicted:.3f}s predicted "
                        f"wait vs {remaining:.3f}s remaining",
                        retry_after=self._retry_after_locked(depth))
            self._inflight["ask"] = depth + 1
            if self.tenant_quota is not None and tenant is not None:
                self._tenant_inflight[tenant] = self._tenant_inflight.get(tenant, 0) + 1
            self._gauge("service.queue_depth", depth + 1)
        return "ask"

    def admit_tell(self):
        """Admit one tell; sheds only past ``TELL_SLACK x max_queue`` —
        the breaker keeps the state-preserving path open while asks shed."""
        bound = self.max_queue * self.TELL_SLACK
        with self._lock:
            depth = self._inflight["tell"]
            if depth >= bound:
                self._count("service.shed.tell")
                raise OverloadError(
                    f"tell queue full ({depth}/{bound} admitted)",
                    retry_after=self._retry_after_locked(depth))
            self._inflight["tell"] = depth + 1
        return "tell"

    def release(self, token, tenant=None):
        with self._lock:
            self._inflight[token] = max(0, self._inflight[token] - 1)
            if token == "ask" and tenant is not None and self.tenant_quota is not None:
                left = self._tenant_inflight.get(tenant, 0) - 1
                if left > 0:
                    self._tenant_inflight[tenant] = left
                else:
                    self._tenant_inflight.pop(tenant, None)
            if token == "ask":
                self._gauge("service.queue_depth", self._inflight["ask"])

    # -- wave latency ------------------------------------------------------

    #: EWMA smoothing for wave latency: ~5-wave memory, so Retry-After
    #: tracks a load swing within a few waves without chasing single
    #: outliers
    ALPHA = 0.3

    def observe_wave(self, sec):
        """The scheduler reports each cohort wave's wall time here."""
        sec = float(sec)
        with self._lock:
            self._wave_ewma = (sec if self._wave_ewma is None
                               else (1 - self.ALPHA) * self._wave_ewma
                               + self.ALPHA * sec)
            self._gauge("service.wave_ewma_sec", self._wave_ewma)

    def wave_ewma(self):
        with self._lock:
            return self._wave_ewma

    def _predicted_wait_locked(self, depth):
        """Expected wait for a newly admitted ask: how many waves' worth
        of queue is ahead of it.  With no EWMA yet (cold start) predict 0
        — admit and learn."""
        if self._wave_ewma is None:
            return 0.0
        waves_ahead = 1 + depth // max(1, self.max_queue)
        return waves_ahead * self._wave_ewma

    def _retry_after_locked(self, depth):
        """``Retry-After`` seconds from live wave latency: the time for
        the EXCESS queue to drain, floored at 50ms so a hot client never
        busy-spins on integer-zero hints."""
        ewma = self._wave_ewma if self._wave_ewma is not None else 0.0
        excess_waves = 1 + max(0, depth - self.max_queue) \
            // max(1, self.max_queue)
        return max(0.05, excess_waves * ewma)

    def _count(self, name):
        if self.metrics is not None:
            self.metrics.counter(name).inc()

    def _gauge(self, name, v):
        if self.metrics is not None:
            self.metrics.gauge(name).set(v)


# ---------------------------------------------------------------------------
# device-fault degrade ladder
# ---------------------------------------------------------------------------

#: Ladder levels, walked DOWN on device faults and UP after clean waves.
#: ``cand_scale`` multiplies ``n_EI_candidates`` for the wave's cohort
#: ticks; ``cap_limit`` is the largest cohort capacity bucket still
#: served on device (bigger buckets — the memory-heavy ones — fall back
#: to rand for the wave); ``rand`` serves every TPE ask host-side via
#: ``rand.suggest`` (flagged in the response), touching the device not
#: at all.  Every level keeps serving: the ladder never kills the
#: server, and host-side state (the authoritative arrays, the journal)
#: is untouched by any transition.
LADDER_LEVELS = (
    {"name": "normal", "cand_scale": 1.0, "cap_limit": None, "rand": False},
    {"name": "half_candidates", "cand_scale": 0.5, "cap_limit": None,
     "rand": False},
    {"name": "small_caps", "cand_scale": 0.25, "cap_limit": 64,
     "rand": False},
    {"name": "rand_fallback", "cand_scale": 1.0, "cap_limit": 0,
     "rand": True},
)


class DegradeLadder:
    """Degrade-ladder state machine (pure policy; the scheduler's wave
    path calls :meth:`record_fault` / :meth:`record_clean_wave` and reads
    :meth:`level`).  ``recover_after`` clean waves at a degraded level
    probe one level back up; a fault at ANY level steps one level down
    and resets the clean count — so a persistently faulting device walks
    to rand fallback and stays there until the device proves itself
    again, one recovery step per patience window."""

    def __init__(self, recover_after=8, metrics=None):
        self.recover_after = max(1, int(recover_after))
        self.metrics = metrics
        self._level = 0
        self._clean_waves = 0
        self.faults = 0
        self.transitions = []  # (direction, from_level, to_level) tail
        self._publish()

    def level(self):
        return self._level

    def spec(self):
        return LADDER_LEVELS[self._level]

    @property
    def degraded(self):
        return self._level > 0

    def record_fault(self):
        """One device fault in a cohort tick: step down (bounded at the
        rand floor — rand faults are host bugs, not device pressure)."""
        self.faults += 1
        if self.metrics is not None:
            self.metrics.counter("service.degrade.faults").inc()
        if self._level < len(LADDER_LEVELS) - 1:
            self._transition(self._level + 1, "down")
        self._clean_waves = 0
        return self._level

    def record_clean_wave(self):
        """One wave served with no device fault; after ``recover_after``
        of them, climb one level (the recovery probe — the next wave
        runs at the better level, and a fault there steps straight back
        down)."""
        if self._level == 0:
            return self._level
        self._clean_waves += 1
        if self._clean_waves >= self.recover_after:
            self._transition(self._level - 1, "up")
            self._clean_waves = 0
        return self._level

    def _transition(self, to_level, direction):
        frm, self._level = self._level, to_level
        self.transitions.append((direction, frm, to_level))
        del self.transitions[:-64]
        if self.metrics is not None:
            self.metrics.counter(f"service.degrade.{direction}").inc()
        self._publish()

    def _publish(self):
        if self.metrics is not None:
            self.metrics.gauge("service.degraded").set(self._level)

    def status(self):
        return {"level": self._level, "name": self.spec()["name"],
                "faults": self.faults, "clean_waves": self._clean_waves,
                "recover_after": self.recover_after}


def is_device_fault(exc):
    """Classify an exception from a cohort tick dispatch/readback as a
    device fault the ladder should absorb (vs a fault it must surface).

    Absorbed: the card running out of memory
    (``torch.cuda.OutOfMemoryError``, or a "CUDA out of memory"
    message), the chaos plane's injected I/O error at the ``tick`` site
    (:class:`~hyperopt_tpu_torch.chaos.InjectedFault`) and the
    non-finite-output marker the scheduler raises after readback.

    Surfaced: everything else — a kernel library that does not build or
    load, a wrapper's launch or shape check (``megakernel._check`` /
    ``_launchable``), a failed launch, and the sticky CUDA errors
    (illegal address, launch failure) that poison the context.
    Absorbing those would walk the ladder to its rand floor and serve
    prior draws for ever, hiding a broken kernel behind answers that
    look healthy; they answer 500 instead."""
    if isinstance(exc, NonFiniteProposal):
        return True
    from .. import chaos

    if isinstance(exc, chaos.InjectedFault):
        return True
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and "CUDA out of memory" in str(exc)


class NonFiniteProposal(RuntimeError):
    """A cohort tick read back non-finite proposals (NaN posterior /
    inf EI) — treated as a device fault: the wave retries down-ladder,
    ultimately serving rand proposals, which are always finite."""
