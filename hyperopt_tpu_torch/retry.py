"""Per-trial retry policy: jittered exponential backoff with deterministic
jitter (counterpart of ``hyperopt_tpu/retry.py``, copied: host-only).

Parity target: ``hyperopt/mongoexp.py`` leaves transient-failure handling to
the operator (a crashed trial lands in ``error`` state and stays there);
production spot/preemptible fleets need flaky objectives (OOM-killed
subprocess, preempted accelerator, transient NFS error) retried with
backoff instead of burning an evaluation.  One policy object serves every
evaluation path that re-runs work:

* ``worker.FileWorker`` — retries the objective in place while the
  heartbeat thread keeps the claim fresh; the attempt count is recorded in
  the trial doc (``misc['attempts']``) so a post-mortem can tell a
  first-try success from a third-try one.
* ``parallel.executor.ExecutorTrials`` — same loop on the thread-pool path.
* ``filestore.FileStore.reserve`` — a micro-scale instance damps the
  claim-contention storm (many workers racing ``os.rename`` on the same
  NEW docs).

Jitter is DETERMINISTIC in ``(key, attempt)`` — seeded ``random.Random``,
not global randomness — so tests replay exact schedules and two workers
retrying the same trial still spread out (their keys differ by owner).
Delays are wall-clock sleeps; *deadlines* elsewhere use the monotonic
clock (see ``executor._cancel_timed_out``) — backoff cares about duration,
deadlines must survive NTP steps.
"""

from __future__ import annotations

import dataclasses
import os
import random

__all__ = ["RetryPolicy"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``max_retries`` EXTRA attempts after the first (0 = never retry);
    delay before retry ``i`` (0-based) is ``base_delay * 2**i`` capped at
    ``max_delay``, scaled by a deterministic jitter draw into
    ``[(1 - jitter) * d, d]`` (decorrelated "full jitter downward": the
    cap is the worst case, never exceeded)."""

    max_retries: int = 0
    base_delay: float = 0.5
    max_delay: float = 30.0
    jitter: float = 0.5

    def delay(self, attempt, key=0):
        """Backoff before retry number ``attempt`` (0-based), jittered
        deterministically in ``(key, attempt)``."""
        d = min(self.base_delay * (2.0 ** max(0, int(attempt))),
                self.max_delay)
        if not self.jitter:
            return d
        rng = random.Random(f"{key}:{attempt}")
        return d * (1.0 - self.jitter * rng.random())

    def delay_after(self, attempt, key=0, floor=0.0):
        """Backoff before retry ``attempt`` honoring a server hint:
        the jittered exponential delay, raised to ``floor`` when the
        server's ``Retry-After`` asks the client to stay away longer
        (the ask/tell service computes it from live wave latency —
        overriding it downward would re-create the stampede the hint
        exists to spread)."""
        return max(float(floor), self.delay(attempt, key=key))

    def retries_left(self, attempts):
        """True while a trial that has already made ``attempts`` attempts
        may run again (``attempts`` counts the first try)."""
        return attempts <= self.max_retries

    @classmethod
    def coerce(cls, v):
        """``None`` → no-retry policy, an int → that many retries with
        defaults, a policy → itself (the knob every constructor takes)."""
        if v is None:
            return cls(0)
        if isinstance(v, cls):
            return v
        if isinstance(v, int):
            return cls(max_retries=v)
        raise TypeError(f"retry must be None, an int, or RetryPolicy; got {v!r}")

    @classmethod
    def from_env(cls, env=None):
        """``HYPEROPT_TPU_TRIAL_RETRIES=<n>[:<base_delay>]`` → policy (the
        worker-CLI default); unset/invalid → no retries (warn-free: a
        missing knob is the common case, a malformed one falls back to the
        safe default)."""
        env = os.environ if env is None else env
        raw = env.get("HYPEROPT_TPU_TRIAL_RETRIES", "").strip()
        if not raw:
            return cls(0)
        n_s, _, base_s = raw.partition(":")
        try:
            n = int(n_s)
            base = float(base_s) if base_s else 0.5
            if n < 0 or base <= 0:
                raise ValueError
        except ValueError:
            return cls(0)
        return cls(max_retries=n, base_delay=base)
