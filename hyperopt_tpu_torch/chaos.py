"""Deterministic fault-injection plane (counterpart of
``hyperopt_tpu/chaos.py``, copied: host-only).  The port has the sites
of the trial backends (``trial``, ``io``); the service and multi-device
sites come with those planes.

The repo's reliability story — leased work shards (``parallel/membership``),
retry/backoff (``retry.py``), stale reclaim (``filestore.py``) — is only
trustworthy if failure paths are *exercised on purpose*.  This module turns
selected code sites into seeded failure points, armed by one environment
variable::

    HYPEROPT_TPU_CHAOS="<seed>:<rule>[;<rule>...]"

Rule grammar (whitespace-free; a malformed spec WARNS ONCE and disarms —
the same fail-open convention as every observability env var)::

    kill@<site>:<n>         SIGKILL this process on the n-th hit of <site>
    term@<site>:<n>         SIGTERM on the n-th hit (flight recorder dumps)
    ioerr@<site>:<p>        raise OSError with probability p per hit
    stall@<site>:<p>:<sec>  sleep <sec> seconds with probability p per hit
    enospc@<site>:<p>       raise OSError(ENOSPC) with probability p per
                            hit (io sites only — the disk-full analog of
                            ioerr)
    corrupt@<site>:<p>      flip ONE seeded bit in a written record with
                            probability p: parsed here as in the JAX
                            package, fired only by the payload sites of
                            the service and prober planes, not ported yet

Sites are plain strings named by the instrumented call sites:

==============  ============================================================
``gen``         driver generation start (collective AND fleet loops)
``allgather``   before each cross-controller collective (driver.py)
``checkpoint``  before the checkpoint file write (driver/fleet)
``claim``       before a fleet shard-lease claim (parallel/fleet.py)
``publish``     before a fleet shard-result publish (parallel/fleet.py)
``trial``       before each objective evaluation (worker.py / fleet eval)
``io``          inside ``filestore._atomic_write`` (``ioerr`` rules only)
``admit``       service study admission (service/scheduler.create_study)
``ask``         service ask ingress (service/scheduler.ask)
``tell``        service tell ingress (service/scheduler.tell)
``wal``         service journal append/compact (``ioerr`` raises as a
                JournalError — the failed request errors, state holds)
``tick``        before each cohort-tick device dispatch (``ioerr`` here is
                the OOM-shaped fault the degrade ladder absorbs; ``kill``
                is the mid-wave crash the WAL resume gate exercises)
==============  ============================================================

Determinism: every probabilistic rule owns a ``random.Random`` seeded from
``(seed, rule text)`` and advances it once per hit, and count-triggered
rules fire on exact hit counts — two runs of the same program under the
same spec inject identically.  **Disarmed runs are bit-identical and start
no threads**: the module keeps no state beyond a ``None`` plan, draws no
random numbers, and every ``point()`` call is a single attribute check
(the invariant every obs plane in this repo pins by test).

Kills are synchronous ``os.kill(os.getpid(), ...)`` at the site — SIGTERM
walks the flight recorder's handler chain (the dump lands in the store's
attachments when ``FileStore.arm_flight`` armed it), SIGKILL is the
unsurvivable spot-preemption analog.  Injections are counted in the
metrics registry the call site passes (so they land in the run's snapshot
and the ``obs.report`` fleet/chaos section) and recorded in the flight
ring, so a killed process's dump names the injection that killed it.
"""

from __future__ import annotations

import logging
import os
import random
import signal
import time

__all__ = ["ChaosPlan", "parse_spec", "get_plan", "configure", "armed",
           "point", "io_point"]

logger = logging.getLogger(__name__)

_ACTIONS = ("kill", "term", "ioerr", "stall", "enospc", "corrupt")

_UNSET = object()
_plan = _UNSET  # lazily resolved from the environment on first use

_warned = False


def _warn_once(raw, why):
    global _warned
    if not _warned:
        _warned = True
        logger.warning("HYPEROPT_TPU_CHAOS=%r is not %s; disarming (chaos "
                       "spec errors warn-and-disable, never raise)", raw, why)


class _Rule:
    __slots__ = ("action", "site", "count", "prob", "sec", "rng", "text")

    def __init__(self, action, site, count=None, prob=None, sec=None,
                 seed=0, text=""):
        self.action = action
        self.site = site
        self.count = count
        self.prob = prob
        self.sec = sec
        self.text = text
        # per-rule generator: deterministic in (seed, rule text), advanced
        # once per hit — schedules replay exactly across runs
        self.rng = random.Random(f"{seed}:{text}")

    def fires(self, hits):
        """Decide for hit number ``hits`` (1-based).  Probabilistic rules
        draw exactly one number per hit, fired or not."""
        if self.count is not None:
            return hits == self.count
        return self.rng.random() < self.prob


class ChaosPlan:
    """A parsed, armed schedule: rules + per-site hit counters."""

    def __init__(self, seed, rules):
        self.seed = seed
        self.rules = rules
        self.hits = {}

    def check(self, site, io=False):
        """Advance ``site``'s hit counter and return the actions due at
        this hit: ``[("kill",), ("term",), ("ioerr",), ("stall", sec)]``.
        ``io=True`` sites additionally evaluate ``ioerr`` rules; plain
        sites never do (an OSError can only escape where the caller
        expects filesystem failure)."""
        due = []
        # corrupt rules never fire at point()/io_point(): they mutate a
        # payload, not control flow (the payload sites keep their own hit
        # counter, so mixed rules at one site stay deterministic)
        matched = [r for r in self.rules
                   if r.site == site and r.action != "corrupt"]
        if not matched:
            return due
        n = self.hits.get(site, 0) + 1
        self.hits[site] = n
        for r in matched:
            if r.action in ("ioerr", "enospc") and not io:
                continue
            if r.fires(n):
                due.append((r.action,) if r.sec is None else (r.action, r.sec))
        return due


def parse_spec(raw):
    """``"<seed>:<rule>[;<rule>...]"`` → :class:`ChaosPlan`, or None when
    empty/disabled/malformed (warn-and-disable)."""
    raw = (raw or "").strip()
    if raw.lower() in ("", "0", "off", "false", "no"):
        return None
    seed_s, sep, body = raw.partition(":")
    if not sep or not body.strip():
        _warn_once(raw, "of the form <seed>:<rule>[;<rule>...]")
        return None
    try:
        seed = int(seed_s)
    except ValueError:
        _warn_once(raw, "led by an integer seed")
        return None
    rules = []
    for part in body.split(";"):
        part = part.strip()
        if not part:
            continue
        action, sep, rest = part.partition("@")
        if action not in _ACTIONS or not sep:
            _warn_once(raw, f"using actions {_ACTIONS} as <action>@<site>")
            return None
        bits = rest.split(":")
        site = bits[0]
        args = bits[1:]
        try:
            if action in ("kill", "term"):
                if len(args) != 1:
                    raise ValueError
                rules.append(_Rule(action, site, count=int(args[0]),
                                   seed=seed, text=part))
            elif action in ("ioerr", "enospc", "corrupt"):
                if len(args) != 1:
                    raise ValueError
                rules.append(_Rule(action, site, prob=float(args[0]),
                                   seed=seed, text=part))
            else:  # stall
                if len(args) != 2:
                    raise ValueError
                rules.append(_Rule(action, site, prob=float(args[0]),
                                   sec=float(args[1]), seed=seed, text=part))
        except ValueError:
            _warn_once(raw, f"well-formed in rule {part!r}")
            return None
    if not rules:
        _warn_once(raw, "carrying at least one rule")
        return None
    return ChaosPlan(seed, rules)


def get_plan():
    """The process's armed plan (lazy env resolution), or None."""
    global _plan
    if _plan is _UNSET:
        _plan = parse_spec(os.environ.get("HYPEROPT_TPU_CHAOS", ""))
        if _plan is not None:
            logger.warning("CHAOS ARMED: %s",
                           "; ".join(r.text for r in _plan.rules))
    return _plan


def configure(spec=None):
    """Explicitly (re)arm — tests use this instead of the environment.
    ``None`` disarms; a spec string parses as the env var would; a
    :class:`ChaosPlan` installs directly.  Returns the active plan."""
    global _plan, _warned
    _warned = False
    if spec is None or isinstance(spec, ChaosPlan):
        _plan = spec
    else:
        _plan = parse_spec(spec)
    return _plan


def armed():
    return get_plan() is not None


def _execute(site, actions, metrics):
    for act in actions:
        name = act[0]
        if metrics is not None:
            metrics.counter(f"chaos.{name}.{site}").inc()
        # the flight ring survives a SIGTERM (the dump names the injection
        # that killed the process) — recorded BEFORE the action executes
        try:
            from .obs.flight import get_flight

            get_flight().record({"kind": "chaos", "ts": time.time(),
                                 "action": name, "site": site,
                                 "pid": os.getpid()})
        except Exception:
            pass
        if name == "kill":
            logger.warning("chaos: SIGKILL at %s", site)
            os.kill(os.getpid(), signal.SIGKILL)
        elif name == "term":
            logger.warning("chaos: SIGTERM at %s", site)
            os.kill(os.getpid(), signal.SIGTERM)
        elif name == "stall":
            logger.warning("chaos: stalling %.3fs at %s", act[1], site)
            time.sleep(act[1])
        elif name == "ioerr":
            logger.warning("chaos: injected I/O error at %s", site)
            raise OSError(f"chaos: injected I/O error at {site}")
        elif name == "enospc":
            import errno

            logger.warning("chaos: injected ENOSPC at %s", site)
            raise OSError(errno.ENOSPC,
                          f"chaos: injected ENOSPC at {site}")


def point(site, metrics=None):
    """A plain chaos site.  Disarmed cost: one attribute check + one
    ``is None``.  Never raises (``ioerr`` rules are ignored here — see
    :func:`io_point`)."""
    plan = _plan if _plan is not _UNSET else get_plan()
    if plan is None:
        return
    _execute(site, plan.check(site, io=False), metrics)


def io_point(site="io", metrics=None):
    """A filesystem chaos site: like :func:`point`, but ``ioerr`` and
    ``enospc`` rules RAISE ``OSError`` here — callers are the store
    paths whose error handling the chaos gate exists to exercise."""
    plan = _plan if _plan is not _UNSET else get_plan()
    if plan is None:
        return
    _execute(site, plan.check(site, io=True), metrics)
