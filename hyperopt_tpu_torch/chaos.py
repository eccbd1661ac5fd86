"""Deterministic fault-injection plane (counterpart of
``hyperopt_tpu/chaos.py``, copied: host-only).  The port has the sites
of the trial backends (``trial``, ``io``) and of the service plane
(``admit``, ``ask``, ``tell``, ``tick``, ``wal``).  An injected I/O
error is an :class:`InjectedFault`, an ``OSError`` the degrade ladder
can tell from a real one.

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
    corrupt@<site>:<p>      flip ONE seeded bit in the just-written record
                            with probability p (``corrupt_bytes`` sites —
                            the WAL append; the write SUCCEEDS, the medium
                            lies: what the checksum/quarantine plane must
                            catch at the next replay or scrub), or perturb
                            read-back proposals (``corrupt_floats``, the
                            ``tick`` site)

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
           "point", "io_point", "corrupt_bytes", "corrupt_floats", "InjectedFault"]

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


class InjectedFault(OSError):
    """An I/O error the plan injected (``ioerr``/``enospc`` rules at an
    :func:`io_point`).  An ``OSError`` like the JAX package's, so every
    store handler treats it as one; typed so the service's degrade
    ladder absorbs an injected ``tick`` fault and nothing else."""


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
        # payload, not control flow — corrupt_bytes() owns them (its own
        # hit counter, so mixed rules at one site stay deterministic)
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


    def mutate_rule(self, site):
        """The corrupt rule due at this ``corrupt_bytes`` hit, or None.
        Separate hit counter (``<site>!corrupt``): the mutate probe runs
        on a different cadence than point()/io_point() at the same
        site, and sharing one counter would skew both schedules."""
        matched = [r for r in self.rules
                   if r.site == site and r.action == "corrupt"]
        if not matched:
            return None
        key = f"{site}!corrupt"
        n = self.hits.get(key, 0) + 1
        self.hits[key] = n
        for r in matched:
            if r.fires(n):
                return r
        return None


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


def reset():
    """Forget any explicit configuration; the next use re-reads the env."""
    global _plan, _warned
    _plan = _UNSET
    _warned = False


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
            raise InjectedFault(f"chaos: injected I/O error at {site}")
        elif name == "enospc":
            import errno

            logger.warning("chaos: injected ENOSPC at %s", site)
            raise InjectedFault(errno.ENOSPC,
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


def corrupt_bytes(site, data, metrics=None):
    """A payload-mutation chaos site: when a ``corrupt`` rule
    is due, flip ONE seeded bit in ``data`` (never the trailing
    newline — the line framing must survive so the corruption lands
    MID-file, the case the torn-tail reader cannot excuse) and return
    the mutated copy; otherwise ``data`` unchanged.  Disarmed cost: one
    attribute check.  Deterministic: the flip position draws from the
    rule's own seeded stream, one draw per fired hit."""
    plan = _plan if _plan is not _UNSET else get_plan()
    if plan is None:
        return data
    rule = plan.mutate_rule(site)
    if rule is None:
        return data
    n = len(data) - (1 if data.endswith(b"\n") else 0)
    if n <= 0:
        return data
    pos = rule.rng.randrange(n * 8)
    out = bytearray(data)
    out[pos // 8] ^= 1 << (pos % 8)
    if metrics is not None:
        metrics.counter(f"chaos.corrupt.{site}").inc()
    try:
        from .obs.flight import get_flight

        get_flight().record({"kind": "chaos", "ts": time.time(),
                             "action": "corrupt", "site": site,
                             "bit": pos, "pid": os.getpid()})
    except Exception:
        pass
    logger.warning("chaos: flipped bit %d in a %s record", pos, site)
    return bytes(out)


def corrupt_floats(site, arr, metrics=None):
    """A proposal-mutation chaos site: when a ``corrupt``
    rule is due, perturb ONE seeded element per row of the float array
    ``arr`` (a copy — device buffers are never mutated) and return it;
    otherwise ``arr`` unchanged.  The perturbation is finite, small and
    SILENT — no flag, no exception, values still in-range-ish — i.e.
    exactly the wrong-answer class that slips past the non-finite guard
    and every checksum, and that only the blackbox prober's golden
    stream digest can catch.  Per-ROW so every study slot served by a
    corrupted tick is affected (a single global flip could land in
    masked padding and detect as nothing).  Disarmed cost: one
    attribute check.  Deterministic: positions draw from the rule's own
    seeded stream, one draw per row per fired hit."""
    plan = _plan if _plan is not _UNSET else get_plan()
    if plan is None:
        return arr
    rule = plan.mutate_rule(site)
    if rule is None:
        return arr
    import numpy as _np

    out = _np.array(arr, copy=True)
    flat = out.reshape(-1) if out.ndim <= 1 \
        else out.reshape(out.shape[0], -1)
    rows = flat.reshape(1, -1) if flat.ndim == 1 else flat
    if rows.shape[-1] == 0:
        return arr
    for i in range(rows.shape[0]):
        j = rule.rng.randrange(rows.shape[-1])
        rows[i, j] = rows[i, j] * 1.03125 + 0.03125
    if metrics is not None:
        metrics.counter(f"chaos.corrupt.{site}").inc()
    try:
        from .obs.flight import get_flight

        get_flight().record({"kind": "chaos", "ts": time.time(),
                             "action": "corrupt", "site": site,
                             "rows": int(rows.shape[0]),
                             "pid": os.getpid()})
    except Exception:
        pass
    logger.warning("chaos: silently perturbed %d proposal row(s) at %s",
                   int(rows.shape[0]), site)
    return out
