"""Chrome / Perfetto trace-event export for obs JSONL streams (counterpart
of ``hyperopt_tpu/obs/export.py``; the device captures it merges are
``torch.profiler`` chrome traces).

The ASCII report (``obs.report``) answers "where did the time go" in
aggregate; a trace viewer answers it *visually*, span by span, across
threads and controllers.  This module converts any obs JSONL stream —
including the merged per-controller streams one ``fmin_multihost`` run
writes — into the Trace Event Format every Chrome-lineage viewer loads
(``chrome://tracing``, https://ui.perfetto.dev)::

    python -m hyperopt_tpu_torch.obs.report --export-trace run.trace.json run.jsonl
    python -m hyperopt_tpu_torch.obs.report --export-trace mh.trace.json \
        run.p0.jsonl run.p1.jsonl        # controllers as track groups

Mapping (one ``pid`` per input stream — Perfetto renders each as its own
process track group, named after the stream):

* ``kind="span"``   → complete ``X`` events (start ``ts``, ``dur``), one
  ``tid`` track per recording thread (span records carry ``thread``);
  depth/nesting is recovered by the viewer from containment.
* ``kind="event"``  → instant ``i`` events on the emitting track.
* ``kind="trial_event"`` → instant events on a dedicated ``trials`` track
  (the lifecycle waterfall as a timeline).
* ``kind="stall"`` / ``"flight_dump"`` / ``"open_span"`` → instant events
  on a ``forensics`` track, stacks and heartbeats in ``args``.
* ``kind="health"`` → ``C`` counter tracks (``ei_p50``, ``dup_rate``) so
  search health plots right under the span timeline.
* ``kind="profile"`` → instant events on the ``forensics`` track (the
  postmortem pointer to a device capture), and the capture's own
  ``*.trace.json.gz`` artifact merges in as additional *device* process
  track groups (see below).
* metric snapshots → ``C`` counter points for the per-program roofline
  (``roofline.<program>`` achieved rate, joining the recorded cost
  gauges with the measured execute spans) at the snapshot's timestamp;
  everything else in a snapshot stays an end-of-run aggregate and is
  skipped.

**Device captures.**  A ``torch.profiler`` capture (obs/profiler.py)
writes a chrome trace whose timestamps are microseconds after its
``baseTimeNanoseconds`` epoch, with the process id and the card's index
as pids and CUDA streams as tids.  :func:`device_trace_events` folds one
such artifact into the merged export: pids are remapped into a reserved
range (1000+) so they can never collide with the host streams, process
names get a ``device:`` prefix, non-integer tids get integer ones, and
every timestamp is shifted by the trace's own epoch (or, lacking one, by
the capture's recorded wall-clock start) so host spans and device
kernels align on one timeline.  ``obs.report --export-trace`` does this automatically for
every ``kind="profile"`` record whose artifact still exists.

Events are emitted sorted by ``(pid, tid, ts)`` with metadata (``M``)
records first — the invariant ``scripts/validate_trace.py`` checks.

All ``ts``/``dur`` are microseconds (the trace-event unit); absolute epoch
timestamps are kept, which viewers handle fine and which lets merged
controller streams align on real time.
"""

from __future__ import annotations

import gzip
import json

__all__ = ["to_trace_events", "export_trace", "write_trace",
           "device_trace_events", "flow_events"]

#: device-capture track groups are remapped to pids >= this, far above any
#: realistic host-stream count, so the two namespaces can never collide
DEVICE_PID_BASE = 1000

# reserved per-stream tids; real recording threads allocate upward from 10
_TID_MAIN = 0
_TID_TRIALS = 1
_TID_FORENSICS = 2
_TID_COUNTERS = 3

_COUNTER_STATS = ("ei_p50", "dup_rate")


def _us(ts):
    return float(ts) * 1e6


class _Tids:
    """Stable thread-name → tid allocation for one stream."""

    def __init__(self):
        self._by_name = {"MainThread": _TID_MAIN}
        self._next = 10

    def get(self, name):
        tid = self._by_name.get(name)
        if tid is None:
            tid = self._by_name[name] = self._next
            self._next += 1
        return tid

    def items(self):
        return sorted(self._by_name.items(), key=lambda kv: kv[1])


def to_trace_events(records, pid=0, name=None):
    """Convert one stream's records into trace events (unsorted; callers
    go through :func:`export_trace`, which sorts and adds nothing else)."""
    tids = _Tids()
    events = []
    used_tracks = set()

    def instant(tid, ev_name, ts, cat, args=None):
        e = {"name": ev_name, "ph": "i", "ts": _us(ts), "pid": pid,
             "tid": tid, "cat": cat, "s": "t"}
        if args:
            e["args"] = args
        used_tracks.add(tid)
        events.append(e)

    for r in records:
        kind = r.get("kind")
        ts = r.get("ts")
        if ts is None:
            continue
        if kind == "span":
            tid = tids.get(r.get("thread", "MainThread"))
            used_tracks.add(tid)
            args = dict(r.get("attrs") or {})
            for k in ("cpu_sec", "span_id", "parent_id", "run_id", "error"):
                if r.get(k) is not None:
                    args[k] = r[k]
            events.append({
                "name": r.get("name", "?"), "ph": "X", "ts": _us(ts),
                "dur": max(0.0, float(r.get("wall_sec", 0.0))) * 1e6,
                "pid": pid, "tid": tid, "cat": "span",
                "args": args,
            })
        elif kind == "event":
            instant(tids.get(r.get("thread", "MainThread")),
                    r.get("name", "event"), ts, "event",
                    r.get("attrs") or None)
            # quality improvements also plot as a best-loss
            # counter track per study: the convergence curve rendered
            # right under the serving spans that produced it
            if r.get("name") == "quality.improvement":
                attrs = r.get("attrs") or {}
                best = attrs.get("best")
                sid = attrs.get("study")
                if best is not None and sid is not None:
                    used_tracks.add(_TID_COUNTERS)
                    events.append({
                        "name": f"best_loss.{sid}", "ph": "C",
                        "ts": _us(ts), "pid": pid,
                        "tid": _TID_COUNTERS, "cat": "quality",
                        "args": {"best_loss": float(best)},
                    })
        elif kind == "trial_event":
            instant(_TID_TRIALS,
                    f"{r.get('event', '?')} tid={r.get('tid')}", ts, "trial",
                    {k: v for k, v in r.items()
                     if k not in ("kind", "ts")} or None)
        elif kind == "stall":
            instant(_TID_FORENSICS, "stall", ts, "forensics",
                    {"quiet_for_sec": r.get("quiet_for_sec"),
                     "last_heartbeats": r.get("last_heartbeats"),
                     "stacks": r.get("stacks")})
        elif kind == "flight_dump":
            instant(_TID_FORENSICS, f"flight_dump:{r.get('reason', '?')}",
                    ts, "forensics", {"pid": r.get("pid"),
                                      "n_records": r.get("n_records")})
        elif kind == "open_span":
            instant(_TID_FORENSICS, f"open:{r.get('name', '?')}", ts,
                    "forensics", {"age_sec": r.get("age_sec"),
                                  "thread": r.get("thread")})
        elif kind == "health":
            for stat in _COUNTER_STATS:
                v = r.get(stat)
                if v is not None:
                    used_tracks.add(_TID_COUNTERS)
                    events.append({
                        "name": stat, "ph": "C", "ts": _us(ts), "pid": pid,
                        "tid": _TID_COUNTERS, "cat": "health",
                        "args": {stat: float(v)},
                    })
        elif kind == "profile":
            instant(_TID_FORENSICS, f"profile:{r.get('reason', '?')}", ts,
                    "forensics", {"ok": r.get("ok"), "dir": r.get("dir"),
                                  "trace_json": r.get("trace_json"),
                                  "sec": r.get("sec")})
        elif kind == "metrics":
            # per-program roofline counters: one point per embedded
            # snapshot (a multi-run() stream plots a real series).  The
            # join itself lives in health.roofline_table — the single
            # formula behind /snapshot, obs.report and these counters.
            from .health import roofline_table

            dev = (((r.get("snapshot") or {}).get("shared") or {})
                   .get("device") or {}).get("metrics", {})
            for st, row in roofline_table(dev).items():
                flops_per_sec = row.get("achieved_flops_per_sec")
                if flops_per_sec is None:
                    continue  # cost captured but no execute spans yet
                used_tracks.add(_TID_COUNTERS)
                events.append({
                    "name": f"roofline.{st}", "ph": "C", "ts": _us(ts),
                    "pid": pid, "tid": _TID_COUNTERS, "cat": "roofline",
                    "args": {"gflops": flops_per_sec / 1e9},
                })
            # per-shard heat counter tracks: cumulative
            # shard heat plotted under the serving spans — from the
            # service.load.shard.* gauges (flat metric snapshots and
            # /snapshot-shaped `sections.service` embeds) or the
            # snapshot's own `load.shards` table
            snap = r.get("snapshot") or {}
            heats = {}
            for src in (snap.get("metrics") or {},
                        (snap.get("sections") or {}).get("service") or {}):
                for mname, v in src.items():
                    if (mname.startswith("service.load.shard.")
                            and mname.endswith(".heat_ms")
                            and isinstance(v, (int, float))):
                        shard = mname[len("service.load.shard."):
                                      -len(".heat_ms")]
                        heats[shard] = float(v)
            shards_tbl = (snap.get("load") or {}).get("shards") or {}
            for shard, row in shards_tbl.items():
                if isinstance(row, dict) and row.get("heat_ms") is not None:
                    heats.setdefault(str(shard), float(row["heat_ms"]))
            for shard, v in sorted(heats.items()):
                used_tracks.add(_TID_COUNTERS)
                events.append({
                    "name": f"heat.shard{shard}", "ph": "C",
                    "ts": _us(ts), "pid": pid, "tid": _TID_COUNTERS,
                    "cat": "load", "args": {"heat_ms": v},
                })
            # per-tenant counter tracks: each tenant's
            # cumulative device time plotted alongside the shard heat —
            # from the service.tenant.<t>.device_ms gauges or the
            # snapshot's own `tenants.table`
            ten_ms = {}
            for src in (snap.get("metrics") or {},
                        (snap.get("sections") or {}).get("service") or {}):
                for mname, v in src.items():
                    if (mname.startswith("service.tenant.")
                            and mname.endswith(".device_ms")
                            and isinstance(v, (int, float))):
                        t = mname[len("service.tenant."):
                                  -len(".device_ms")]
                        ten_ms[t] = float(v)
            ten_tbl = (snap.get("tenants") or {}).get("table") or {}
            for t, row in ten_tbl.items():
                if isinstance(row, dict) and row.get("device_ms") is not None:
                    ten_ms.setdefault(str(t), float(row["device_ms"]))
            for t, v in sorted(ten_ms.items()):
                used_tracks.add(_TID_COUNTERS)
                events.append({
                    "name": f"tenant.{t}", "ph": "C",
                    "ts": _us(ts), "pid": pid, "tid": _TID_COUNTERS,
                    "cat": "tenant", "args": {"device_ms": v},
                })

    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": name or f"stream-{pid}"}}]
    reserved = {_TID_TRIALS: "trials", _TID_FORENSICS: "forensics",
                _TID_COUNTERS: "health"}
    for tname, tid in tids.items():
        if tid in used_tracks:
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
    for tid, tname in reserved.items():
        if tid in used_tracks:
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
    return meta + events


_DEVICE_PH_KEEP = {"X", "i", "I", "C", "M"}


def device_trace_events(path, pid_base, name=None, epoch_offset_sec=None):
    """One capture artifact (``*.trace.json.gz`` or plain ``.json``) →
    ``(events, n_pids)`` ready to merge into the host export.

    * original pids remap densely onto ``pid_base + i`` (the reserved
      device range — host streams can never collide); a non-integer tid
      maps to an integer one per pid;
    * ``process_name`` metadata gets a ``device:<capture name>:`` prefix,
      and any pid the capture left unnamed gets one synthesized;
    * timestamps shift to absolute epoch microseconds: by the trace's
      ``baseTimeNanoseconds`` when it carries one (``torch.profiler``),
      else by ``epoch_offset_sec`` (the capture's recorded start);
      negative timestamps clamp to the capture start;
    * only viewer-meaningful phases survive (``X i I C M``); ``X`` events
      missing a duration get ``dur=0``.
    """
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    raw = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(raw, list):
        return [], 0
    base_ns = data.get("baseTimeNanoseconds") if isinstance(data, dict) else None
    if isinstance(base_ns, (int, float)) and base_ns > 0:
        off_us = float(base_ns) / 1e3
    else:
        off_us = float(epoch_offset_sec) * 1e6 if epoch_offset_sec else 0.0
    pid_map = {}
    tid_map = {}
    named = set()
    meta, events = [], []

    def int_tid(pid, tid):
        if isinstance(tid, int):
            return tid
        key = (pid, str(tid))
        got = tid_map.get(key)
        if got is None:
            got = tid_map[key] = 1_000_000 + len(tid_map)
        return got

    for e in raw:
        if not isinstance(e, dict) or e.get("ph") not in _DEVICE_PH_KEEP:
            continue
        orig_pid = e.get("pid")
        if not isinstance(orig_pid, int):
            continue
        pid = pid_map.setdefault(orig_pid, pid_base + len(pid_map))
        if e["ph"] == "M":
            m = dict(e)
            m["pid"] = pid
            m["tid"] = int_tid(pid, m.get("tid", 0))
            m.pop("ts", None)
            if m.get("name") == "process_name":
                orig = (m.get("args") or {}).get("name", orig_pid)
                m["args"] = {"name": f"device:{name or 'capture'}:{orig}"}
                named.add(pid)
            meta.append(m)
            continue
        ts = e.get("ts")
        tid = e.get("tid")
        if not isinstance(ts, (int, float)) or tid is None:
            continue
        out = dict(e)
        out["pid"] = pid
        out["tid"] = int_tid(pid, tid)
        out["ts"] = max(0.0, float(ts)) + off_us
        if e["ph"] == "X" and not isinstance(e.get("dur"), (int, float)):
            out["dur"] = 0.0
        events.append(out)
    for orig_pid, pid in pid_map.items():
        if pid not in named:
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0,
                         "args": {"name": f"device:{name or 'capture'}:"
                                          f"{orig_pid}"}})
    return meta + events, len(pid_map)


def _flow_id(trace_id):
    """Stable integer flow id from a trace id's leading hex (60 bits —
    comfortably inside the signed-64 range viewers assume)."""
    return int(str(trace_id)[:15] or "0", 16)


def flow_events(events):
    """Request-trace flow events: every ``X`` span stamped
    with a ``trace`` attr (or ``links`` list — the wave span's fan-in)
    joins that trace's flow.  One flow per trace id, rendered by
    Perfetto as a connected arc across pid track groups: client attempt
    → server handler → wave → cohort tick.

    Chrome flow-event grammar: ``s`` (start) on the first slice, ``t``
    (step) on each middle one, ``f`` (finish, ``bp: "e"``) on the last —
    each bound to its slice by (pid, tid) and a ``ts`` inside the
    slice.  Flows with fewer than two slices are dropped (nothing to
    connect).  ``scripts/validate_trace.py`` lints exactly these
    invariants (no dangling ids, binding slices exist)."""
    by_trace = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        hits = set()
        t = args.get("trace")
        if isinstance(t, str) and t:
            hits.add(t)
        links = args.get("links")
        if isinstance(links, list):
            hits.update(x for x in links if isinstance(x, str) and x)
        for t in hits:
            by_trace.setdefault(t, []).append(e)
    flows = []
    for t, slices in sorted(by_trace.items()):
        if len(slices) < 2:
            continue  # a single-hop flow draws no arc
        slices.sort(key=lambda e: e["ts"])
        try:
            fid = _flow_id(t)
        except ValueError:
            # a foreign producer's non-hex trace attr must not kill the
            # whole export (the torn-line/fail-open posture); its spans
            # still render, only the connecting arc is skipped
            continue
        for i, e in enumerate(slices):
            ph = "s" if i == 0 else ("f" if i == len(slices) - 1 else "t")
            f = {"name": "reqtrace", "cat": "reqtrace", "ph": ph,
                 "id": fid, "ts": e["ts"], "pid": e["pid"],
                 "tid": e["tid"], "args": {"trace": t}}
            if ph == "f":
                f["bp"] = "e"  # bind to the ENCLOSING slice, not the next
            flows.append(f)
    return flows


def export_trace(streams, device_traces=()):
    """``[(name, records-iterable)]`` → a trace-event JSON object.  Each
    stream becomes its own ``pid`` track group (the multi-controller merge
    view); ``device_traces`` — ``[(name, artifact path, epoch t0), ...]``
    from ``kind="profile"`` records — merge in as device track groups in
    the reserved pid range.  Spans carrying request-trace ids
    additionally emit flow events (:func:`flow_events`) so one trace
    renders as a connected client→handler→wave→device arc.  Events are
    sorted ``(pid, tid, ts)``, metadata first — the layout
    ``scripts/validate_trace.py`` pins."""
    meta, events = [], []
    for pid, (name, records) in enumerate(streams):
        for e in to_trace_events(records, pid=pid, name=name):
            (meta if e["ph"] == "M" else events).append(e)
    events.extend(flow_events(events))
    pid_base = DEVICE_PID_BASE
    for name, path, t0 in device_traces:
        try:
            merged, n_pids = device_trace_events(
                path, pid_base, name=name, epoch_offset_sec=t0)
        except (OSError, ValueError) as e:
            # a vanished/corrupt capture artifact degrades to a skipped
            # track group, never a failed export of the host spans
            import logging

            logging.getLogger(__name__).warning(
                "skipping device capture %s: %s", path, e)
            continue
        pid_base += n_pids
        for e in merged:
            (meta if e["ph"] == "M" else events).append(e)
    events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_trace(path, streams, device_traces=()):
    """Export ``streams`` (+ any device captures) and write the trace JSON
    to ``path``; returns the event count."""
    trace = export_trace(streams, device_traces=device_traces)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
