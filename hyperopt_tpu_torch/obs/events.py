"""Trial-lifecycle event log (counterpart of ``hyperopt_tpu/obs/events.py``,
copied: host-only; records are the reference's, line for line).

Third pillar of the run-telemetry layer: an append-only record of every
state transition a trial goes through — ``trial_new`` / ``trial_claimed`` /
``trial_heartbeat`` / ``trial_finished`` / ``trial_cancelled`` /
``trial_reclaimed`` — so a post-mortem can reconstruct *why* a run behaved
the way it did (which worker claimed what, where time was lost between
queue and claim, which trials were reclaimed from dead workers) without the
process that produced it.

Two persistence modes:

* in-memory bounded ring (``EventLog()``) — the in-process backends
  (``ExecutorTrials``, the host loop);
* durable append file (``EventLog(sink=FileEventSink(path))``) — the
  ``FileStore`` wires this to ``attachments/obs_events.jsonl`` inside the
  store directory, so the log survives driver AND worker death and is
  shared by every process on the store (O_APPEND line writes are atomic
  for line-sized records on POSIX).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque

from .flight import get_flight

__all__ = [
    "TRIAL_NEW",
    "TRIAL_CLAIMED",
    "TRIAL_HEARTBEAT",
    "TRIAL_FINISHED",
    "TRIAL_CANCELLED",
    "TRIAL_RECLAIMED",
    "EventLog",
    "FileEventSink",
    "load_events",
]

TRIAL_NEW = "trial_new"
TRIAL_CLAIMED = "trial_claimed"
TRIAL_HEARTBEAT = "trial_heartbeat"
TRIAL_FINISHED = "trial_finished"
TRIAL_CANCELLED = "trial_cancelled"
TRIAL_RECLAIMED = "trial_reclaimed"


class FileEventSink:
    """Durable append-only event sink.

    Deliberately holds NO file handle: each record is one ``O_APPEND``
    write of one line, so concurrent writers (driver + N worker processes)
    interleave whole lines, and the sink pickles freely inside a Trials
    backend checkpoint.
    """

    def __init__(self, path):
        self.path = str(path)

    def write(self, record: dict):
        line = (json.dumps(record, default=str) + "\n").encode()
        fd = os.open(self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)


class EventLog:
    """Emit + remember trial lifecycle events.

    ``emit`` must never raise into the store/driver hot path — a telemetry
    failure (full disk, revoked mount) degrades to the in-memory ring.
    """

    def __init__(self, sink=None, keep=4096):
        self.sink = sink
        self._ring = deque(maxlen=keep)

    def emit(self, event, tid, **attrs):
        rec = {"kind": "trial_event", "event": event, "tid": tid,
               "ts": time.time()}
        if attrs:
            rec.update(attrs)
        self._ring.append(rec)
        # the flight ring too: a crash dump reconstructs in-flight trials
        # (claimed-but-never-finished) from exactly these records
        get_flight().record(rec)
        if self.sink is not None:
            try:
                self.sink.write(rec)
            except OSError:
                pass
        return rec

    def records(self):
        """The in-memory ring (most recent ``keep`` events)."""
        return list(self._ring)

    def by_event(self, event):
        return [r for r in self._ring if r["event"] == event]


def load_events(path):
    """Read a durable event file back (tolerates a torn final line from a
    killed writer)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("kind") == "trial_event":
                out.append(rec)
    return out
