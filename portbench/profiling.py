"""One torch.profiler session over part of a run, and what is read from
it: the device events (kernels, copies, fills), their busy time as the
union of their intervals, the kernel count, and the breakdown (the
device operations that took most time, the longest idle gaps with what
the host was doing).

The session records the device activity alone (CPU-side recording adds
host time to every launch and would inflate the idle share it measures)
of the thread that starts it, so the harness starts it on the thread
that launches the work.  Host intervals (the port's spans, the loop's
chunk boundaries) are given in ``time.time()`` seconds and placed on the
trace's clock by a marker: one fill launched on an idle card right after
the session starts, the session's first device event."""

from __future__ import annotations

import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile


class Session:
    def __init__(self):
        self.prof = None
        self.events = []        # (name, start_ns, end_ns) on the device
        self.offset_ns = 0      # trace clock minus time.time() in ns
        self.window_s = None

    def start(self):
        card = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA if card else ProfilerActivity.CPU])
        self.prof.start()
        self._wall0 = time.time()
        if card:
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        events = sorted(((e.name(), e.start_ns(), e.end_ns())
                         for e in self.prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA),
                        key=lambda ev: ev[1])
        if events:  # the marker
            self.offset_ns = events[0][1] - int(self._wall0 * 1e9)
        self.events = events[1:]
        self.prof = None

    def busy(self):
        """Merged busy intervals ``[(start_ns, end_ns)]`` of the device."""
        out = []
        for _, s, e in self.events:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy()) / 1e9

    def breakdown(self, host=()):
        """``{"device_ops": [[name, s]], "idle_gaps": [[label, s]]}``, ten
        each: the device operations by summed time, and the longest gaps
        between busy intervals, each named by the host interval ``host``
        (``(label, t0_wall_s, t1_wall_s)``) that overlaps it most, else
        ``"host"``."""
        by_name = collections.Counter()
        for name, s, e in self.events:
            by_name[name] += (e - s) / 1e9
        busy = self.busy()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        iv = [(lbl, a * 1e9 + self.offset_ns, b * 1e9 + self.offset_ns) for lbl, a, b in host]
        named = []
        for s, e in gaps[:10]:
            over = [(min(e, b) - max(s, a), lbl) for lbl, a, b in iv if min(e, b) > max(s, a)]
            named.append([max(over)[1] if over else "host", (e - s) / 1e9])
        return {"device_ops": [[n, t] for n, t in by_name.most_common(10)],
                "idle_gaps": named}
