"""The one traffic generator: whole searches of a configuration, back to
back, through the entry module a traffic mix names.

A traffic mix (``traffic/<mix>.json``) is data: ``entry`` names the
module ``entries/<entry>.py`` that issues a search, ``check_proposals``
sizes the comparison and ``trace`` the traced part of the window.  An
entry module exports ``Entry(cfg, fn, device)`` with ``search(seed)``,
``trials(handle)``, ``extract(handle, seed)`` and ``traced(seed, spec,
session, art, host_marks)``, and ``judge(cfg, objective, searches,
n_check, seed, device)``.

Each search gets a seed of its own from the run's seed and its index;
the same run seed gives the same searches."""

from __future__ import annotations

import time

import numpy as np


def search_seed(seed, i):
    """A 32-bit seed for search ``i`` of a run (``i = -1``: the warm-up)."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
                                 i + 1, 0x5EA])
    return int(ss.generate_state(1)[0])


def build_space(hp, space):
    """The configuration's space through the port's ``hp`` constructors."""
    out = {}
    for name, (fam, *p) in space.items():
        out[name] = (hp.choice(name, list(p[0])) if fam == "choice"
                     else getattr(hp, fam)(name, *p))
    return out


def window(entry, seed, seconds, sync, first=None):
    """Whole searches back to back until ``seconds`` have passed since the
    start: ``([(search seed, handle)], start, [end of each search])``.
    ``first(search seed)``, where given, runs the first search instead
    (the traced one)."""
    handles, ends = [], []
    t0 = time.perf_counter()
    while not ends or ends[-1] - t0 < seconds:
        s = search_seed(seed, len(handles))
        run = first if first is not None and not handles else entry.search
        handles.append((s, run(s)))
        sync()
        ends.append(time.perf_counter())
    return handles, t0, ends
