#!/usr/bin/env python3
"""Count the torch operators the port dispatches per ask and per service
wave, on the CPU.

    python scripts/torch_count_ops.py

On a card most dispatched operators launch one small kernel each, and the
host-loop paths are bound by those launches, so the count predicts how a
change moves an ask's wall before any card run.  Prints one JSON object:
operators per warm ask (branin after 300 random trials: annealing, TPE at
1024 and at 32 candidates, aTPE; annealing on ``many_dists`` after 100)
and per warm wave of a 40-study ``make_study_mix``, unwidened and
widened.  Imports neither JAX nor the JAX package.
"""

import functools
import json
import os
import sys

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hyperopt_tpu_torch as port  # noqa: E402
from hyperopt_tpu_torch import zoo  # noqa: E402
from hyperopt_tpu_torch.base import Domain  # noqa: E402
from hyperopt_tpu_torch.service import StudyScheduler  # noqa: E402


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ask_ops(name, algo, history):
    """Operators of one warm ask after ``history`` random trials."""
    dom = zoo.ZOO[name]
    trials = port.Trials(device="cpu")
    port.fmin(dom.objective, dom.space, algo=port.rand.suggest, max_evals=history,
              trials=trials, rstate=np.random.default_rng(0), show_progressbar=False)
    domain = Domain(dom.objective, dom.space)
    algo([history], domain, trials, 1)  # warm: the first ask builds the step
    count = _Count()
    with count:
        algo([history], domain, trials, 2)
    return count.n


def wave_ops(widen, studies=40, warm_waves=8):
    """Operators of one warm wave of ``make_study_mix(studies)``."""
    sched = StudyScheduler(device="cpu", widen=widen)
    items = {sched.create_study(it.domain.space, seed=it.seed,
                                n_startup_jobs=it.n_startup_jobs): it
             for it in zoo.make_study_mix(studies)}

    def wave():
        answers = sched.ask_many([(sid, 1) for sid in items])
        for sid, (a,) in answers.items():
            sched.tell(sid, a["tid"], items[sid].domain.objective(a["params"]))

    for _ in range(warm_waves):
        wave()
    count = _Count()
    with count:
        wave()
    return count.n


def main():
    tpe = port.tpe.suggest
    out = {
        "ask": {
            "anneal/branin": ask_ops("branin", port.anneal.suggest, 300),
            "tpe_1024/branin": ask_ops("branin", functools.partial(tpe, n_EI_candidates=1024),
                                       300),
            "tpe_32/branin": ask_ops("branin", functools.partial(tpe, n_EI_candidates=32), 300),
            "atpe/branin": ask_ops("branin", port.atpe.suggest, 300),
            "anneal/many_dists": ask_ops("many_dists", port.anneal.suggest, 100),
        },
        "wave": {"unwidened": wave_ops(False), "widened": wave_ops(True)},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
