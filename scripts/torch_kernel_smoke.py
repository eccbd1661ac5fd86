"""KERNEL_GATE for the PyTorch port: the kernel routes of real
``hyperopt_tpu_torch.service.server`` processes (the port's counterpart of
``scripts/kernel_smoke.py``, at its mix), with the routes as the port
defines them (``_env.parse_megakernel``): unset (or ``1``/``on``) ticks
every space ``megakernel.supports`` in the fused kernel, ``0``/``off``
keeps the grouped ``ei_diff`` program; the JAX package's ``interpret``
runs a Pallas interpreter and has no counterpart.

* ``=off`` and ``=0`` propose bit for bit alike directly through the
  in-process scheduler, and driving them starts no thread;
* over HTTP, an ``=off`` server and an ``=0`` server serve the zoo mix
  (``make_study_mix(2)``, all on the fused route, plus one study on a
  space with a quantized label, the default route's ``ei_diff`` path) with streams
  equal study for study, trial for trial, through the JSON round trip;
* a default server serves the same mix to budget, every loss finite, its
  streams equal to the undisturbed in-process scheduler's bit for bit;
  ``/metrics`` lints with ``hyperopt_tpu_suggest_megakernel`` at 1, and
  SIGTERM drains with exit 0.

    python scripts/torch_kernel_smoke.py [--device cpu] [--mix-n 2]
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402

NAME = "torch_kernel_smoke"


def _drive(cl, studies):
    sids = [st.create(cl) for st in studies]
    out = []
    for sid, st in zip(sids, studies):
        seq = []
        for _ in range(st.budget):
            t = cl.ask(sid)[0]
            loss = st.loss(t["params"])
            g.check(math.isfinite(loss), f"non-finite loss {loss} on {st.zoo}")
            cl.tell(sid, t["tid"], loss=loss)
            seq.append((t["tid"], g.canon(t["params"])))
        out.append(seq)
    return out


def _direct(studies, device, route):
    with g.megakernel_route(route):
        return g.drive_in_process(studies, device)


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, mix_n=2)
    device = g.prepare_device(args.device)
    from hyperopt_tpu_torch.zoo import ZOO, make_study_mix

    studies = [g.Study(seed=m.seed, budget=m.budget, n_startup=m.n_startup_jobs,
                       zoo=m.domain.name,
                       loss=lambda p, n=m.domain.name: float(ZOO[n].objective(p)))
               for m in make_study_mix(args.mix_n, 0)]
    # the mix is all-numeric and un-quantized (the fused route): one study
    # on a space with a quantized label puts the default server's ei_diff
    # route in the mix, first, so that the megakernel gauge ends on a fused
    # tick
    studies.insert(0, g.Study(seed=11, budget=studies[0].budget,
                              n_startup=studies[0].n_startup, loss=g.x_loss(0.5),
                              spec=g.EI_DIFF_SPEC))
    figures = {"device": device}

    threads = threading.active_count()
    off = _direct(studies, device, "off")
    g.check(threading.active_count() == threads, "driving the grouped route changed the "
                                                 f"thread count ({threads} -> "
                                                 f"{threading.active_count()})")
    zero = _direct(studies, device, "0")
    g.check(off == zero, "HYPEROPT_TPU_MEGAKERNEL=0 proposals leave =off (direct)")
    g.log(NAME, "=off and =0 bit for bit through the scheduler, no new thread")

    with tempfile.TemporaryDirectory(prefix="torch_kernel_smoke_") as tmp:
        streams = {}
        for route in ("off", "0"):
            srv = g.Server(["--port", "0", "--store", os.path.join(tmp, f"store_{route}")],
                           device, log_dir=tmp, label=f"route_{route}",
                           extra={"HYPEROPT_TPU_MEGAKERNEL": route})
            try:
                streams[route] = _drive(g.client(srv.url), studies)
                srv.drain_ok(timeout=120)
            finally:
                g.stop_all([srv])
        g.check(streams["off"] == streams["0"], "=0 proposals leave =off over HTTP")
        g.check(streams["off"] == off, "the =off server leaves the =off scheduler")
        g.log(NAME, "=off and =0 servers bit for bit over HTTP")

        srv = g.Server(["--port", "0", "--store", os.path.join(tmp, "store_default")], device,
                       log_dir=tmp, label="route_default", drop=("HYPEROPT_TPU_MEGAKERNEL",))
        try:
            fused = _drive(g.client(srv.url), studies)
            text = g.get_text(srv.url, "/metrics")
            errs = g.lint_metrics(text)
            g.check(not errs, "/metrics lint: " + "; ".join(errs[:5]))
            gauge = [ln for ln in text.splitlines()
                     if ln.startswith("hyperopt_tpu_suggest_megakernel")
                     and not ln.startswith("#")]
            g.check(gauge and any(float(ln.rsplit(None, 1)[1]) == 1.0 for ln in gauge),
                    f"the default server never reported suggest.megakernel=1: {gauge}")
            srv.drain_ok(timeout=120)
        finally:
            g.stop_all([srv])
    ref = g.reference_streams(studies, device)
    bad = g.compare_streams(fused, ref)
    g.check(not bad, "the default server left the undisturbed reference:\n" + "\n".join(bad))
    flips = g.tolerant_flips(off, ref)
    figures.update(studies=len(studies), grouped_vs_fused_flips=len(flips))
    g.log(NAME, f"PASS: the default server served the mix bit for bit with the reference "
                f"(the grouped route {len(flips)} flips from it), megakernel gauge 1, clean "
                "drains")
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
