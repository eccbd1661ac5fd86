"""COMPILE_GATE for the PyTorch port: the compile plane of a real
``hyperopt_tpu_torch.service.server --compile-plane on`` process, a cold
store, novel spaces under concurrent load, and a restart (the port's
counterpart of ``scripts/coldstart_smoke.py``, at its sizes and bound).

The port compiles nothing per cohort key (``service/compile_plane.py``):
a cohort is a sequence of torch operators and the two CUDA kernels, built
once per process.  So its plane holds these contracts, in place of the
JAX package's warming state:

* cold: six novel spaces, six client threads, four asks a study: no ask
  is ever served at the warming ``rand`` floor, no ask takes longer than
  5 s, the server ends the drive with the threads it started with (no
  background compile thread), its compile queue is empty and the census
  is written;
* restart on the same root: ``warm_from_census`` builds the kernels and
  ticks the census cohorts before the listener opens, so
  ``service_compile_bank_keys`` is ≥ 1 and each study's first TPE ask is
  served un-flagged within the same bound (no ``nvcc`` build on the
  serving path);
* both servers drain with exit 0, and every study's stream, in both
  phases, equals the undisturbed in-process scheduler's bit for bit.

That a census either package writes feeds the other is held by
``tests/test_torch_service_wal.py``, which ``run_torch_gates.sh`` runs
for this gate.

    python scripts/torch_coldstart_smoke.py [--device cpu] [--n-spaces 6] ...
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402

NAME = "torch_coldstart_smoke"
MAX_ASK_SEC = 5.0


def _spaces(n):
    # every (low, high) pair is its own cohort key; study g.EI_DIFF_STUDY's
    # x is quantized, which keeps its space off the fused kernel: its lr
    # scores in ei_diff (g.spec_of)
    return [{"x": {"dist": "quniform", "args": [-4.0 - 0.01 * i, 3.0 + 0.01 * i, 0.25]}
             if i == g.EI_DIFF_STUDY else
             {"dist": "uniform", "args": [-4.0 - 0.01 * i, 3.0 + 0.01 * i]},
             "lr": {"dist": "loguniform", "args": [-4.0 - 0.01 * i, 0.0]}} for i in range(n)]


def _threads(pid):
    return len(os.listdir(f"/proc/{pid}/task"))


def _settled_threads(pid, want=None, timeout=10.0):
    """The server's thread count once its per-request threads have ended
    (the count ``want``, or the same count twice 0.5 s apart)."""
    deadline, last = time.monotonic() + timeout, None
    while time.monotonic() < deadline:
        n = _threads(pid)
        if n == want or (want is None and n == last):
            return n
        last = n
        time.sleep(0.5)
    return _threads(pid)


def _drive(url, studies, asks, workers, stats, errors, streams, lock):
    work = list(range(len(studies)))

    def one():
        cl = g.client(url, key=threading.get_ident() % 2**31, retries=8)
        while True:
            with lock:
                if not work:
                    return
                i = work.pop()
            try:
                sid = studies[i].create(cl)
                seq = []
                for j in range(asks):
                    t0 = time.perf_counter()
                    trials = cl.ask(sid)
                    dt = time.perf_counter() - t0
                    warming = any(t.get("warming") for t in trials)
                    with lock:
                        stats["ask_s"].append(dt)
                        stats["warming"] += int(warming)
                        if j == 1:  # the first TPE ask
                            stats["first_tpe_warming"] += int(warming)
                            stats["first_tpe_s"].append(dt)
                    for t in trials:
                        cl.tell(sid, t["tid"], studies[i].loss(t["params"]))
                        seq.append((t["tid"], g.canon(t["params"])))
                with lock:
                    streams[i] = seq
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(f"study {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _phase(label, url, pid, studies, args):
    stats = {"ask_s": [], "warming": 0, "first_tpe_warming": 0, "first_tpe_s": []}
    errors, streams, lock = [], {}, threading.Lock()
    before = _settled_threads(pid)
    _drive(url, studies, args.asks_per_study, args.n_workers, stats, errors, streams, lock)
    g.check(not errors, f"{label}: client errors:\n  " + "\n  ".join(errors[:10]))
    after = _settled_threads(pid, want=before)
    g.check(after == before, f"{label}: the server went from {before} to {after} threads "
                             "(a background thread started)")
    worst = max(stats["ask_s"])
    g.check(worst <= MAX_ASK_SEC, f"{label}: an ask took {worst:.2f} s (> {MAX_ASK_SEC} s)")
    g.check(stats["warming"] == 0, f"{label}: {stats['warming']} asks served at the warming "
                                   "floor")
    text = g.get_text(url, "/metrics")
    g.check(g.metric(text, "hyperopt_tpu_service_compile_queue_depth") == 0,
            f"{label}: compile work queued")
    g.check(g.metric(text, "hyperopt_tpu_service_compile_errors_total") == 0,
            f"{label}: compile errors")
    g.log(NAME, f"{label}: {len(streams)} studies x {args.asks_per_study} asks, worst ask "
                f"{worst * 1e3:.0f} ms, none warming, {before} threads before and after")
    return [streams.get(i) for i in range(len(studies))], stats, text


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, n_spaces=6, asks_per_study=4, n_workers=6)
    device = g.prepare_device(args.device)
    studies = [g.Study(seed=7000 + i, budget=args.asks_per_study, n_startup=1, spec=spec,
                       loss=lambda p: float((float(p["x"]) - 0.5) ** 2))
               for i, spec in enumerate(_spaces(args.n_spaces))]
    ref = g.reference_streams(studies, device)
    figures = {"device": device}
    with tempfile.TemporaryDirectory(prefix="torch_coldstart_smoke_") as tmp:
        store = os.path.join(tmp, "store")
        os.makedirs(store)
        srv = g.Server(["--port", "0", "--store", store, "--compile-plane", "on"], device,
                       log_dir=tmp, label="cold")
        try:
            cold, stats, _ = _phase("cold", srv.url, srv.pid, studies, args)
            srv.drain_ok(timeout=60)
        finally:
            g.stop_all([srv])
        g.check(os.path.exists(os.path.join(store, "compile_census.jsonl")),
                "no census written")
        t0 = time.perf_counter()
        srv = g.Server(["--port", "0", "--store", store, "--compile-plane", "on"], device,
                       log_dir=tmp, label="restart")
        boot_s = time.perf_counter() - t0
        try:
            warm, stats2, text = _phase("restart", srv.url, srv.pid, studies, args)
            bank = g.metric(text, "hyperopt_tpu_service_compile_bank_keys")
            g.check(bank >= 1, "the restarted server warmed no census key")
            g.check(stats2["first_tpe_warming"] == 0, "a first TPE ask after the restart was "
                                                      "served warming")
            srv.drain_ok(timeout=60)
        finally:
            g.stop_all([srv])
    bad = g.compare_streams(cold, ref, "cold study") + g.compare_streams(warm, ref,
                                                                         "restart study")
    g.check(not bad, "a study left the undisturbed reference:\n" + "\n".join(bad))
    figures.update(
        cold_worst_ask_ms=1e3 * max(stats["ask_s"]),
        restart_boot_s=boot_s, bank_keys=bank,
        restart_first_tpe_ms={"p50": 1e3 * g.percentile(stats2["first_tpe_s"], 0.5),
                              "max": 1e3 * max(stats2["first_tpe_s"])})
    g.log(NAME, f"PASS: no ask warming or past {MAX_ASK_SEC} s, no thread started; the restart "
                f"warmed {bank:.0f} census keys before listening; streams bit for bit")
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
