"""TENANT_GATE for the PyTorch port: the tenant observatory of a real
``hyperopt_tpu_torch.service.server`` process under a ~10:1 adversarial
tenant mix (the port's counterpart of ``scripts/tenant_smoke.py``, at its
sizes, quota and bound).

* a light tenant (one sequential study) and a noisy one (hammer threads
  over 4 studies) share one server with a per-tenant ask budget of 2; the
  light tenant's ask p99 in the mix stays within max(3 × its solo p99,
  3 s), measured in windows whose cohort shapes are warm;
* the noisy tenant gets typed per-tenant 429s with ``Retry-After``, the
  light tenant none;
* ``GET /tenants`` serves the bounded table with both tenants, the noisy
  one dominating the mixed window; ``/studies`` rows carry the tenant;
  ``/metrics`` passes ``validate_scrape.py``'s tenant lint; probe traffic
  (``x-probe: 1``) mints no tenant row;
* no tell is lost, and every study's stream equals the undisturbed
  in-process scheduler's bit for bit; SIGTERM drains with exit 0.

    python scripts/torch_tenant_smoke.py [--device cpu] [--warm-rounds 70] ...
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402
from validate_scrape import validate_tenant_families  # noqa: E402

NAME = "torch_tenant_smoke"
TENANT_QUOTA = 2


def _ask_tell(url, sid, tenant, stats, lock, streams, lat=None):
    """One ask and tell; a 429 is recorded with its Retry-After and
    honoured, a served ask is always told (retried), so the mix loses no
    tell."""
    t0 = time.perf_counter()
    r = g.request(url, "/ask", {"study_id": sid}, headers={"x-tenant": tenant})
    if lat is not None and r.status == 200:
        lat.append(time.perf_counter() - t0)
    if r.status == 429:
        with lock:
            stats.setdefault(f"{tenant}_429", []).append(
                ((r.payload or {}).get("error", ""), r.retry_after))
        try:
            time.sleep(min(float(r.retry_after), 0.5))
        except (TypeError, ValueError):
            time.sleep(0.05)
        return False
    if r.status != 200:
        with lock:
            stats.setdefault("errors", []).append((tenant, r.status, r.text[:200]))
        return False
    trial = r.payload["trials"][0]
    loss = float(float(trial["params"]["x"]) ** 2)
    for _ in range(20):
        if g.request(url, "/tell", {"study_id": sid, "tid": trial["tid"], "loss": loss},
                     headers={"x-tenant": tenant}).status == 200:
            with lock:
                stats[sid] = stats.get(sid, 0) + 1
                streams.setdefault(sid, []).append((trial["tid"], g.canon(trial["params"])))
            return True
        time.sleep(0.1)
    with lock:
        stats.setdefault("errors", []).append((tenant, "tell failed", sid))
    return False


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, noisy_studies=4, noisy_threads=4, warm_rounds=70,
                       solo_sample=20, mixed_rounds=30)
    device = g.prepare_device(args.device)
    figures = {"device": device}
    with tempfile.TemporaryDirectory(prefix="torch_tenant_smoke_") as tmp:
        srv = g.Server(["--port", "0", "--max-studies", "64"], device, log_dir=tmp,
                       drop=("HYPEROPT_TPU_TENANT",),
                       extra={"HYPEROPT_TPU_TENANT_QUOTA": str(TENANT_QUOTA)})
        try:
            url = srv.url
            g.log(NAME, f"server up at {url} (pid {srv.pid}, per-tenant quota {TENANT_QUOTA})")
            stats, streams, lock = {}, {}, threading.Lock()
            seeds, specs = {}, {}

            def create(sid, seed, tenant, spec):
                r = g.request(url, "/study", {"space": spec, "seed": seed,
                                              "n_startup_jobs": 2, "study_id": sid},
                              headers={"x-tenant": tenant})
                g.check(r.status == 200, f"create {sid}: {r}")
                seeds[r.payload["study_id"]] = seed
                specs[r.payload["study_id"]] = spec
                return r.payload["study_id"]

            # the light study is study 0; the noisy ones follow (g.spec_of)
            light = create("light-0", 100, "light", g.spec_of(0))
            noisy = [create(f"noisy-{i}", 200 + i, "noisy", g.spec_of(1 + i))
                     for i in range(args.noisy_studies)]
            # probe traffic must never mint a tenant row
            g.request(url, "/ask", {"study_id": "probe-canary-target"},
                      headers={"x-tenant": "canary-bot", "x-probe": "1"})

            # warm: take the light study's cohort through its capacity steps
            # so no first-time shape lands in a measured window
            t0 = time.perf_counter()
            for _ in range(args.warm_rounds):
                _ask_tell(url, light, "light", stats, lock, streams)
            warm_s = time.perf_counter() - t0
            solo = []
            for _ in range(args.solo_sample):
                _ask_tell(url, light, "light", stats, lock, streams, lat=solo)
            solo_p99 = g.percentile(solo, 0.99)
            g.log(NAME, f"solo baseline: {args.warm_rounds} warm rounds in {warm_s:.1f} s, "
                        f"light solo p99 {solo_p99 * 1e3:.1f} ms over {len(solo)} rounds")

            pre = {t: dict(row) for t, row in
                   (g.get_json(url, "/tenants").get("table") or {}).items()}
            stop = threading.Event()

            def hammer(i):
                while not stop.is_set():
                    _ask_tell(url, noisy[i % len(noisy)], "noisy", stats, lock, streams)

            threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
                       for i in range(args.noisy_threads)]
            for t in threads:
                t.start()
            for _ in range(5):  # unmeasured: the mixed cohort's first shapes
                _ask_tell(url, light, "light", stats, lock, streams)
            mixed = []
            for _ in range(args.mixed_rounds):
                _ask_tell(url, light, "light", stats, lock, streams, lat=mixed)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            mixed_p99 = g.percentile(mixed, 0.99)
            noisy_sheds, light_sheds = stats.get("noisy_429", []), stats.get("light_429", [])
            g.log(NAME, f"mixed window: light p99 {mixed_p99 * 1e3:.1f} ms ({len(mixed)} "
                        f"asks), noisy 429s {len(noisy_sheds)}, light 429s {len(light_sheds)}")
            g.check(not stats.get("errors"), f"hard errors in the mix: {stats.get('errors')}")
            g.check(not light_sheds, f"the light tenant was shed {len(light_sheds)} times")
            g.check(noisy_sheds, "the noisy tenant never met its per-tenant ask budget")
            g.check(any("ask budget" in e and ra for e, ra in noisy_sheds),
                    f"noisy 429s lack the typed error or Retry-After: {noisy_sheds[:3]}")
            bound = max(3.0 * solo_p99, 3.0)
            g.check(mixed_p99 <= bound, f"light mixed p99 {mixed_p99:.3f} s > bound "
                                        f"{bound:.3f} s (solo {solo_p99:.3f} s)")

            ten = g.get_json(url, "/tenants")
            table = ten.get("table") or {}
            g.check(ten.get("armed") and "light" in table and "noisy" in table,
                    f"/tenants lacks the mix: {ten}")
            g.check("canary-bot" not in table, "probe traffic minted a tenant row")

            def delta(t, key):
                return table[t][key] - (pre.get(t) or {}).get(key, 0)

            g.check(delta("noisy", "asks") > delta("light", "asks"),
                    f"the noisy tenant did not dominate the mixed window: "
                    f"+{delta('noisy', 'asks')} asks against +{delta('light', 'asks')}")
            g.check(ten.get("sheds", 0) >= len(noisy_sheds),
                    f"ledger sheds {ten.get('sheds')} < observed {len(noisy_sheds)}")
            errs = validate_tenant_families(g.get_text(url, "/metrics"))
            g.check(not errs, "/metrics tenant lint: " + "; ".join(errs[:10]))

            rows = g.study_rows(url)
            g.check(rows[light].get("tenant") == "light"
                    and rows[noisy[0]].get("tenant") == "noisy",
                    f"/studies rows lack the tenant column: {rows[light]}")
            lost = [(sid, stats.get(sid, 0), rows.get(sid, {}).get("n_trials"),
                     rows.get(sid, {}).get("n_pending")) for sid in [light] + noisy
                    if sid not in rows or rows[sid]["n_trials"] != stats.get(sid, 0)
                    or rows[sid]["n_pending"]]
            g.check(not lost, f"lost tells: {lost}")
            srv.drain_ok(timeout=60)
        finally:
            g.stop_all([srv])

    # every study's stream against the undisturbed reference, at its length
    order = [light] + noisy
    studies = [g.Study(seed=seeds[sid], budget=len(streams.get(sid, [])), n_startup=2,
                       loss=g.x_loss(0.0), spec=specs[sid]) for sid in order]
    ref = g.reference_streams(studies, device)
    bad = g.compare_streams([streams.get(sid, []) for sid in order], ref)
    g.check(not bad, "a study left the undisturbed reference:\n" + "\n".join(bad))
    tells = sum(stats.get(sid, 0) for sid in order)
    figures.update(solo_p99_ms=1e3 * solo_p99, mixed_p99_ms=1e3 * mixed_p99,
                   mixed_p50_ms=1e3 * g.percentile(mixed, 0.5), bound_ms=1e3 * bound,
                   noisy_429=len(noisy_sheds), light_429=len(light_sheds), tells=tells)
    g.log(NAME, f"PASS: /tenants {sorted(table)}, the scrape lints, {tells} tells settled "
                "and every stream bit for bit; clean drain")
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
