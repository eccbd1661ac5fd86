"""``obs.top`` — a live, curses-free terminal dashboard over a running
sweep or service (counterpart of ``hyperopt_tpu/obs/top.py``; host-only,
its frames equal the JAX package's byte for byte on the same snapshots).

Usage::

    python -m hyperopt_tpu_torch.obs.top http://127.0.0.1:9109        # scrape
    python -m hyperopt_tpu_torch.obs.top http://h0:9109 http://h1:9110  # multihost
    python -m hyperopt_tpu_torch.obs.top run.jsonl                    # tail files
    python -m hyperopt_tpu_torch.obs.top rundir/                      # tail a dir

URL mode polls each server's ``/snapshot`` endpoint (the scrape server
``fmin(obs_http=...)`` / ``HYPEROPT_TPU_OBS_HTTP`` arms — obs/serve.py);
give one URL per controller for the multihost per-controller view (the
driver offsets ``run.p<i>`` ports by process index).  File mode re-reads
JSONL streams and rebuilds the same sections via the shared serializer —
useful when the run armed a stream but no server.

The screen redraws with plain ANSI (clear + home) every ``--interval``
seconds: best loss + throughput, ask-pipeline inflight/blocked, EI/dup
sparklines (trend accumulated across refreshes), HBM watermark, and a
per-controller liveness table (last-heartbeat ages).  ``--once`` renders a
single frame without clearing — scripts and tests use that.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from .report import _bar, _fmt_bytes, _fmt_sec, _spark

__all__ = ["main", "render_frame", "fetch_snapshot", "snapshot_from_stream",
           "snapshot_from_records"]

_CLEAR = "\x1b[2J\x1b[H"


def fetch_snapshot(url, timeout=3.0):
    """GET ``<url>/snapshot`` → dict, or ``{"error": ...}`` (a dead
    controller renders as a dead row, never a dead dashboard)."""
    import urllib.request

    if not url.rstrip("/").endswith("/snapshot"):
        url = url.rstrip("/") + "/snapshot"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


class _StreamTail:
    """Incrementally-tailed JSONL source: each refresh parses only the
    bytes appended since the last one (a refresh loop over a multi-hour
    stream must not re-parse hundreds of MB per frame).  A torn final
    line (the run mid-write) is left for the next frame."""

    def __init__(self, path):
        self.path = path
        self.offset = 0
        self.records = []

    def read_new(self):
        # binary mode: the resume offset is a byte count, and text-mode
        # seek to arbitrary integers is undefined (and drifts on
        # non-UTF-8 locales)
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            while True:
                line = f.readline()
                if not line or not line.endswith(b"\n"):
                    break  # EOF or torn tail: retry from offset next frame
                self.offset += len(line)
                line = line.strip()
                if not line:
                    continue
                try:
                    self.records.append(json.loads(line.decode("utf-8")))
                except (ValueError, UnicodeDecodeError):
                    pass  # torn-then-flushed garbage: skip like iter_jsonl

    def snapshot(self):
        try:
            self.read_new()
        except OSError as e:
            return {"error": f"{type(e).__name__}: {e}"}
        return snapshot_from_records(self.records)


def snapshot_from_records(records):
    """Rebuild the snapshot shape from parsed JSONL records via the SAME
    serializer the live endpoint uses — then overlay what a MID-RUN
    stream can tell us that the sections cannot: the metrics snapshot the
    sections are built from is only written at ``RunObs.finish()``, so
    until the run exits the trial count comes from lifecycle events and
    the health gauges from the live ``kind="health"`` records."""
    from .events import TRIAL_FINISHED
    from .report import _stream_sections

    out = _stream_sections(records)
    out["ts"] = max((r["ts"] for r in records if "ts" in r), default=None)
    dms = [r for r in records if r.get("kind") == "devmem"]
    if dms:
        out["devmem"] = dms[-1]
    # best loss from the stream's final metrics snapshot gauge
    metric_recs = [r for r in records if r.get("kind") == "metrics"]
    if metric_recs:
        m = (metric_recs[-1].get("snapshot") or {}).get("metrics", {})
        if "best_loss" in m:
            out["best_loss"] = m["best_loss"]
        out["trials_completed"] = m.get("trials.completed", 0)
    else:
        out["trials_completed"] = sum(
            1 for r in records if r.get("kind") == "trial_event"
            and r.get("event") == TRIAL_FINISHED)
    health = out["sections"]["health"]
    if not health.get("asks"):
        hrecs = [r for r in records if r.get("kind") == "health"]
        if hrecs:
            health["asks"] = len(hrecs)
            last = hrecs[-1]
            if "ei_p50" in last:
                health["last_ei_p50"] = last["ei_p50"]
            if "dup_rate" in last:
                health["last_dup_rate"] = last["dup_rate"]
    return out


def snapshot_from_stream(path):
    """One-shot file-mode source (``--once`` / tests): full read."""
    return _StreamTail(path).snapshot()


def discover_fleet(seed_url, timeout=5.0):
    """Fleet discovery: one replica's ``/healthz`` advertises
    every replica's address (``replica_addrs``, built from the published
    ownership table), so the whole fleet dashboards from a single seed
    URL instead of requiring every URL by hand.  Returns the replica
    base URLs, seed first; a failed discovery degrades to just the
    seed (a dead seed renders as one dead row, never a dead
    dashboard)."""
    import urllib.request

    url = seed_url.rstrip("/")
    out = [url]
    try:
        with urllib.request.urlopen(f"{url}/healthz",
                                    timeout=timeout) as r:
            h = json.loads(r.read().decode())
    except Exception as e:  # noqa: BLE001 - degrade to the seed alone
        print(f"fleet discovery failed on {url}/healthz: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return out
    live = set(h.get("replicas") or [])
    addrs = h.get("replica_addrs") or {}
    for rid in sorted(addrs):
        if live and rid not in live:
            continue  # departed replica still in the ownership table
        a = str(addrs[rid]).rstrip("/")
        if a and a not in out:
            out.append(a)
    return out


def _expand_sources(args_sources):
    """URLs pass through; a directory expands to its ``*.jsonl`` streams
    (flight dumps excluded)."""
    out = []
    for src in args_sources:
        if src.startswith(("http://", "https://")):
            out.append(("url", src))
        elif os.path.isdir(src):
            for p in sorted(glob.glob(os.path.join(src, "*.jsonl"))):
                if ".flight." not in os.path.basename(p):
                    out.append(("file", p))
        else:
            out.append(("file", src))
    return out


class History:
    """Per-source trend memory across refreshes: EI p50, dup rate, HBM
    watermark, completed-trial counts (for throughput)."""

    def __init__(self, width=120):
        self.width = width
        self.series = {}
        self._counts = []  # (mono ts, trials completed)

    def push(self, key, value):
        if value is None:
            return
        s = self.series.setdefault(key, [])
        s.append(float(value))
        del s[:-self.width]

    def trend(self, key):
        return self.series.get(key, [])

    def push_count(self, n_completed, now=None):
        if n_completed is None:
            return
        self._counts.append((time.monotonic() if now is None else now,
                             float(n_completed)))
        del self._counts[:-self.width]

    def throughput(self):
        """trials/sec over the sampled window (None before 2 samples)."""
        if len(self._counts) < 2:
            return None
        (t0, n0), (t1, n1) = self._counts[0], self._counts[-1]
        if t1 <= t0:
            return None
        return max(0.0, (n1 - n0) / (t1 - t0))


def _metric_scalar(m, default=0):
    """A service-registry metric snapshot value as a scalar (histograms
    snapshot as dicts — take the count)."""
    if isinstance(m, dict):
        return m.get("count", default)
    return m if isinstance(m, (int, float)) else default


def _render_service_source(name, snap, out, w):
    """The serving-process view: a ``service.server``
    ``/snapshot`` has no fmin sections — render the study table, traffic
    + shed rate, degrade-ladder state and the SLO budget bars instead."""
    svc = (snap.get("sections") or {}).get("service") or {}
    asks = int(_metric_scalar(svc.get("service.asks")))
    tells = int(_metric_scalar(svc.get("service.tells")))
    shed = int(_metric_scalar(svc.get("service.shed.ask")))
    studies = snap.get("studies") or []
    live = sum(1 for s in studies if s.get("state") == "active")
    line = (f"  {name:<{w}}  SERVICE  studies {live}/{len(studies)}"
            f"  asks {asks}  tells {tells}")
    if shed or asks:
        line += f"  shed {shed / max(1, shed + asks):.1%}"
    wave = svc.get("service.wave_sec") or {}
    if isinstance(wave, dict) and wave.get("count"):
        line += (f"  wave p50 {_fmt_sec(wave.get('p50'))}"
                 f" p99 {_fmt_sec(wave.get('p99'))}")
    util = snap.get("slot_utilization")
    if isinstance(util, (int, float)):
        line += f"  slots {util:.0%}"
    if snap.get("draining"):
        line += "  DRAINING"
    out.append(line)
    # the COMPILE row: warming-state admission + the
    # background compile queue + kernel-bank reuse, from /snapshot's
    # compile section — cold-start behavior at a glance
    comp = snap.get("compile")
    if comp:
        cline = (f"  {'':<{w}}  COMPILE  warming "
                 f"{comp.get('warming_studies', 0)}"
                 f"  queue {comp.get('queue_depth', 0)}"
                 f"  compiled {comp.get('compiled', 0)}"
                 f"  bank {comp.get('bank_hits', 0)}/"
                 f"{comp.get('bank_keys', 0)}")
        if comp.get("widen"):
            cline += "  WIDEN"
        if comp.get("errors"):
            cline += f"  ERRORS {comp['errors']}"
        out.append(cline)
    # the FLEET row: which replica this is, the shard leases
    # (+ epochs) it holds out of the fleet's keyspace, live peer count,
    # adoption/handoff traffic and WAL sync health — the /healthz body
    # rendered one line per replica
    fleet = snap.get("fleet")
    if fleet:
        held = fleet.get("shards_held") or []
        shards = fleet.get("shards") or {}
        epochs = sorted({int(s.get("epoch") or 0)
                         for s in shards.values()})
        fline = (f"  {'':<{w}}  FLEET  {fleet.get('replica', '?')}"
                 f"  shards {len(held)}/{fleet.get('n_shards', '?')}"
                 f" {held}")
        if epochs:
            fline += f"  epochs {epochs[0]}" + (
                f"-{epochs[-1]}" if len(epochs) > 1 else "")
        fline += f"  replicas {len(fleet.get('replicas') or [])}"
        # held-shard heat summary: cumulative device heat
        # across held shards + the replica's busy duty cycle, with the
        # hottest held shard called out
        fl_load = fleet.get("load") or {}
        if fl_load.get("heat_ms") is not None:
            fline += (f"  heat {float(fl_load['heat_ms']) / 1e3:.1f}s"
                      f"  busy {float(fl_load.get('busy_frac') or 0):.0%}")
            hot = max(((k, s) for k, s in shards.items()
                       if s.get("heat_ms") is not None),
                      key=lambda kv: kv[1]["heat_ms"], default=None)
            if hot is not None:
                fline += (f"  hot shard{hot[0]} "
                          f"{float(hot[1]['heat_ms']) / 1e3:.1f}s")
        if fleet.get("adoptions") or fleet.get("handoffs"):
            fline += (f"  adopt {fleet.get('adoptions', 0)}"
                      f"  handoff {fleet.get('handoffs', 0)}")
        if fleet.get("leases_lost"):
            fline += f"  LOST {fleet['leases_lost']}"
        if fleet.get("wal_sync_errors"):
            fline += f"  WAL-SYNC-ERRORS {fleet['wal_sync_errors']}"
        if fleet.get("draining"):
            fline += "  DRAINING"
        out.append(fline)
    # the STORE row: disk watermark, store-full shed state,
    # quarantined studies and GC reclaim — the storage-integrity plane
    # at a glance, from /snapshot's store section
    store = snap.get("store")
    if store and (store.get("free_bytes") is not None
                  or store.get("store_full")
                  or store.get("quarantined")):
        sline = f"  {'':<{w}}  STORE "
        free = store.get("free_bytes")
        if free is not None:
            gb = float(free) / 1e9
            sline += (f" free {gb:.1f}G"
                      f"  used {float(store.get('used_frac', 0)):.0%}")
        if store.get("store_full"):
            sline += "  FULL (507 shed)"
        elif store.get("low"):
            sline += "  LOW"
        q = int(store.get("quarantined") or 0)
        if q:
            sline += f"  QUARANTINED {q}"
        gc = store.get("gc") or {}
        if gc.get("reclaimed_bytes"):
            sline += f"  gc {gc['reclaimed_bytes'] / 1e6:.1f}M"
        out.append(sline)
    # the QUALITY row: is the fleet actually optimizing —
    # stagnant/solved study counts and the worst-off cohort, from
    # /snapshot's quality section
    qual = snap.get("quality")
    if qual and qual.get("studies"):
        qline = (f"  {'':<{w}}  QUALITY  studies {qual.get('studies', 0)}"
                 f"  stagnant {qual.get('stagnant', 0)}"
                 f" ({float(qual.get('stagnant_frac', 0.0)):.0%})"
                 f"  solved {qual.get('solved', 0)}")
        cohorts = qual.get("cohorts") or {}
        worst = max(
            ((c, v) for c, v in cohorts.items()
             if v.get("best_regret") is not None),
            key=lambda kv: kv[1]["best_regret"], default=None)
        if worst is not None:
            qline += (f"  worst {worst[0][:24]}"
                      f" regret {float(worst[1]['best_regret']):.4g}")
        if (float(qual.get("stagnant_frac", 0.0)) >= 0.5
                and qual.get("studies", 0) > 1):
            qline += "  STAGNANT"
        out.append(qline)
    # the PROBE row: the blackbox canary's verdict — is the
    # server provably serving the RIGHT proposals as a client sees it —
    # from /snapshot's probes section (prober-armed servers only)
    probes = snap.get("probes")
    if probes and probes.get("armed"):
        last = probes.get("last") or {}
        pline = (f"  {'':<{w}}  PROBE  "
                 f"{'green' if probes.get('green') else 'RED'}"
                 f"  cycles {probes.get('cycles', 0)}"
                 f"  verdict {last.get('verdict', '?')}"
                 f"  streak {probes.get('golden_match_streak', 0)}")
        det = probes.get("detection")
        if det:
            pline += f"  detect {float(det['mean_sec']):.1f}s"
        if probes.get("escalations"):
            pline += (f"  MISMATCH x{probes['escalations']} "
                      "(golden-stream divergence)")
        out.append(pline)
    # the TENANT row: who is consuming this server — tracked
    # tenant count, the dominant tenant's device-time share, and shed
    # pressure, from /snapshot's tenants section (tenant-armed servers)
    ten = snap.get("tenants")
    if ten and ten.get("tenants"):
        tline = (f"  {'':<{w}}  TENANT  tracked {ten.get('tenants', 0)}"
                 f"  asks {ten.get('asks', 0)}"
                 f"  dev {float(ten.get('device_ms', 0.0)):.0f}ms")
        table = ten.get("table") or {}
        total_ms = sum(float(r.get("device_ms") or 0.0)
                       for r in table.values())
        top_t = max(table.items(),
                    key=lambda kv: float(kv[1].get("device_ms") or 0.0),
                    default=None)
        if top_t is not None and total_ms > 0:
            share = float(top_t[1].get("device_ms") or 0.0) / total_ms
            tline += f"  top {top_t[0][:24]} ({share:.0%})"
            if share > 0.5 and len(table) > 1:
                tline += "  NOISY"
        if ten.get("sheds"):
            tline += f"  sheds {ten['sheds']}"
        if ten.get("evictions"):
            tline += f"  evicted {ten['evictions']}"
        out.append(tline)
    degrade = snap.get("degrade")
    if degrade and (degrade.get("level") or degrade.get("faults")):
        out.append(f"  {'':<{w}}  ladder {degrade.get('name', '?')}"
                   f"  faults {degrade.get('faults', 0)}"
                   f"  clean {degrade.get('clean_waves', 0)}/"
                   f"{degrade.get('recover_after', '?')}")
    slo = snap.get("slo") or {}
    for obj in sorted(slo):
        s = slo[obj]
        rem = s.get("budget_remaining_frac")
        if rem is None:
            continue
        frac = max(0.0, min(1.0, float(rem)))
        line = (f"  {'':<{w}}  slo {obj:<14} [{_bar(frac, 12)}] "
                f"{float(rem) * 100:6.1f}%  burn "
                f"{float(s.get('burn_fast', 0)):4.1f}x/"
                f"{float(s.get('burn_slow', 0)):4.1f}x")
        if s.get("exhausted") and s.get("window_events"):
            line += "  EXHAUSTED"
        elif s.get("fast_alerting") and s.get("window_events"):
            line += "  FAST-BURN"
        out.append(line)
    # the hottest studies (most recently active first)
    top = sorted(studies, key=lambda s: -(s.get("last_active") or 0))[:6]
    for s in top:
        best = s.get("best_loss")
        line = (
            f"  {'':<{w}}    {str(s.get('study_id', '?'))[:24]:<24}"
            f"  {s.get('state', '?'):<7}"
            f"  trials {s.get('n_trials', 0):>4}"
            f"  pending {s.get('n_pending', 0):>3}"
            + (f"  best {best:.6g}" if isinstance(best, (int, float))
               else "  best -"))
        sq = s.get("quality") or {}
        if sq.get("regret") is not None:
            line += f"  regret {float(sq['regret']):.4g}"
        if sq.get("stagnant"):
            line += "  STAGNANT"
        out.append(line)


def render_frame(sources, histories, now=None):
    """One dashboard frame (pure text) from ``[(name, snapshot), ...]`` —
    the testable core of the refresh loop."""
    now = time.time() if now is None else now
    out = []
    out.append("hyperopt-tpu obs.top — "
               + time.strftime("%H:%M:%S", time.localtime(now))
               + f"  ({len(sources)} source{'s' if len(sources) != 1 else ''})")
    out.append("")

    # -- per-controller liveness table ------------------------------------
    w = max(len(name) for name, _ in sources)
    for name, snap in sources:
        hist = histories.setdefault(name, History())
        if "error" in snap:
            out.append(f"  {name:<{w}}  DEAD  {snap['error']}")
            continue
        if snap.get("service") or "studies" in snap:
            _render_service_source(name, snap, out, w)
            continue
        sections = snap.get("sections") or {}
        health = sections.get("health") or {}
        ask = sections.get("ask_pipeline") or {}
        best = snap.get("best_loss")
        n_done = snap.get("trials_completed")
        hist.push("ei_p50", health.get("last_ei_p50"))
        hist.push("dup", health.get("last_dup_rate"))
        hist.push_count(n_done)
        tp = hist.throughput()
        line = f"  {name:<{w}}"
        line += (f"  best {best:.6g}" if isinstance(best, (int, float))
                 else "  best -")
        if n_done is not None:
            line += f"  done {n_done:.0f}"
        line += (f"  {tp:.2f} trials/s" if tp is not None else "")
        line += (f"  asks {ask.get('calls', 0)}"
                 f"  inflight {ask.get('inflight', 0):.0f}")
        blocked = ask.get("blocked_sec") or {}
        if blocked.get("count"):
            line += f"  blocked p50 {_fmt_sec(blocked.get('p50'))}"
        dm = snap.get("devmem")
        if dm:
            from .devmem import roll_up

            in_use, _, _, frac = roll_up(dm.get("devices", []))
            if frac is not None:
                line += f"  hbm {frac * 100:.0f}%"
            elif in_use is not None:
                line += f"  hbm {_fmt_bytes(in_use)}"
        out.append(line)
        # the kernel-attribution headline: which program owns the ask —
        # the hottest roofline row (by measured execute time) with its
        # achieved FLOP/s and share of the suggest phase
        roof = sections.get("roofline") or {}
        hot = max((r for r in roof.items() if r[1].get("dispatches")),
                  key=lambda r: r[1].get("execute_sec_total", 0.0),
                  default=None)
        if hot is not None:
            st, r = hot
            rline = (f"  {'':<{w}}  hot kernel {st} x{r['dispatches']}"
                     f"  {_fmt_sec(r.get('execute_sec_total'))}")
            gf = r.get("achieved_flops_per_sec")
            if gf:
                rline += f"  {gf / 1e9:.2f} GF/s"
            if r.get("pct_of_ask") is not None:
                rline += f"  {r['pct_of_ask'] * 100:.0f}% of ask"
            out.append(rline)
        beats = snap.get("last_heartbeats") or {}
        if beats:
            newest = min(beats.values(),
                         key=lambda b: b.get("age_sec", float("inf")))
            comp = min(beats, key=lambda c: beats[c].get("age_sec",
                                                         float("inf")))
            out.append(f"  {'':<{w}}  last beat {comp} "
                       f"{_fmt_sec(newest.get('age_sec'))} ago"
                       + (f"  inflight trials "
                          f"{len(snap.get('inflight_trials') or [])}"
                          if snap.get("inflight_trials") is not None
                          else ""))

    # -- trends (first live source) ---------------------------------------
    for name, snap in sources:
        if "error" in snap:
            continue
        hist = histories[name]
        shown = False
        for key, label in (("ei_p50", "EI p50 "), ("dup", "dup    ")):
            t = hist.trend(key)
            if len(t) >= 2:
                if not shown:
                    out.append("")
                    out.append(f"  trends ({name}):")
                    shown = True
                out.append(f"    {label} {t[-1]:+.3g}  {_spark(t)}")
        break
    return "\n".join(out) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.obs.top",
        description="Live terminal dashboard over scrape server URLs or "
                    "recorded JSONL streams.")
    p.add_argument("sources", nargs="*",
                   help="scrape server URL(s) (http://host:port), JSONL "
                        "stream(s), or a run directory")
    p.add_argument("--fleet", metavar="SEED_URL", default=None,
                   help="discover every fleet replica's URL from this "
                        "seed replica's /healthz (replica_addrs) and "
                        "dashboard them all")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (no screen clearing)")
    p.add_argument("--frames", type=int, default=None,
                   help="exit after N frames (default: until Ctrl-C)")
    args = p.parse_args(argv)

    srcs = list(args.sources)
    if args.fleet:
        srcs.extend(u for u in discover_fleet(args.fleet)
                    if u not in srcs)
    sources = _expand_sources(srcs)
    if not sources:
        print("error: no sources (empty directory, or no --fleet seed?)",
              file=sys.stderr)
        return 2
    histories = {}
    tails = {src: _StreamTail(src) for kind, src in sources
             if kind == "file"}
    n = 0
    try:
        while True:
            snaps = []
            for kind, src in sources:
                name = (src if kind == "url" else os.path.basename(src))
                snap = (fetch_snapshot(src) if kind == "url"
                        else tails[src].snapshot())
                snaps.append((name, snap))
            frame = render_frame(snaps, histories)
            if args.once:
                sys.stdout.write(frame)
                return 0
            sys.stdout.write(_CLEAR + frame)
            sys.stdout.flush()
            n += 1
            if args.frames is not None and n >= args.frames:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
