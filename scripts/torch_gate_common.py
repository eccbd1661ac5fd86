"""What every end-to-end service gate of the PyTorch port repeats.

The gates (``scripts/torch_*_smoke.py``, run by ``run_torch_gates.sh``
under the ``*_GATE`` names of ``run_tests.sh``) drive the port's own
entry points as subprocesses, the way an operator runs them:
``python -m hyperopt_tpu_torch.service.server`` (alone, ``--fleet``,
``--probe``), ``python -m hyperopt_tpu_torch.service.scrub`` and
``python -m hyperopt_tpu_torch.obs.report``.  This module holds:

* :func:`gate_args`: every gate's ``--device`` (``cuda`` by default, or
  ``$TORCH_GATE_DEVICE``) and its counts, each defaulting to the JAX
  package's gate size;
* :func:`prepare_device`: refuses ``cuda`` without a card and builds the
  CUDA kernels once, before any server process starts, so no ``nvcc``
  lands inside a timed bound and the servers never race on a build;
* :class:`Server`: spawn a server or a fleet replica on ``--device`` and
  wait for its ``SERVICE_URL`` line; SIGKILL it; SIGTERM it and read its
  exit code;
* :func:`request`: raw HTTP that keeps the status, the JSON payload and
  the headers (``Retry-After``) of an error answer;
* :func:`spec_of`: the space of a gate's study, the JAX package's
  uniform space but for one study with a quantized label beside it, so
  that a gate's servers tick both kernels;
* :func:`reference_streams`: the undisturbed in-process
  ``StudyScheduler`` on the same device that a gate's servers are held
  against, and :func:`compare_streams` (bit for bit);
* :func:`check_kernel_counts`: on CUDA the gate's references must have
  launched both hand-written kernels (:func:`run` checks it);
* :func:`lint_metrics`: ``scripts/validate_scrape.py``'s exposition lint
  plus the families a gate needs.

It imports the standard library, ``torch``, the port and
``scripts/validate_scrape.py`` / ``scripts/fleet_restart.py``, nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
for _p in (REPO, SCRIPTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from validate_scrape import validate_metrics_text  # noqa: E402

#: the card tolerance of the parity standard (ROADMAP): a comparison that
#: cannot be bit for bit holds at rtol 1e-4, atol 1e-5 with at most one
#: flipped proposal
CARD_RTOL, CARD_ATOL = 1e-4, 1e-5
#: the uniform space most of the JAX package's gates serve: the default
#: route ticks it in ``fused_sample_ei``
X_SPEC = {"x": {"dist": "uniform", "args": [-5, 5]}}
#: the uniform label beside a quantized one: ``megakernel.supports`` keeps
#: the space off the fused kernel, and its TPE ticks score ``x`` in
#: ``ei_diff`` (a quantized or discrete label takes neither kernel)
EI_DIFF_SPEC = {"x": {"dist": "uniform", "args": [-5, 5]},
                "q": {"dist": "quniform", "args": [0, 4, 1]}}
#: the study of a gate that :func:`spec_of` puts on :data:`EI_DIFF_SPEC`
EI_DIFF_STUDY = 1
#: the kernels' launches in this process's undisturbed references
#: (:func:`reference_streams`), which :func:`run` checks and reports
LAUNCHES = {"ei_diff": 0, "fused_sample_ei": 0}


class GateFailure(AssertionError):
    """A broken contract: the gate prints it and exits 1."""


def log(name, msg):
    print(f"{name}: {msg}", flush=True)


def gate_args(name, doc, argv=None, **counts):
    """Parse ``--device`` and the gate's counts (``--n-studies 8`` for
    ``n_studies=8``; the type follows the default's)."""
    p = argparse.ArgumentParser(prog=f"python scripts/{name}.py", description=doc)
    p.add_argument("--device", default=os.environ.get("TORCH_GATE_DEVICE") or "cuda",
                   help="where the servers and the in-process reference run: the CUDA "
                        "card (default, or $TORCH_GATE_DEVICE) or 'cpu'")
    for key, default in counts.items():
        p.add_argument("--" + key.replace("_", "-"), type=type(default), default=default,
                       help=f"default {default} (the JAX package's gate size)")
    return p.parse_args(argv)


def prepare_device(device):
    """Refuse ``cuda`` without a card (a gate never carries on on the
    CPU unasked); on the card, build every kernel once, here."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("this gate runs the port on the CUDA card by default and "
                               "none is available; pass --device cpu to run it on the CPU")
        from hyperopt_tpu_torch import _build

        _build.build_all()
    elif dev.type != "cpu":
        raise ValueError(f"--device {device!r}: expected cuda or cpu")
    return dev.type


def run(name, main, argv=None):
    """Run a gate's ``main(args) -> figures`` (``figures["device"]`` the
    device it ran on): print ``GATE_RESULT <json>``, with the kernels'
    launches in its references under ``kernels``, and return 0; or print
    the failure and return 1.  On the card a gate whose references did
    not launch both kernels fails (:func:`check_kernel_counts`)."""
    t0 = time.perf_counter()
    try:
        figures = main(argv) or {}
        check_kernel_counts(LAUNCHES, figures.get("device"))
    except GateFailure as e:
        print(f"{name}: FAIL — {e}", file=sys.stderr, flush=True)
        return 1
    figures = {"gate": name, "ok": True, "wall_s": time.perf_counter() - t0, **figures,
               "kernels": dict(LAUNCHES)}
    print("GATE_RESULT " + json.dumps(figures, default=str), flush=True)
    return 0


def check(cond, msg):
    if not cond:
        raise GateFailure(msg)


# -- server processes ---------------------------------------------------------

def server_env(chaos=None, extra=None, drop=()):
    """The environment of a spawned process: this one's, without a chaos
    plan unless ``chaos`` gives one, the watchdog off (a gate's own
    timings are what it reads), and ``extra`` on top."""
    env = dict(os.environ)
    env.pop("HYPEROPT_TPU_CHAOS", None)
    env["HYPEROPT_TPU_WATCHDOG"] = "0"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in drop:
        env.pop(k, None)
    if chaos:
        env["HYPEROPT_TPU_CHAOS"] = chaos
    env.update(extra or {})
    return env


class Server:
    """One ``python -m hyperopt_tpu_torch.service.server`` process on
    ``device``; ``url`` is set once it announced itself.  Its stderr goes
    to a log file whose tail a failure prints."""

    def __init__(self, args, device, chaos=None, extra=None, drop=(), log_dir=None,
                 timeout=180.0, label="server"):
        self.label = label
        log_dir = log_dir or tempfile.mkdtemp(prefix="torch_gate_logs_")
        self.log_path = os.path.join(log_dir, f"{label}.{time.monotonic_ns()}.log")
        self._log = open(self.log_path, "w")
        cmd = [sys.executable, "-m", "hyperopt_tpu_torch.service.server", "--announce",
               "--device", device, *[str(a) for a in args]]
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=server_env(chaos, extra, drop),
                                     stdout=subprocess.PIPE, stderr=self._log, text=True)
        self.url = None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if line.startswith("SERVICE_URL "):
                self.url = line.split(None, 1)[1].strip()
                break
            if not line and self.proc.poll() is not None:
                break
        if self.url is None:
            self.kill()
            raise GateFailure(f"{label} never announced its URL:\n{self.tail()}")

    @property
    def pid(self):
        return self.proc.pid

    @property
    def port(self):
        return self.url.rsplit(":", 1)[1]

    def alive(self):
        return self.proc.poll() is None

    def tail(self, n=2000):
        try:
            with open(self.log_path) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def kill(self):
        """SIGKILL (no drain, no handoff) and reap."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait()
        self._close()

    def term(self, timeout=90.0):
        """SIGTERM and wait for the drain: the exit code, or None when the
        process ignored it (then it is killed)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            return None
        self._close()
        return rc

    def drain_ok(self, timeout=90.0):
        """SIGTERM → drain → exit 0, or a GateFailure naming what it did."""
        check(self.alive(), f"{self.label} died early (rc {self.proc.returncode}):\n"
                            f"{self.tail()}")
        rc = self.term(timeout)
        check(rc is not None, f"{self.label} ignored SIGTERM (the drain hung)")
        check(rc == 0, f"{self.label} drained with exit {rc}, want 0:\n{self.tail()}")

    def _close(self):
        if self.proc.stdout is not None and not self.proc.stdout.closed:
            self.proc.stdout.close()
        if not self._log.closed:
            self._log.close()


def stop_all(servers):
    for s in servers:
        if s is not None and s.alive():
            s.kill()


def run_module(module, args, timeout=300.0, env=None):
    """``python -m <module> <args>`` from the repo root: the completed
    process (stdout and stderr as text)."""
    return subprocess.run([sys.executable, "-m", module, *[str(a) for a in args]],
                          cwd=REPO, env=env or server_env(), capture_output=True, text=True,
                          timeout=timeout)


# -- raw HTTP -------------------------------------------------------------------

class Reply:
    def __init__(self, status, payload, headers, text):
        self.status, self.payload, self.headers, self.text = status, payload, headers, text

    @property
    def retry_after(self):
        return self.headers.get("Retry-After")

    def __repr__(self):
        return f"Reply({self.status}, {self.text[:200]!r})"


def request(url, path, body=None, headers=None, timeout=60.0):
    """One HTTP request (POST with a JSON body, GET without): a
    :class:`Reply` for every status, 4xx and 5xx included, with the
    headers kept (``Retry-After``)."""
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url.rstrip("/") + path, data=data, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, got = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, raw, got = e.code, e.read(), dict(e.headers)
    text = raw.decode("utf-8", "replace")
    try:
        payload = json.loads(text)
    except ValueError:
        payload = None
    return Reply(status, payload, got, text)


def get_json(url, path, timeout=60.0):
    r = request(url, path, timeout=timeout)
    check(r.status == 200, f"GET {path} answered {r.status}: {r.text[:300]}")
    return r.payload


def get_text(url, path, timeout=60.0):
    r = request(url, path, timeout=timeout)
    check(r.status == 200, f"GET {path} answered {r.status}")
    return r.text


def metric(text, name):
    """The first sample of ``name`` on a ``/metrics`` page (0.0 when the
    family is absent)."""
    m = re.search(rf"^{re.escape(name)}(?:{{[^}}]*}})?\s+([0-9.eE+-]+|NaN|[+-]?Inf)$",
                  text, re.M)
    return float(m.group(1)) if m else 0.0


def lint_metrics(text, families=()):
    """The exposition lint's violations, plus every family of
    ``families`` absent from the page."""
    errors = list(validate_metrics_text(text))
    errors += [f"missing family {f}" for f in families if f not in text]
    return errors


def study_rows(urls):
    """The union of the live servers' ``/studies`` tables by study id (a
    dead replica is skipped)."""
    rows = {}
    for url in [urls] if isinstance(urls, str) else urls:
        try:
            r = request(url, "/studies", timeout=30)
        except OSError:
            continue
        if r.status == 200:
            for s in r.payload.get("studies", []):
                rows[s["study_id"]] = s
    return rows


def wait_balanced(urls, timeout=60.0):
    """Block until the replicas at ``urls`` jointly hold every shard and
    each holds at least its floor share: the steward's rebalance after a
    join has settled, so no handoff lands in the middle of what a gate
    measures next.  False on timeout."""
    from fleet_restart import fetch_healthz

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        hz = [fetch_healthz(u) or {} for u in urls]
        n = max((h.get("n_shards") or 0 for h in hz), default=0)
        held = [set(h.get("shards_held") or []) for h in hz]
        if n and len(set().union(*held)) >= n and all(len(s) >= n // len(urls) for s in held):
            return True
        time.sleep(0.2)
    return False


def percentile(values, q):
    vals = sorted(values)
    if not vals:
        return float("nan")
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def client(urls, key=0, retries=20, timeout=60.0, **kw):
    """The port's retrying ``ServiceClient`` (deterministic backoff,
    ``Retry-After`` honoured, 307s followed)."""
    from hyperopt_tpu_torch.retry import RetryPolicy
    from hyperopt_tpu_torch.service import ServiceClient

    policy = RetryPolicy(max_retries=retries, base_delay=0.2, max_delay=2.0)
    return ServiceClient(urls, key=key, timeout=timeout, retry=policy, **kw)


# -- the undisturbed reference -----------------------------------------------

def canon(params):
    """A proposal as the wire carries it: every float as the repr of the
    double the JSON text round-trips to."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, str):
            out.append((k, v))
        elif isinstance(v, (bool, int)) and not isinstance(v, float):
            out.append((k, repr(int(v))))
        else:
            out.append((k, repr(float(v))))
    return tuple(out)


class Study:
    """One gate study: a wire space, a seed, the startup count, a budget
    and the loss the client tells for a proposal."""

    def __init__(self, seed, budget, n_startup, loss, spec=X_SPEC, zoo=None):
        self.seed, self.budget, self.n_startup = seed, budget, n_startup
        self.loss, self.spec, self.zoo = loss, spec, zoo

    def create(self, cl, **kw):
        body = {"zoo": self.zoo} if self.zoo else {"space": self.spec}
        return cl.create_study(seed=self.seed, n_startup_jobs=self.n_startup, **body, **kw)


def spec_of(i):
    """The wire space of a gate's study ``i``: :data:`X_SPEC`, as the JAX
    package's gates serve, but :data:`EI_DIFF_SPEC` for study
    :data:`EI_DIFF_STUDY`.  A gate's servers then tick both kernels on the
    default route, and the streams held bit for bit against the reference
    cover both.  That study's cohort is its own (one ``ei_diff`` label),
    so each of its ticks launches ``ei_diff`` at the reference's shape."""
    return EI_DIFF_SPEC if i == EI_DIFF_STUDY else X_SPEC


def x_loss(offset):
    return lambda params: float((float(params["x"]) - offset) ** 2)


def kernel_counts():
    from hyperopt_tpu_torch import megakernel

    return {"ei_diff": megakernel.ei_diff.launches,
            "fused_sample_ei": megakernel.fused_sample_ei.launches}


@contextlib.contextmanager
def megakernel_route(value):
    """``HYPEROPT_TPU_MEGAKERNEL`` set to ``value`` (None: unset, the
    default fused route) within the block, restored after it."""
    prev = os.environ.pop("HYPEROPT_TPU_MEGAKERNEL", None)
    if value is not None:
        os.environ["HYPEROPT_TPU_MEGAKERNEL"] = value
    try:
        yield
    finally:
        os.environ.pop("HYPEROPT_TPU_MEGAKERNEL", None)
        if prev is not None:
            os.environ["HYPEROPT_TPU_MEGAKERNEL"] = prev


def drive_in_process(studies, device, rounds=None):
    from hyperopt_tpu_torch import zoo as port_zoo
    from hyperopt_tpu_torch.service import StudyScheduler, space_from_spec

    streams = []
    for st in studies:
        sched = StudyScheduler(wal=False, max_studies=64, device=device)
        space = port_zoo.ZOO[st.zoo].space if st.zoo else space_from_spec(st.spec)
        sid = sched.create_study(space, seed=st.seed, n_startup_jobs=st.n_startup)
        seq = []
        for _ in range(rounds if rounds is not None else st.budget):
            a = sched.ask(sid)[0]
            sched.tell(sid, a["tid"], st.loss(a["params"]))
            seq.append((a["tid"], canon(a["params"])))
        streams.append(seq)
        sched.drain(timeout=5.0)
    return streams


def reference_streams(studies, device, rounds=None):
    """The undisturbed in-process reference of a gate: each study alone in
    a ``StudyScheduler`` on ``device`` (no store, no WAL, no fault), on the
    servers' default route, asked and told one trial at a time, ``rounds``
    (default: its budget) times.  Returns per study the ``(tid,
    proposal)`` sequence.  The kernels' counters are set to 0 just before
    the run and added to :data:`LAUNCHES` just after it, so only the runs
    that the servers' streams are held against count."""
    import torch

    from hyperopt_tpu_torch import megakernel

    megakernel.ei_diff.launches = megakernel.fused_sample_ei.launches = 0
    with megakernel_route(None):
        streams = drive_in_process(studies, device, rounds)
    for k, v in kernel_counts().items():
        LAUNCHES[k] += v
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return streams


def check_kernel_counts(counts, device):
    """On CUDA a gate's references must have launched both hand-written
    kernels: a stream equal to them bit for bit was proposed by the same
    kernels.  On the CPU the wrappers take their plain versions and count
    nothing."""
    if device != "cuda":
        return
    for k in ("ei_diff", "fused_sample_ei"):
        check(counts.get(k, 0) > 0, f"the in-process reference launched {k} "
                                    f"{counts.get(k, 0)} times on the card: the gate's "
                                    "path never reached the hand-written kernel")


def compare_streams(got, want, label="study"):
    """Bit for bit: the indices (and a line each) of the streams that
    differ; ``got[i]`` None means the study never finished."""
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            bad.append(f"{label} {i} diverged:\n  got  {g}\n  want {w}")
    check(len(got) == len(want), f"{len(got)} streams against {len(want)}")
    return bad


def tolerant_flips(got, want, rtol=CARD_RTOL, atol=CARD_ATOL):
    """The proposals where ``got`` leaves ``want`` beyond the card
    tolerance: a study is compared up to its first flip (its history
    differs after it).  Tids must match exactly."""
    flips = []
    for i, (g, w) in enumerate(zip(got, want)):
        for j, ((tg, pg), (tw, pw)) in enumerate(zip(g, w)):
            check(tg == tw, f"study {i} trial {j}: tid {tg} against {tw}")
            if pg == pw:
                continue
            if [k for k, _ in pg] != [k for k, _ in pw] or not all(
                    _close(a, b, rtol, atol) for (_, a), (_, b) in zip(pg, pw)):
                flips.append((i, j, pg, pw))
                break
    return flips


def _close(a, b, rtol, atol):
    """``numpy.isclose``'s rule on two canonical values (strings stay exact)."""
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except ValueError:
        return False
    return abs(fa - fb) <= atol + rtol * abs(fb)
