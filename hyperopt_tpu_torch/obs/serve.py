"""Prometheus exposition of the metrics registries (counterpart of the
parts of ``hyperopt_tpu/obs/serve.py`` the service's HTTP server uses,
copied: host-only).

:func:`prometheus_text` renders every ``MetricsRegistry`` namespace in
the text exposition format, line for line as the JAX package does
(counters as ``_total``, histograms as summaries with quantile labels,
the namespace as a label); :func:`split_hostport` parses a bind value.
The standalone scrape server behind ``fmin(obs_http=...)`` and its
``/snapshot`` headline sections come with the run-level planes
(ROADMAP.md, queue 1, item 14): ``fmin``'s ``obs_http`` option raises
``not_ported(..., 14)``.
"""

from __future__ import annotations

import re

from .metrics import Counter, Gauge, Histogram, all_namespaces, get_metrics

__all__ = ["prometheus_text", "split_hostport"]

_NAME_PREFIX = "hyperopt_tpu_"
_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name):
    """Registry metric name → valid Prometheus metric name (dots and any
    other illegal characters collapse to underscores)."""
    out = _NAME_PREFIX + _NAME_SANITIZE.sub("_", str(name))
    if not _NAME_OK.match(out):  # e.g. a leading digit after the prefix
        out = _NAME_PREFIX + "_" + _NAME_SANITIZE.sub("_", str(name))
    return out


def _label_value(v):
    """Escape a label VALUE per the exposition format (backslash, quote,
    newline)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v):
    if v is None:
        return "NaN"
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def prometheus_text(namespaces=None):
    """The whole process's metrics as Prometheus text exposition format.

    One metric family per (sanitized) registry metric name; the registry
    namespace rides as a ``namespace`` label so concurrent runs stay
    distinguishable.  Counters expose ``_total``, histograms become
    summaries (``quantile`` series + ``_sum``/``_count``), gauges map
    directly.  Built from live registry objects — a scrape never touches
    JSONL or the hot path.
    """
    if namespaces is None:
        namespaces = all_namespaces()
    families = {}  # prom name -> {"type": ..., "samples": [line, ...]}
    for ns in namespaces:
        label = f'namespace="{_label_value(ns)}"'
        for name, m in get_metrics(ns).iter_metrics():
            pname = _metric_name(name)
            if isinstance(m, Counter):
                fam = families.setdefault(pname + "_total",
                                          {"type": "counter", "samples": []})
                fam["samples"].append(
                    f"{pname}_total{{{label}}} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                fam = families.setdefault(pname,
                                          {"type": "summary", "samples": []})
                snap = m.snapshot()
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    if key in snap:
                        fam["samples"].append(
                            f'{pname}{{{label},quantile="{q}"}} '
                            f"{_fmt(snap[key])}")
                fam["samples"].append(
                    f"{pname}_sum{{{label}}} {_fmt(snap.get('sum', 0.0))}")
                fam["samples"].append(
                    f"{pname}_count{{{label}}} {_fmt(snap.get('count', 0))}")
            elif isinstance(m, Gauge):
                fam = families.setdefault(pname,
                                          {"type": "gauge", "samples": []})
                fam["samples"].append(f"{pname}{{{label}}} {_fmt(m.value)}")
    lines = []
    for pname in sorted(families):
        fam = families[pname]
        # the classic text/plain; version=0.0.4 format keys metadata by
        # the literal sample name, so a counter's TYPE line must name the
        # `_total` family itself (the base-name split is OpenMetrics-only)
        lines.append(f"# TYPE {pname} {fam['type']}")
        lines.extend(fam["samples"])
    return "\n".join(lines) + ("\n" if lines else "")


def split_hostport(value, default_host="127.0.0.1"):
    """``9109`` / ``"9109"`` / ``"0.0.0.0:9109"`` → ``(host, port)``.  The
    default binds loopback (scraping a sweep must be opt-in exposure);
    ``host:port`` opens it to a remote Prometheus / ``obs.top``."""
    if isinstance(value, str) and ":" in value:
        host, port = value.rsplit(":", 1)
        return host or default_host, int(port)
    return default_host, int(value)
