"""Request-scoped trace context for the serving plane (counterpart of
``hyperopt_tpu/obs/reqtrace.py``, copied: host-only).

Every other observability layer is *run*-scoped: spans,
metrics, the flight ring, the profiler and the trajectory all describe
what one process did, never which *request* it did it for.  This module
is the missing identity: a W3C-``traceparent``-style context — a 128-bit
trace id naming one logical client request and a 64-bit span id naming
one hop of it — carried across threads on a ``contextvars.ContextVar``
so the HTTP handler, the wave ticker and the WAL writer all see the same
ids without plumbing an argument through every signature.

Wire format (the ``traceparent`` request header, W3C Trace Context)::

    00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01
    ^v ^ trace-id (32 lowercase hex)    ^ span-id (16)    ^ flags

Parsing is *strict but never fatal*: a malformed header — wrong version,
short/non-hex ids, all-zero ids, oversized value, control bytes — makes
:func:`parse` return ``None`` and the server degrades to a freshly
minted trace (the request is still served; hostile headers must never
4xx/5xx a request that is otherwise fine).  That contract is pinned by
the tests/test_reqtrace.py fuzz corpus.

Determinism contract: trace ids are pure metadata.  They are minted
from a module-private per-thread generator seeded from ``os.urandom``
(never from any RNG a proposal depends on), never fed
into a seed, and never change what the optimizer proposes — armed
tracing produces byte-identical proposals to disarmed (pinned).
Disarmed (``HYPEROPT_TPU_REQTRACE=0``), nothing here runs at all: no
context is minted, no header sent, no WAL field stamped, zero threads
either way.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import string
import threading

__all__ = [
    "TraceContext",
    "TRACEPARENT",
    "mint",
    "parse",
    "child",
    "extract_or_mint",
    "current",
    "current_trace_id",
    "use",
    "sanitize_request_id",
]

#: the request/response header name (lower-cased — the server's header
#: mapping is lower-cased at ingress)
TRACEPARENT = "traceparent"

#: hard bound on header values we even look at: a multi-KB "traceparent"
#: is an attack or a bug, not a trace
_MAX_HEADER = 256

#: X-Request-Id values are opaque client tokens; the server echoes them
#: back and logs them, so they must be printable and bounded
_MAX_REQUEST_ID = 128
_REQUEST_ID_OK = set(string.ascii_letters + string.digits + "-_.:+/=")

_HEX = set("0123456789abcdef")


class TraceContext:
    """One hop of one logical request: ``trace_id`` (32 lowercase hex)
    names the request end to end, ``span_id`` (16 hex) names this hop,
    ``parent_id`` the hop that caused it (None at the root)."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id, span_id, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def traceparent(self):
        """The wire form (version 00, sampled flag set)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self):
        return (f"TraceContext({self.trace_id[:8]}../{self.span_id}"
                + (f" <- {self.parent_id}" if self.parent_id else "") + ")")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id)

    def __hash__(self):
        return hash((self.trace_id, self.span_id))


_local = threading.local()


def _rng():
    """Per-thread id generator, seeded once from ``os.urandom`` (and
    re-seeded after ``fork`` — the pid check — so worker processes never
    clone a parent's id stream).  Trace ids need global *uniqueness*,
    not cryptographic secrecy, and ``os.urandom`` is a syscall that
    costs tens of microseconds on older kernels — far too slow to pay
    twice per served request.  This generator is PRIVATE to the module:
    it never touches (and is never touched by) any RNG a proposal
    depends on."""
    pid = os.getpid()
    rng = getattr(_local, "rng", None)
    if rng is None or getattr(_local, "pid", None) != pid:
        rng = _local.rng = random.Random(
            (int.from_bytes(os.urandom(16), "big") << 64)
            ^ (pid << 32) ^ threading.get_ident())
        _local.pid = pid
    return rng


def mint():
    """A fresh root context.  All-zero ids are invalid on the wire, and
    128/64 random bits make one astronomically unlikely; re-draw anyway
    so the invariant is unconditional."""
    rng = _rng()
    tid = "%032x" % rng.getrandbits(128)
    while tid == "0" * 32:  # pragma: no cover - 2^-128
        tid = "%032x" % rng.getrandbits(128)
    return TraceContext(tid, _new_span_id())


def _new_span_id():
    rng = _rng()
    sid = "%016x" % rng.getrandbits(64)
    while sid == "0" * 16:  # pragma: no cover - 2^-64
        sid = "%016x" % rng.getrandbits(64)
    return sid


def child(ctx):
    """Same trace, fresh span, parented on ``ctx``'s span — one retry
    attempt, one handler hop."""
    return TraceContext(ctx.trace_id, _new_span_id(),
                        parent_id=ctx.span_id)


def _is_hex(s):
    return all(c in _HEX for c in s)


def parse(header):
    """Strict ``traceparent`` parse → :class:`TraceContext`, or ``None``
    on ANY malformation (the caller degrades to a fresh trace — a
    hostile header must never fail the request it rides on).

    Accepted: ``vv-<32 hex>-<16 hex>-<2 hex>`` where ``vv`` is two hex
    digits and not ``ff`` (the W3C invalid version); versions above 00
    may carry a ``-``-prefixed suffix (forward compat), which is
    ignored.  Hex must be lowercase (the spec's wire form); all-zero
    trace or span ids are invalid."""
    if not isinstance(header, str):
        return None
    if not header or len(header) > _MAX_HEADER:
        return None
    if any(ord(c) < 0x20 or ord(c) > 0x7E for c in header):
        return None  # control bytes / non-ASCII: hostile, not a trace
    parts = header.split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(parts) > 4 and version == "00":
        return None  # version 00 has exactly four fields
    if len(trace_id) != 32 or not _is_hex(trace_id):
        return None
    if len(span_id) != 16 or not _is_hex(span_id):
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def extract_or_mint(header):
    """The server's ingress rule: a valid inbound ``traceparent``
    continues the caller's trace (fresh span, parented on theirs); a
    missing or malformed one degrades to a fresh root trace.  Never
    raises, never refuses the request."""
    ctx = parse(header)
    if ctx is not None:
        return child(ctx)
    return mint()


def sanitize_request_id(value):
    """``X-Request-Id`` is an opaque client token we echo and log — but
    only when it is bounded and printable-safe.  Returns the value or
    ``None`` (hostile/oversized ids are dropped, never an error)."""
    if not isinstance(value, str) or not value:
        return None
    if len(value) > _MAX_REQUEST_ID:
        return None
    if any(c not in _REQUEST_ID_OK for c in value):
        return None
    return value


# ---------------------------------------------------------------------------
# ambient context (contextvar — correct across the threaded HTTP server
# AND the scheduler's wave handoff, where explicit fields take over)
# ---------------------------------------------------------------------------

_current: contextvars.ContextVar = contextvars.ContextVar(
    "hyperopt_tpu_torch_reqtrace", default=None)


def current():
    """The active :class:`TraceContext`, or ``None`` (tracing disarmed,
    or not inside a traced request)."""
    return _current.get()


def current_trace_id():
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else None


@contextlib.contextmanager
def use(ctx):
    """Install ``ctx`` as the ambient context for the block.  ``None``
    is allowed and makes the block a no-op — callers never need to
    branch on whether tracing is armed."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)
