"""JSON-wire search-space schema for the ask/tell service (counterpart of
``hyperopt_tpu/service/spacespec.py``, copied: host-only).

A study arrives over HTTP, so its search space must travel as data.  The
schema mirrors the ``hp.*`` constructors one-to-one — each node is
``{"dist": <family>, "args": [...]}`` keyed by its label, families taking
options use ``"options"`` — and :func:`space_from_spec` rebuilds the
exact ``hp`` expression tree::

    {"x":   {"dist": "uniform", "args": [-5, 5]},
     "lr":  {"dist": "loguniform", "args": [-6, 0]},
     "opt": {"dist": "choice", "options": [0, 1, 2]},
     "head": {"dist": "choice",
              "options": [{"width": {"dist": "uniformint",
                                     "args": [1, 8]}},
                          "linear"]}}

``choice`` / ``pchoice`` options may be scalars or nested sub-space
mappings (labels must stay unique across branches — the same
``DuplicateLabel`` contract every ``hp`` space has).  Unknown families
raise :class:`SpaceSpecError`, which the server maps to HTTP 400.

Robustness: the schema arrives from UNTRUSTED clients, so
every malformed or hostile shape must answer 400 with a typed message —
never a 500, never a hung/exploding server.  Beyond type checks, three
resource bounds cap what one request can make the compiler chew on:
nesting depth (``MAX_DEPTH`` — also the guard that turns a cyclic
mapping, impossible over the wire but possible via the Python API, into
a clean error instead of a ``RecursionError``), total parameter count
(``MAX_LABELS``) and per-choice option count (``MAX_OPTIONS``).  Labels
must be non-empty strings of sane length (``MAX_LABEL_LEN``).
"""

from __future__ import annotations

from .. import hp

__all__ = ["SpaceSpecError", "space_from_spec", "SPEC_FAMILIES",
           "MAX_DEPTH", "MAX_LABELS", "MAX_OPTIONS", "MAX_LABEL_LEN"]


class SpaceSpecError(ValueError):
    """Malformed space spec (HTTP 400, never a 500)."""


#: deepest allowed nesting of choice sub-spaces (a cyclic dict passed via
#: the Python API exhausts this bound long before the recursion limit)
MAX_DEPTH = 16
#: most parameters one study's space may declare, across all branches
MAX_LABELS = 512
#: most options one choice/pchoice may carry
MAX_OPTIONS = 1024
#: longest allowed label string
MAX_LABEL_LEN = 200


#: family name -> (hp constructor, positional arg count[s])
SPEC_FAMILIES = {
    "uniform": (hp.uniform, (2,)),
    "quniform": (hp.quniform, (3,)),
    "uniformint": (hp.uniformint, (2, 3)),
    "loguniform": (hp.loguniform, (2,)),
    "qloguniform": (hp.qloguniform, (3,)),
    "normal": (hp.normal, (2,)),
    "qnormal": (hp.qnormal, (3,)),
    "lognormal": (hp.lognormal, (2,)),
    "qlognormal": (hp.qlognormal, (3,)),
    "randint": (hp.randint, (1, 2)),
}


def _check_label(label):
    if not isinstance(label, str) or not label:
        raise SpaceSpecError(
            f"param labels must be non-empty strings, got {label!r}")
    if len(label) > MAX_LABEL_LEN:
        raise SpaceSpecError(
            f"param label too long ({len(label)} > {MAX_LABEL_LEN} chars)")


def _node_from_spec(label, node, depth, counts):
    if not isinstance(node, dict) or "dist" not in node:
        raise SpaceSpecError(
            f"param {label!r}: expected {{'dist': ..., ...}}, got "
            f"{type(node).__name__}")
    fam = node["dist"]
    if not isinstance(fam, str):
        raise SpaceSpecError(
            f"param {label!r}: 'dist' must be a string, got "
            f"{type(fam).__name__}")
    if fam in ("choice", "pchoice"):
        options = node.get("options")
        if not isinstance(options, list) or not options:
            raise SpaceSpecError(
                f"param {label!r}: {fam} needs a non-empty 'options' list")
        if len(options) > MAX_OPTIONS:
            raise SpaceSpecError(
                f"param {label!r}: {fam} has {len(options)} options "
                f"(limit {MAX_OPTIONS})")
        if fam == "choice":
            return hp.choice(label, [_option(label, o, depth, counts)
                                     for o in options])
        try:
            pairs = [(float(p), _option(label, o, depth, counts))
                     for p, o in options]
        except SpaceSpecError:
            raise
        except (TypeError, ValueError) as e:
            raise SpaceSpecError(
                f"param {label!r}: pchoice options must be "
                f"[probability, option] pairs ({e})") from None
        return hp.pchoice(label, pairs)
    entry = SPEC_FAMILIES.get(fam)
    if entry is None:
        raise SpaceSpecError(
            f"param {label!r}: unknown family {fam!r} "
            f"(one of {sorted(SPEC_FAMILIES) + ['choice', 'pchoice']})")
    fn, arities = entry
    args = node.get("args", [])
    if not isinstance(args, list) or len(args) not in arities:
        raise SpaceSpecError(
            f"param {label!r}: {fam} takes {' or '.join(map(str, arities))} "
            f"args, got {args!r}")
    try:
        return fn(label, *[float(a) for a in args])
    except (TypeError, ValueError) as e:
        raise SpaceSpecError(f"param {label!r}: {e}") from None


def _option(label, opt, depth, counts):
    """A choice option: a scalar literal or a nested sub-space mapping."""
    if isinstance(opt, dict):
        if "dist" in opt:
            raise SpaceSpecError(
                f"param {label!r}: a bare distribution cannot be a choice "
                "option — wrap it in a labeled sub-space mapping")
        return _space_from_spec(opt, depth + 1, counts)
    if isinstance(opt, (int, float, str, bool)) or opt is None:
        return opt
    raise SpaceSpecError(
        f"param {label!r}: option of type {type(opt).__name__} is neither "
        "a scalar nor a sub-space mapping")


def _space_from_spec(spec, depth, counts):
    if depth > MAX_DEPTH:
        raise SpaceSpecError(
            f"space spec nests deeper than {MAX_DEPTH} levels "
            "(cyclic or hostile schema)")
    if not isinstance(spec, dict) or not spec:
        raise SpaceSpecError(
            f"space spec must be a non-empty mapping, got "
            f"{type(spec).__name__}")
    out = {}
    for label, node in spec.items():
        _check_label(label)
        counts["labels"] += 1
        if counts["labels"] > MAX_LABELS:
            raise SpaceSpecError(
                f"space spec declares more than {MAX_LABELS} parameters")
        out[label] = _node_from_spec(label, node, depth, counts)
    return out


def space_from_spec(spec):
    """Rebuild an ``hp`` space from its JSON-wire form (see module
    docstring).  ``spec`` is a ``{label: node}`` mapping; any malformed
    or over-limit shape raises :class:`SpaceSpecError` (HTTP 400)."""
    return _space_from_spec(spec, 0, {"labels": 0})
