"""User-facing ``hp.*`` search-space constructors (counterpart of
``hyperopt_tpu/hp.py``).

Parity target: ``hyperopt/hp.py`` + ``hyperopt/pyll_utils.py`` (sym:
hp_choice, hp_pchoice, hp_randint, hp_uniform, hp_quniform, hp_uniformint,
hp_loguniform, hp_qloguniform, hp_normal, hp_qnormal, hp_lognormal,
hp_qlognormal, validate_label).

Semantics (matching the reference's stochastic nodes):

* ``uniform(label, low, high)`` — float in [low, high].
* ``quniform(label, low, high, q)`` — ``round(uniform/q)*q``.
* ``uniformint(label, low, high)`` — integer in [low, high] inclusive.
* ``loguniform(label, low, high)`` — ``exp(uniform(low, high))``; low/high are
  bounds of the *log* of the return value.
* ``normal/lognormal`` — mu/sigma of the (underlying) normal.
* ``randint(label, upper)`` or ``randint(label, low, high)`` — int in [0,upper)
  / [low, high).
* ``choice(label, options)`` — one of options; trial value is the index.
* ``pchoice(label, [(p, option), ...])`` — weighted choice.
"""

from __future__ import annotations

import numpy as np

from .exceptions import InvalidAnnotatedParameter
from .spaces import Choice, Dist, Param, as_expr

__all__ = [
    "choice",
    "pchoice",
    "randint",
    "uniform",
    "quniform",
    "uniformint",
    "loguniform",
    "qloguniform",
    "normal",
    "qnormal",
    "lognormal",
    "qlognormal",
]


def _validate_label(label):
    if not isinstance(label, str):
        raise InvalidAnnotatedParameter(f"label must be a string, got {label!r}")
    return label


def _f(x, name, label):
    try:
        return float(x)
    except (TypeError, ValueError):
        raise InvalidAnnotatedParameter(f"{name} for {label!r} must be numeric, got {x!r}")


def choice(label, options):
    _validate_label(label)
    options = list(options)
    if len(options) == 0:
        raise InvalidAnnotatedParameter(f"choice {label!r} needs at least one option")
    return Choice(label, tuple(as_expr(o) for o in options))


def pchoice(label, p_options):
    _validate_label(label)
    ps, options = [], []
    for pair in p_options:
        try:
            p, opt = pair
        except (TypeError, ValueError):
            raise InvalidAnnotatedParameter(
                f"pchoice {label!r} expects (probability, option) pairs, got {pair!r}"
            )
        ps.append(_f(p, "probability", label))
        options.append(opt)
    total = float(np.sum(ps))
    if not np.isclose(total, 1.0, atol=1e-6):
        raise InvalidAnnotatedParameter(
            f"pchoice {label!r} probabilities sum to {total}, expected 1.0"
        )
    return Choice(label, tuple(as_expr(o) for o in options), p=tuple(ps))


def randint(label, *args):
    _validate_label(label)
    if len(args) == 1:
        low, high = 0.0, _f(args[0], "upper", label)
    elif len(args) == 2:
        low, high = _f(args[0], "low", label), _f(args[1], "high", label)
    else:
        raise InvalidAnnotatedParameter(f"randint {label!r} takes (upper) or (low, high)")
    if high <= low:
        raise InvalidAnnotatedParameter(f"randint {label!r}: empty range [{low}, {high})")
    return Param(label, Dist("randint", (low, high)), cast="int")


def uniform(label, low, high):
    _validate_label(label)
    return Param(label, Dist("uniform", (_f(low, "low", label), _f(high, "high", label))))


def quniform(label, low, high, q):
    _validate_label(label)
    return Param(
        label,
        Dist("quniform", (_f(low, "low", label), _f(high, "high", label), _f(q, "q", label))),
    )


def uniformint(label, low, high, q=1):
    _validate_label(label)
    if _f(q, "q", label) != 1:
        raise InvalidAnnotatedParameter(f"uniformint {label!r} only supports q=1")
    return Param(
        label, Dist("uniformint", (_f(low, "low", label), _f(high, "high", label))), cast="int"
    )


def loguniform(label, low, high):
    _validate_label(label)
    return Param(label, Dist("loguniform", (_f(low, "low", label), _f(high, "high", label))))


def qloguniform(label, low, high, q):
    _validate_label(label)
    return Param(
        label,
        Dist("qloguniform", (_f(low, "low", label), _f(high, "high", label), _f(q, "q", label))),
    )


def normal(label, mu, sigma):
    _validate_label(label)
    return Param(label, Dist("normal", (_f(mu, "mu", label), _f(sigma, "sigma", label))))


def qnormal(label, mu, sigma, q):
    _validate_label(label)
    return Param(
        label,
        Dist("qnormal", (_f(mu, "mu", label), _f(sigma, "sigma", label), _f(q, "q", label))),
    )


def lognormal(label, mu, sigma):
    _validate_label(label)
    return Param(label, Dist("lognormal", (_f(mu, "mu", label), _f(sigma, "sigma", label))))


def qlognormal(label, mu, sigma, q):
    _validate_label(label)
    return Param(
        label,
        Dist("qlognormal", (_f(mu, "mu", label), _f(sigma, "sigma", label), _f(q, "q", label))),
    )
