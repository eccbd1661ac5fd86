"""Typed search-space IR and its batched prior sampler on torch.

Counterpart of ``hyperopt_tpu/spaces.py``.  A space is a small static
expression tree (``Param`` leaves, ``Choice`` branch points, arithmetic
``Op`` nodes, containers, literals).  ``CompiledSpace.sample_flat`` draws
every parameter for a batch of keys ``[B, 2]`` at once; conditional
parameters are drawn unconditionally and an active mask per label is
derived from the drawn choice indices, as in the JAX package.

RNG: each label folds a stable CRC32 hash into the per-trial key, so every
draw is a function of (seed, trial id, label) only and matches the JAX
package's ``draw_dist`` bit for bit where the draw needs no transcendental
(uniform families, randint); normal and categorical draws match to a few
ulp (``erfinv``/``log``).
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable

import numpy as np
import torch

from . import prng
from ._env import resolve_device
from .exceptions import DuplicateLabel, InvalidAnnotatedParameter
from .utils import device_constant

__all__ = [
    "Expr",
    "Literal",
    "Op",
    "Container",
    "Param",
    "Choice",
    "Dist",
    "ParamInfo",
    "CompiledSpace",
    "as_expr",
    "compile_space",
    "draw_dist",
    "draw_dist_group",
    "sample",
    "space_eval",
    "label_hash",
    "rng_to_key",
    "expr_to_config",
]

# Families whose flat value is integral: branch indices and ints.
INT_FAMILIES = frozenset({"randint", "uniformint", "categorical"})


def label_hash(label: str) -> int:
    """Stable 31-bit hash of a parameter label, used to fold RNG keys."""
    return zlib.crc32(label.encode("utf-8")) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# Expression tree
# ---------------------------------------------------------------------------


class Expr:
    """Base class for space expressions; supports the arithmetic dunders of
    the reference's ``Apply`` so ``hp.uniform('x', 0, 1) + 1`` works."""

    def __add__(self, other):
        return Op("add", (self, as_expr(other)))

    def __radd__(self, other):
        return Op("add", (as_expr(other), self))

    def __sub__(self, other):
        return Op("sub", (self, as_expr(other)))

    def __rsub__(self, other):
        return Op("sub", (as_expr(other), self))

    def __mul__(self, other):
        return Op("mul", (self, as_expr(other)))

    def __rmul__(self, other):
        return Op("mul", (as_expr(other), self))

    def __truediv__(self, other):
        return Op("truediv", (self, as_expr(other)))

    def __rtruediv__(self, other):
        return Op("truediv", (as_expr(other), self))

    def __floordiv__(self, other):
        return Op("floordiv", (self, as_expr(other)))

    def __pow__(self, other):
        return Op("pow", (self, as_expr(other)))

    def __rpow__(self, other):
        return Op("pow", (as_expr(other), self))

    def __neg__(self):
        return Op("neg", (self,))

    def __abs__(self):
        return Op("abs", (self,))

    def __getitem__(self, idx):
        return Op("getitem", (self, as_expr(idx)))


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    """A constant embedded in the space."""

    value: Any


@dataclasses.dataclass(frozen=True)
class Op(Expr):
    """A pure elementwise operation over sub-expressions."""

    op: str
    args: tuple

    def __post_init__(self):
        if self.op not in _OP_TABLE:
            raise InvalidAnnotatedParameter(f"unknown op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class Container(Expr):
    """dict / list / tuple of sub-expressions."""

    kind: str  # 'dict' | 'list' | 'tuple'
    keys: tuple  # dict keys ('' entries for list/tuple)
    children: tuple


@dataclasses.dataclass(frozen=True)
class Dist(Expr):
    """A distribution spec: family name + flat numeric params."""

    family: str
    params: tuple


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    """A labeled hyperparameter."""

    label: str
    dist: Dist
    cast: str = "float"  # 'float' | 'int'


@dataclasses.dataclass(frozen=True)
class Choice(Expr):
    """A conditional branch point: ``hp.choice`` / ``hp.pchoice``.  The
    selector is itself a parameter (randint for choice, categorical for
    pchoice) and the options are sub-expressions."""

    label: str
    options: tuple
    p: tuple | None = None

    @property
    def selector_dist(self) -> Dist:
        n = len(self.options)
        if self.p is None:
            return Dist("randint", (0.0, float(n)))
        return Dist("categorical", tuple(float(x) for x in self.p))


def as_expr(obj: Any) -> Expr:
    """Convert a python structure into an Expr."""
    if isinstance(obj, Expr):
        return obj
    if isinstance(obj, dict):
        keys = tuple(sorted(obj.keys()))
        return Container("dict", keys, tuple(as_expr(obj[k]) for k in keys))
    if isinstance(obj, (list, tuple)):
        kind = "list" if isinstance(obj, list) else "tuple"
        return Container(kind, tuple("" for _ in obj), tuple(as_expr(o) for o in obj))
    return Literal(obj)


_OP_TABLE: dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b,
    "floordiv": lambda a, b: a // b,
    "pow": lambda a, b: a**b,
    "neg": lambda a: -a,
    "abs": lambda a: abs(a),
    "getitem": lambda a, i: a[i],
    "exp": np.exp,
    "log": np.log,
    "sqrt": np.sqrt,
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "maximum": np.maximum,
    "minimum": np.minimum,
}


def _torch_unary(fn, host):
    """A torch op for tensors; a host value (a literal) keeps the host op."""
    return lambda x: fn(x) if torch.is_tensor(x) else host(x)


def _torch_extreme(fn, bound):
    """``torch.maximum``/``minimum`` that also takes a Python number on
    either side (as a clamp bound, so no tensor is made for it)."""

    def f(a, b):
        if torch.is_tensor(a) and torch.is_tensor(b):
            return fn(a, b)
        if torch.is_tensor(a) or torch.is_tensor(b):
            t, s = (a, b) if torch.is_tensor(a) else (b, a)
            return torch.clamp(t, **{bound: s})
        return _OP_TABLE[fn.__name__](a, b)

    return f


# the traced assemble's ops (the JAX package's _OP_TABLE_JNP): torch ops on
# the 0-d tensors of a traced flat sample
_OP_TABLE_TORCH: dict[str, Callable] = dict(
    _OP_TABLE,
    **{name: _torch_unary(getattr(torch, name), _OP_TABLE[name])
       for name in ("exp", "log", "sqrt", "sin", "cos", "tan")},
    maximum=_torch_extreme(torch.maximum, "min"),
    minimum=_torch_extreme(torch.minimum, "max"),
)


def _make_unary(name):
    def f(x):
        return Op(name, (as_expr(x),))

    f.__name__ = name
    return f


def _make_binary(name):
    def f(a, b):
        return Op(name, (as_expr(a), as_expr(b)))

    f.__name__ = name
    return f


exp = _make_unary("exp")
log = _make_unary("log")
sqrt = _make_unary("sqrt")
sin = _make_unary("sin")
cos = _make_unary("cos")
tan = _make_unary("tan")
maximum = _make_binary("maximum")
minimum = _make_binary("minimum")


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    """One hyperparameter: its distribution, cast and activation path
    ``((choice_label, branch_index), ...)``."""

    label: str
    dist: Dist
    cast: str
    conditions: tuple

    @property
    def is_int(self) -> bool:
        return self.dist.family in INT_FAMILIES or self.cast == "int"


class CompiledSpace:
    """A search space lowered to a param table plus batched samplers:

    * ``sample_flat(keys[B, 2]) -> {label: tensor[B]}`` — draw every parameter.
    * ``active_flat(flat) -> {label: bool}`` — activation masks.
    * ``assemble(flat)`` — rebuild the user-facing structure (host).
    """

    def __init__(self, expr: Expr):
        self.expr = expr
        self.params: dict[str, ParamInfo] = {}
        self._collect(expr, ())
        self.labels: tuple[str, ...] = tuple(self.params.keys())

    def signature(self):
        """Canonical hashable key of the param table; the suggesters key
        their per-space caches on it."""
        sig = getattr(self, "_signature", None)
        if sig is None:
            sig = self._signature = tuple(
                (i.label, i.dist.family, i.dist.params, i.cast, i.conditions)
                for i in self.params.values()
            )
        return sig

    def _add_param(self, label: str, dist: Dist, cast: str, conditions: tuple):
        if not isinstance(label, str):
            raise InvalidAnnotatedParameter(f"label must be a string: {label!r}")
        if label in self.params:
            raise DuplicateLabel(label)
        info = ParamInfo(label, dist, cast, conditions)
        if info.is_int:
            _check_f32_exact_int(info)
        self.params[label] = info

    def _collect(self, node: Expr, conditions: tuple):
        if isinstance(node, Param):
            self._add_param(node.label, node.dist, node.cast, conditions)
        elif isinstance(node, Choice):
            self._add_param(node.label, node.selector_dist, "int", conditions)
            for i, opt in enumerate(node.options):
                self._collect(opt, conditions + ((node.label, i),))
        elif isinstance(node, Op):
            for a in node.args:
                self._collect(a, conditions)
        elif isinstance(node, Container):
            for c in node.children:
                self._collect(c, conditions)
        elif not isinstance(node, Literal):
            raise InvalidAnnotatedParameter(f"not a space expression: {node!r}")

    def _sample_groups(self):
        """Labels grouped for batched prior draws: same family (and, for
        categorical, same bucket count); order follows ``self.labels``."""
        groups = getattr(self, "_sample_groups_cache", None)
        if groups is None:
            groups = {}
            for label, info in self.params.items():
                fam = info.dist.family
                gkey = (fam, len(info.dist.params)) if fam == "categorical" else fam
                groups.setdefault(gkey, []).append(label)
            self._sample_groups_cache = groups
        return groups

    def sample_flat(self, keys) -> dict:
        """Draw every parameter for each key of ``keys[B, 2]``.

        Same-family labels draw through one batched call
        (:func:`draw_dist_group`) that is bitwise identical per label to
        :func:`draw_dist` (same ``fold_in`` keys, same formulas)."""
        out = {}
        for _, labels in self._sample_groups().items():
            if len(labels) == 1:
                label = labels[0]
                k = prng.fold_in(keys, label_hash(label))
                out[label] = draw_dist(self.params[label].dist, k)
                continue
            hashes = device_constant([label_hash(l) for l in labels], torch.int64,
                                     keys.device)
            gkeys = prng.fold_in(keys[None, :, :], hashes[:, None])  # [G, B, 2]
            vals = draw_dist_group([self.params[l].dist for l in labels], gkeys)
            for i, label in enumerate(labels):
                out[label] = vals[i]
        return {label: out[label] for label in self.labels}

    def active_flat(self, flat: dict) -> dict:
        """Activation per label, from the drawn choice indices: Python bools
        for host values, bool tensors for tensor values."""
        out = {}
        for label, info in self.params.items():
            act = True
            for (clabel, idx) in info.conditions:
                act = act & (flat[clabel] == idx)
            out[label] = bool(act) if isinstance(act, (bool, np.bool_)) else act
        return out

    def assemble(self, flat: dict, *, traced: bool = False):
        """Rebuild the user-facing structure from flat per-label values.

        Host mode picks each choice's branch by its index.  Traced mode
        (flat values are 0-d tensors, as the device loop and
        ``Domain.make_batch_eval`` give them) evaluates every branch and
        SELECTS per leaf with the selector tensor, so nothing is read back
        to the host: dict branches union-merge, a key missing from the
        selected branch reading as a zero of the leaf's type.  Branch
        sequences of different lengths and slots mixing containers with
        leaves raise; equal non-numeric leaves (a shared ``"kind"``
        string) pass through, unequal ones are left out of the merged
        dict, and a choice whose whole value would be left out raises."""
        table = _OP_TABLE_TORCH if traced else _OP_TABLE

        def rec(node: Expr):
            if isinstance(node, Literal):
                return node.value
            if isinstance(node, Param):
                v = flat[node.label]
                if traced:
                    return v
                if hasattr(v, "item"):
                    v = v.item()
                if node.cast == "int":
                    v = int(round(v))
                return v
            if isinstance(node, Choice):
                idx = flat[node.label]
                if traced and torch.is_tensor(idx):
                    merged = _union_select(idx, [rec(o) for o in node.options])
                    if merged is _MISSING:
                        raise InvalidAnnotatedParameter(
                            f"hp.choice({node.label!r}) branches cannot be merged for "
                            "traced evaluation (non-numeric or structurally "
                            "incompatible options); encode the options as "
                            "indices/numbers, or evaluate this space on the host")
                    return merged
                idx = int(idx.item()) if hasattr(idx, "item") else int(idx)
                return rec(node.options[idx])
            if isinstance(node, Op):
                return table[node.op](*(rec(a) for a in node.args))
            if isinstance(node, Container):
                vals = [rec(c) for c in node.children]
                if node.kind == "dict":
                    return dict(zip(node.keys, vals))
                return vals if node.kind == "list" else tuple(vals)
            raise InvalidAnnotatedParameter(f"not a space expression: {node!r}")

        return rec(self.expr)

    def sample(self, key):
        """One structured sample on host from one key ``[2]``."""
        flat = self.sample_flat(key[None, :])
        return self.assemble({l: v[0].item() for l, v in flat.items()})


_F32_EXACT = 2 ** 24


def _check_f32_exact_int(info: ParamInfo):
    """Integer values ride a packed float32 proposal matrix
    (``rand.pack_labels``); reject ranges a float32 cannot hold exactly."""
    fam, p = info.dist.family, info.dist.params
    if fam in ("randint", "uniformint", "quniform"):
        bound = max(abs(float(p[0])), abs(float(p[1])))
    elif fam == "qloguniform":
        bound = math.exp(float(p[1]))
    else:
        return
    if bound >= _F32_EXACT:
        raise InvalidAnnotatedParameter(
            f"{info.label!r}: integer range |{bound:.3g}| >= 2**24 cannot survive "
            f"the float32 proposal readback exactly; shift/scale the space "
            f"(e.g. sample an offset) to keep integer magnitudes below 2**24"
        )


def compile_space(space: Any) -> CompiledSpace:
    return CompiledSpace(as_expr(space))


# ---------------------------------------------------------------------------
# Traced assembly: selecting among choice branches by a selector tensor
# ---------------------------------------------------------------------------

_MISSING = object()  # a branch that lacks the slot


def _canonical(dtype):
    """The JAX package's types without 64-bit mode: float64 → float32,
    int64 → int32."""
    return {torch.float64: torch.float32, torch.int64: torch.int32}.get(dtype, dtype)


def _leaf_dtype(values):
    """``jnp.result_type`` of the branch leaves: tensors and numpy values
    are strongly typed, Python numbers weakly (a Python float makes an
    integer leaf float32, a Python int keeps a float leaf's type)."""
    strong = [_canonical(v.dtype if torch.is_tensor(v)
                         else torch.from_numpy(np.asarray(v)).dtype)
              for v in values if isinstance(v, (torch.Tensor, np.ndarray, np.number))]
    weak = [v for v in values if isinstance(v, (bool, int, float))]
    if strong:
        dtype = strong[0]
        for d in strong[1:]:
            dtype = torch.promote_types(dtype, d)
    else:
        dtype = torch.bool if all(isinstance(v, bool) for v in weak) else torch.int32
    if any(isinstance(v, float) for v in weak) and not dtype.is_floating_point:
        return torch.float32
    if dtype == torch.bool and any(not isinstance(v, bool) for v in weak):
        return torch.int32
    return dtype


def _leaf(v, dtype, device):
    """One branch's leaf as a 0-d (or array) tensor of ``dtype`` on
    ``device``; host values come from the constant cache, so selecting
    makes no copy from the host."""
    if v is _MISSING:
        return torch.zeros((), dtype=dtype, device=device)
    if torch.is_tensor(v):
        return v.to(dtype)
    return device_constant(np.asarray(v).tolist(), dtype, device)


def _union_select(idx, per_branch):
    """The value of branch ``idx`` (a 0-d integer tensor) among
    ``per_branch`` (``_MISSING`` where a branch lacks the slot), selected
    on the device: dicts merge key by key, sequences item by item, and
    numeric leaves stack and are indexed by ``idx``."""
    present = [v for v in per_branch if v is not _MISSING]
    if all(isinstance(v, dict) for v in present):
        out = {}
        for k in sorted(set().union(*(v.keys() for v in present))):
            sub = _union_select(idx, [v[k] if v is not _MISSING and k in v else _MISSING
                                      for v in per_branch])
            if sub is not _MISSING:
                out[k] = sub
        return out
    if all(isinstance(v, (list, tuple)) for v in present):
        lens = {len(v) for v in present}
        if len(lens) != 1:
            raise InvalidAnnotatedParameter(
                "traced hp.choice branches contain sequences of different lengths "
                f"{sorted(lens)}; static shapes cannot be selected on the device — "
                "pad the branches or evaluate this space on the host")
        items = [_union_select(idx, [v[i] if v is not _MISSING else _MISSING
                                     for v in per_branch])
                 for i in range(lens.pop())]
        kind = type(present[0])
        return kind(items) if kind in (list, tuple) else items
    if not all(isinstance(v, (int, float, np.number, np.ndarray, torch.Tensor))
               for v in present):
        if any(isinstance(v, (dict, list, tuple)) for v in present):
            raise InvalidAnnotatedParameter(
                "traced hp.choice branches mix containers and leaves at the same "
                f"slot ({present!r}); give every branch the same shape at this "
                "position")
        if len({repr(v) for v in present}) == 1:
            return present[0]  # e.g. a shared "kind" string
        return _MISSING  # unequal strings: gate on the selector value instead
    dtype = _leaf_dtype(present)
    stacked = torch.stack([_leaf(v, dtype, idx.device) for v in per_branch])
    return torch.index_select(stacked, 0, idx.reshape(1).to(torch.int64))[0]


# ---------------------------------------------------------------------------
# Distribution draws — semantics of hyperopt/pyll/stochastic.py
# ---------------------------------------------------------------------------


def _qround(x, q):
    return torch.round(x / q) * q


def draw_dist(dist: Dist, key, shape=()):
    """Draw ``[..., *shape]`` from one distribution node for keys
    ``[..., 2]``; the JAX package's ``draw_dist`` per key."""
    fam, p = dist.family, dist.params
    if fam == "uniform":
        return prng.uniform(key, shape, p[0], p[1])
    if fam == "quniform":
        return _qround(prng.uniform(key, shape, p[0], p[1]), p[2])
    if fam == "loguniform":
        return torch.exp(prng.uniform(key, shape, p[0], p[1]))
    if fam == "qloguniform":
        return _qround(torch.exp(prng.uniform(key, shape, p[0], p[1])), p[2])
    if fam == "normal":
        return p[0] + p[1] * prng.normal(key, shape)
    if fam == "qnormal":
        return _qround(p[0] + p[1] * prng.normal(key, shape), p[2])
    if fam == "lognormal":
        return torch.exp(p[0] + p[1] * prng.normal(key, shape))
    if fam == "qlognormal":
        return _qround(torch.exp(p[0] + p[1] * prng.normal(key, shape)), p[2])
    if fam == "randint":
        return prng.randint(key, shape, int(p[0]), int(p[1]))
    if fam == "uniformint":
        return prng.randint(key, shape, int(p[0]), int(p[1]) + 1)
    if fam == "categorical":
        logits = torch.log(device_constant(list(p), torch.float32, key.device))
        return prng.categorical(key, logits, shape)
    raise InvalidAnnotatedParameter(f"unknown family {fam!r}")


def draw_dist_group(dists, keys):
    """Batched :func:`draw_dist` for ≥2 SAME-family nodes; ``keys`` is
    ``[G, ..., 2]``, one leading row per node, and the result ``[G, ...]``
    is bitwise identical per node to the unrolled scalar draws."""
    fam = dists[0].family
    dev = keys.device
    extra = keys.dim() - 2  # batch dims after the node axis

    def col(i, dtype=torch.float32):
        v = device_constant([d.params[i] for d in dists], dtype, dev)
        return v.reshape(v.shape + (1,) * extra)

    if fam in ("uniform", "quniform", "loguniform", "qloguniform"):
        x = prng.uniform(keys, (), col(0), col(1))
        if fam in ("loguniform", "qloguniform"):
            x = torch.exp(x)
        if fam in ("quniform", "qloguniform"):
            x = _qround(x, col(2))
        return x
    if fam in ("normal", "qnormal", "lognormal", "qlognormal"):
        x = col(0) + col(1) * prng.normal(keys, ())
        if fam in ("lognormal", "qlognormal"):
            x = torch.exp(x)
        if fam in ("qnormal", "qlognormal"):
            x = _qround(x, col(2))
        return x
    if fam in ("randint", "uniformint"):
        off = 1 if fam == "uniformint" else 0
        lo = device_constant([int(d.params[0]) for d in dists], torch.int64, dev)
        hi = device_constant([int(d.params[1]) + off for d in dists], torch.int64, dev)
        shape = lo.shape + (1,) * extra
        return prng.randint(keys, (), lo.reshape(shape), hi.reshape(shape))
    if fam == "categorical":
        logp = torch.log(device_constant([list(d.params) for d in dists],
                                         torch.float32, dev))
        logp = logp.reshape(logp.shape[:1] + (1,) * extra + logp.shape[1:])
        return prng.categorical(keys, logp)
    raise InvalidAnnotatedParameter(f"unknown family {fam!r}")


# ---------------------------------------------------------------------------
# Public helpers
# ---------------------------------------------------------------------------


def rng_to_key(rng, device=None):
    """A PRNG key ``[2]`` on ``device`` from a key tensor, an int seed, a
    numpy ``Generator``/``RandomState``, or None (fresh entropy) — the same
    coercion as the JAX package's ``rng_to_key``."""
    dev = resolve_device(device)
    if rng is None:
        return prng.PRNGKey(np.random.SeedSequence().entropy % (2**32), dev)
    if isinstance(rng, torch.Tensor):
        return rng.to(dev)
    if isinstance(rng, (int, np.integer)):
        return prng.PRNGKey(int(rng) & 0xFFFFFFFF, dev)
    if isinstance(rng, np.random.Generator):
        return prng.PRNGKey(int(rng.integers(2**32, dtype=np.uint64)), dev)
    if isinstance(rng, np.random.RandomState):
        return prng.PRNGKey(int(rng.randint(0, 2**31 - 1)), dev)
    raise TypeError(f"cannot derive a PRNG key from rng={rng!r}")


def sample(space: Any, key=None, device=None):
    """Sample a structured point (``hyperopt.pyll.stochastic.sample``);
    runs on CUDA unless ``device="cpu"``."""
    return compile_space(space).sample(rng_to_key(key, device))


def expr_to_config(space: Any) -> dict:
    """Summarize a space as ``{label: {'dist': Dist, 'cast': ..., 'conditions':
    (...)}}`` (hyperopt/pyll_utils.py sym: expr_to_config)."""
    cs = compile_space(space)
    return {
        label: {"dist": info.dist, "cast": info.cast, "conditions": info.conditions}
        for label, info in cs.params.items()
    }


def space_eval(space: Any, hp_assignment: dict):
    """Rebuild the structured point from ``{label: value}`` (choice values
    are branch indices); accepts scalars and 1-element lists."""
    flat = {}
    for k, v in hp_assignment.items():
        if isinstance(v, (list, tuple, np.ndarray)):
            if len(v) == 0:
                continue
            v = v[0]
        flat[k] = v
    return compile_space(space).assemble(flat)
