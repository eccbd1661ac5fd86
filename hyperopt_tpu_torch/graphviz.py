"""Graphviz DOT rendering of a search space (counterpart of
``hyperopt_tpu/graphviz.py``).

Parity target: ``hyperopt/graphviz.py`` (sym: dot_hyperparameters).  The
reference walks the pyll Apply graph; here the static Expr tree is walked
directly.  (A package submodule cannot shadow the top-level PyPI
``graphviz`` package under absolute imports, so the reference-parity name
is safe; ``graphviz_mod`` remains as a back-compat alias.)
"""

from __future__ import annotations

from .spaces import Choice, Container, Dist, Expr, Literal, Op, Param, as_expr

__all__ = ["dot_hyperparameters"]


def _esc(s) -> str:
    return str(s).replace('"', r"\"")


def dot_hyperparameters(expr) -> str:
    """DOT source for the space's expression tree
    (graphviz.py sym: dot_hyperparameters)."""
    expr = as_expr(expr)
    lines = ["digraph {"]
    counter = [0]

    def node(label, shape="ellipse"):
        name = f"n{counter[0]}"
        counter[0] += 1
        lines.append(f'  {name} [label="{_esc(label)}" shape={shape}];')
        return name

    def rec(e: Expr) -> str:
        if isinstance(e, Literal):
            return node(repr(e.value), shape="box")
        if isinstance(e, Param):
            d: Dist = e.dist
            me = node(f"{e.label}\\n{d.family}{tuple(round(p, 4) for p in d.params)}",
                      shape="doubleoctagon")
            return me
        if isinstance(e, Choice):
            me = node(f"choice {e.label}", shape="diamond")
            for i, opt in enumerate(e.options):
                child = rec(opt)
                lines.append(f'  {me} -> {child} [label="{i}"];')
            return me
        if isinstance(e, Op):
            me = node(e.op)
            for a in e.args:
                lines.append(f"  {me} -> {rec(a)};")
            return me
        if isinstance(e, Container):
            me = node(e.kind, shape="box3d")
            for k, c in zip(e.keys, e.children):
                child = rec(c)
                edge_label = f' [label="{_esc(k)}"]' if k else ""
                lines.append(f"  {me} -> {child}{edge_label};")
            return me
        raise TypeError(f"not a space expression: {e!r}")

    rec(expr)
    lines.append("}")
    return "\n".join(lines)
