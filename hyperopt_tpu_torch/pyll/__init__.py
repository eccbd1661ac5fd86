"""The user-facing subset of the reference's ``hyperopt.pyll`` (counterpart
of ``hyperopt_tpu/pyll``): ``pyll.stochastic.sample`` and ``as_apply``.
Spaces compile to the static IR in ``hyperopt_tpu_torch.spaces``; the
interpreter internals have no analog."""

from ..spaces import as_expr as as_apply  # noqa: F401
from . import stochastic  # noqa: F401

__all__ = ["stochastic", "as_apply"]
