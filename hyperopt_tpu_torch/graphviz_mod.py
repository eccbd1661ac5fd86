"""Back-compat alias: this module was named ``graphviz_mod`` before it was
established that a package SUBMODULE cannot shadow the top-level PyPI
``graphviz`` package under Python 3 absolute imports — so the real module
is now ``hyperopt_tpu_torch.graphviz`` (full reference parity:
``hyperopt/graphviz.py``)."""

from .graphviz import *  # noqa: F401,F403
from .graphviz import dot_hyperparameters  # noqa: F401
