"""hyperopt_tpu_torch — the PyTorch/CUDA port of ``hyperopt_tpu``.

The same public surface as the JAX package, restricted to what this port
has so far: ``fmin`` with random search, TPE, annealing, the mixture of
suggesters and adaptive TPE, the on-device loop
(``fmin_device``, ``fmin(device_loop=...)``: CUDA-graph replays of one
ask→tell step for objectives written in torch ops), the ``hp.*`` space
language, ``Trials``/``Domain``/``Ctrl`` and the padded history (float32,
bf16 or int8/fp8 codes), and the study scheduler of ``service`` with its
study-batched cohort, and the evaluation backends: ``filestore.FileTrials``
with ``python -m hyperopt_tpu_torch.worker`` processes, and
``parallel.ExecutorTrials``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; TPE's EI scoring runs in the hand-written
kernel of ``csrc/ei_diff.cu``, and a cohort's sampling and scoring in
``csrc/fused_sample_ei.cu``.  The package imports neither JAX nor
``hyperopt_tpu``.
"""

from . import device_fmin, early_stop, graphviz, graphviz_mod, hp, pyll, spaces
from .algos import anneal, atpe, mix, rand, tpe
from .base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    JOB_STATES,
    STATUS_FAIL,
    STATUS_NEW,
    STATUS_OK,
    STATUS_RUNNING,
    STATUS_STRINGS,
    STATUS_SUSPENDED,
    Ctrl,
    Domain,
    Trials,
    trials_from_docs,
)
from .exceptions import (
    AllTrialsFailed,
    DuplicateLabel,
    InvalidAnnotatedParameter,
    InvalidLoss,
    InvalidResultStatus,
    InvalidTrial,
)
from .device_fmin import fmin_device
from .fmin import FMinIter, fmin, fmin_pass_expr_memo_ctrl, generate_trials_to_calculate
from .spaces import space_eval

__version__ = "0.2.0"

__all__ = [
    "hp",
    "spaces",
    "pyll",
    "graphviz",
    "graphviz_mod",
    "early_stop",
    "fmin",
    "fmin_device",
    "device_fmin",
    "FMinIter",
    "fmin_pass_expr_memo_ctrl",
    "generate_trials_to_calculate",
    "space_eval",
    "rand",
    "tpe",
    "anneal",
    "mix",
    "atpe",
    "Trials",
    "trials_from_docs",
    "Ctrl",
    "Domain",
    "JOB_STATE_NEW",
    "JOB_STATE_RUNNING",
    "JOB_STATE_DONE",
    "JOB_STATE_ERROR",
    "JOB_STATE_CANCEL",
    "JOB_STATES",
    "STATUS_NEW",
    "STATUS_RUNNING",
    "STATUS_SUSPENDED",
    "STATUS_OK",
    "STATUS_FAIL",
    "STATUS_STRINGS",
    "AllTrialsFailed",
    "DuplicateLabel",
    "InvalidAnnotatedParameter",
    "InvalidLoss",
    "InvalidResultStatus",
    "InvalidTrial",
    "__version__",
]
