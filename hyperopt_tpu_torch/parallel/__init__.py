"""Asynchronous trial evaluation (counterpart of the part of
``hyperopt_tpu/parallel/`` that the evaluation backends need).

* ``executor`` — host-side async trial evaluation behind the reference's
  ``Trials.asynchronous`` protocol (``ExecutorTrials``: a worker pool for
  arbitrary objectives, one batched device call per queue for traceable
  ones).

The sharding, multi-host driver and membership modules are not ported
yet (ROADMAP.md, queue 1, item 12).
"""

from . import executor  # noqa: F401
from .executor import ExecutorTrials  # noqa: F401

__all__ = ["executor", "ExecutorTrials"]
