"""Parallel and distributed execution (counterpart of
``hyperopt_tpu/parallel/``): mesh sharding, asynchronous trial evaluation
and the multi-controller driver.

* ``sharding`` — the two scaling axes of HPO split over a mesh of devices
  (an entry may repeat a device): the trial batch (every entry proposes
  its slice of the ids) and the candidate axis (per-entry candidate
  pools, pooled top-k select).
* ``executor`` — host-side async trial evaluation behind the reference's
  ``Trials.asynchronous`` protocol (``ExecutorTrials``: a worker pool for
  arbitrary objectives, one batched device call per queue for traceable
  ones).
* ``multihost`` — the ``torch.distributed`` wiring (gloo process group,
  global mesh, replication, global key batches).
* ``driver`` — ``fmin_multihost``: global proposals, per-controller
  evaluation shards, a deterministic fold and a divergence checksum.
* ``membership`` / ``fleet`` — the elastic form of the same driver
  (``fmin_multihost(fleet_dir=...)``): generation shards as leases in a
  shared directory, controllers joining and leaving freely, bitwise
  replay at any fleet size.
"""

from . import executor, sharding  # noqa: F401
from .driver import ControllerDivergence, MultihostResult, fmin_multihost  # noqa: F401
from .executor import ExecutorTrials  # noqa: F401
from .membership import FleetMembership, shard_trials  # noqa: F401

__all__ = ["executor", "sharding", "ExecutorTrials", "fmin_multihost", "MultihostResult",
           "ControllerDivergence", "FleetMembership", "shard_trials"]
