"""Ask/tell optimizer service (counterpart of ``hyperopt_tpu/service``).

:class:`~hyperopt_tpu_torch.service.scheduler.StudyScheduler` packs live
studies into fixed-shape cohort slots and runs one study-batched tell+ask
program per cohort and ask wave, on the CUDA card unless
``device="cpu"``; ``python -m hyperopt_tpu_torch.service.server`` puts
the JAX package's HTTP front end on top.  Ported with it: the
write-ahead journal and its resume (``journal.py``; records and stores
resume across the two packages), the checksummed records, quarantine,
disk watermark and store GC (``integrity.py``, ``scrub.py``), deadlines,
admission control and the device-fault degrade ladder (``overload.py``),
the wire space schema (``spacespec.py``), the retrying client
(``client.py``), the compile plane's census (``compile_plane.py``;
nothing compiles per cohort here, so no ask is ever served warming), the
replicated serving fleet (``fleet.py``: leased study shards, per-(shard,
epoch) WALs, the ownership fence and 307 routing) and the serving planes
the schedulers feed (``obs/quality.py``, ``obs/load.py``,
``obs/tenant.py``).

Not ported yet (ROADMAP.md, queue 1, item 14b): the prober's canary
studies; ``create_study(canary=...)`` and ``--probe`` raise
``not_ported``.
"""

from ..exceptions import StoreFullError
from .client import ServiceClient
from .compile_plane import CompilePlane, SignatureCensus
from .fleet import FleetReplica, ShardNotOwned, ShardUnavailable, shard_of
from .journal import StudyJournal
from .overload import AdmissionGuard, Deadline, DegradeLadder, OverloadError, StoreFullShed
from .scheduler import (DrainingError, DuplicateTellError, QuarantinedStudyError,
                        StaleOwnershipError, Study, StudyQuotaError, StudyScheduler,
                        UnknownStudyError)
from .spacespec import space_from_spec

__all__ = ["StudyScheduler", "Study", "StudyQuotaError", "UnknownStudyError",
           "DuplicateTellError", "DrainingError", "QuarantinedStudyError", "StudyJournal",
           "AdmissionGuard", "Deadline", "DegradeLadder", "OverloadError", "StoreFullError",
           "StoreFullShed", "ServiceClient", "CompilePlane", "SignatureCensus",
           "space_from_spec", "FleetReplica", "ShardNotOwned", "ShardUnavailable", "shard_of",
           "StaleOwnershipError"]
