"""Ask/tell optimizer service (counterpart of ``hyperopt_tpu/service``):
the :class:`~hyperopt_tpu_torch.service.scheduler.StudyScheduler` packs
live studies into fixed-shape cohort slots and runs one study-batched
tell+ask program per cohort and ask wave.  The journal, store, compile
plane, overload planes and HTTP front end are not ported yet (ROADMAP.md,
queue 1, item 13)."""

from .scheduler import (DuplicateTellError, Study, StudyQuotaError, StudyScheduler,
                        UnknownStudyError)

__all__ = ["StudyScheduler", "Study", "StudyQuotaError", "UnknownStudyError",
           "DuplicateTellError"]
