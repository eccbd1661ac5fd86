"""Exception types (counterpart of ``hyperopt_tpu/exceptions.py``; parity
target ``hyperopt/exceptions.py``)."""


class HyperoptTpuError(Exception):
    """Base class for framework errors."""


class AllTrialsFailed(HyperoptTpuError):
    """Raised by ``Trials.argmin`` / ``fmin`` when no trial reported a loss."""


class DuplicateLabel(HyperoptTpuError):
    """Raised when two hyperparameters in one space share a label."""


class InvalidTrial(HyperoptTpuError):
    """Raised when a trial document does not match the schema."""


class InvalidResultStatus(HyperoptTpuError):
    """Raised when an objective returns an unknown ``status`` string."""


class InvalidLoss(HyperoptTpuError):
    """Raised when an objective's ``loss`` is not a finite float (or None for fail)."""


class InvalidAnnotatedParameter(HyperoptTpuError):
    """Raised when an ``hp.*`` call is malformed (bad label, bad args)."""


class StaleHistoryError(HyperoptTpuError):
    """Raised when a padded history's device mirror is handed out for a
    tick while an earlier tick's update was never committed
    (``PaddedHistory.commit_device``) or abandoned."""


class StoreFullError(OSError):
    """The backing filesystem refused a durable write for lack of space
    (``ENOSPC``/``EDQUOT``).  Retryable: the write succeeds once space
    frees.  Subclasses ``OSError`` so handlers that absorb store I/O
    failures keep working; typed so the worker's retry path can back off
    instead of burning its budget on a full disk."""
