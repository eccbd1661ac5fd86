"""Early-stopping callbacks (counterpart of ``hyperopt_tpu/early_stop.py``;
hyperopt/early_stop.py sym: no_progress_loss)."""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

__all__ = ["no_progress_loss"]


def no_progress_loss(iteration_stop_count=20, percent_increase=0.0):
    """Stop when the best loss has not improved by more than
    ``percent_increase`` percent for ``iteration_stop_count`` iterations.

    Returns a closure suitable for ``fmin(early_stop_fn=...)``; the closure's
    extra positional args thread state between calls, exactly as the
    reference's does.
    """

    def stop_fn(trials, best_loss=None, iteration_no_progress=0):
        new_loss = trials.trials[len(trials.trials) - 1]["result"].get("loss")
        if new_loss is None:
            return False, [best_loss, iteration_no_progress + 1]
        if best_loss is None:
            return False, [new_loss, 0]
        best_loss_threshold = best_loss - abs(best_loss * (percent_increase / 100.0))
        if new_loss < best_loss_threshold:
            best_loss = new_loss
            iteration_no_progress = 0
        else:
            iteration_no_progress += 1
            logger.debug(
                "No progress made: %d iteration on %d. best_loss=%.2f, best_loss_threshold=%.2f, new_loss=%.2f",
                iteration_no_progress,
                iteration_stop_count,
                best_loss if best_loss is not None else float("nan"),
                best_loss_threshold,
                new_loss,
            )
        return iteration_no_progress >= iteration_stop_count, [best_loss, iteration_no_progress]

    return stop_fn
