"""Progress reporting (counterpart of ``hyperopt_tpu/progress.py``;
hyperopt/progress.py sym: tqdm_progress_callback, no_progress_callback)."""

from __future__ import annotations

import contextlib

__all__ = ["tqdm_progress_callback", "no_progress_callback",
           "get_progress_callback", "format_postfix"]


def format_postfix(best_loss):
    """The progress-bar postfix: the best loss so far."""
    return f"best loss: {best_loss:.6g}"


class _NullProgress:
    """No-op progress context with the tqdm-ish surface FMinIter uses."""

    postfix = ""

    def update(self, n=1):
        pass


@contextlib.contextmanager
def no_progress_callback(initial=0, total=None):
    yield _NullProgress()


@contextlib.contextmanager
def tqdm_progress_callback(initial=0, total=None):
    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        with no_progress_callback(initial, total) as ctx:
            yield ctx
        return

    from .std_out_err_redirect_tqdm import std_out_err_redirect_tqdm

    class _Tqdm:
        def __init__(self, bar):
            self.bar = bar

        @property
        def postfix(self):
            return self.bar.postfix

        @postfix.setter
        def postfix(self, s):
            self.bar.set_postfix_str(s, refresh=False)

        def update(self, n=1):
            if n:
                self.bar.update(n)

    total_ = None if total in (None, float("inf")) else int(total)
    # objective prints go through tqdm.write so they don't shred the bar
    with std_out_err_redirect_tqdm() as orig_stdout:
        with tqdm(initial=initial, total=total_, dynamic_ncols=True,
                  file=orig_stdout) as bar:
            yield _Tqdm(bar)


def get_progress_callback(show_progressbar):
    if callable(show_progressbar) and not isinstance(show_progressbar, bool):
        return show_progressbar
    return tqdm_progress_callback if show_progressbar else no_progress_callback
