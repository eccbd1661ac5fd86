"""Redirect stdout/stderr through ``tqdm.write`` while a progress bar is
live, so objective-function prints don't shred the bar.

Counterpart of ``hyperopt_tpu/std_out_err_redirect_tqdm.py``; parity
target ``hyperopt/std_out_err_redirect_tqdm.py`` (sym:
DummyTqdmFile, std_out_err_redirect_tqdm) — same module name so reference
imports keep working.
"""

from __future__ import annotations

import contextlib
import sys

__all__ = ["DummyTqdmFile", "std_out_err_redirect_tqdm"]


class DummyTqdmFile:
    """File-like that routes writes through ``tqdm.write`` (which repaints
    the bar below the printed text)."""

    def __init__(self, file):
        self.file = file

    def write(self, x):
        if len(x.rstrip()) > 0:  # skip the bare newlines print() emits
            from tqdm import tqdm

            # tqdm.write's default end="\n" supplies the line break the
            # skipped bare-"\n" write would have; with end="" consecutive
            # prints would concatenate onto one line
            tqdm.write(x.rstrip("\n"), file=self.file)

    def flush(self):
        getattr(self.file, "flush", lambda: None)()

    def isatty(self):
        return getattr(self.file, "isatty", lambda: False)()


@contextlib.contextmanager
def std_out_err_redirect_tqdm():
    """Within the block, stdout/stderr prints go through ``tqdm.write``;
    yields the original stdout (hand it to ``tqdm(file=...)``)."""
    orig_out_err = sys.stdout, sys.stderr
    try:
        sys.stdout, sys.stderr = map(DummyTqdmFile, orig_out_err)
        yield orig_out_err[0]
    finally:
        sys.stdout, sys.stderr = orig_out_err
