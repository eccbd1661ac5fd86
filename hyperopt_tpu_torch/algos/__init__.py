"""Suggesters behind the ``algo=`` boundary: random search and TPE."""

from . import rand, tpe  # noqa: F401

__all__ = ["rand", "tpe"]
