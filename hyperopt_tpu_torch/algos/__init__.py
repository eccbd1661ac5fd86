"""Suggesters behind the ``algo=`` boundary: random search, TPE,
annealing, the mixture of suggesters and adaptive TPE."""

from . import anneal, atpe, mix, rand, tpe  # noqa: F401

__all__ = ["rand", "tpe", "anneal", "mix", "atpe"]
