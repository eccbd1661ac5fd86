"""The plain reference the benchmark holds the port to.

Plain PyTorch in float64 (on the CPU or the card the run uses), written
from the documented semantics of the searches the cells run: the
threefry2x32 key schedule, the prior draws, the adaptive-Parzen TPE
proposal (below/above split, Parzen fits, inverse-CDF candidate draws,
expected-improvement scores, argmax or Gumbel-max selection, the
epsilon-prior mix) and each configuration's objective.  It imports
nothing of the program under test and of the JAX package; it reads the
program's outputs (trial values and losses) only to judge them.
"""
