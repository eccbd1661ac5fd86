"""Frozen operation and byte counts of the port's kernels, and the H100
peaks they divide by.

``ei_diff`` at ``(P, n, m)`` scores ``n`` candidates of ``P`` rows under
two mixtures of ``m`` components: it needs one exponential per
candidate, component and mixture, ``2 P n m``, and reads ``x`` and
writes the result once (``2 P n`` floats) plus six component tables
(``6 P m`` floats), 4 bytes each.

The rate the exponentials divide by is one that no implementation of
the same float32 arithmetic can pass: each exponential costs at least
one issued instruction, whether on the special-function units
(``MUFU.EX2``) or as a polynomial on the FMA pipes, and an H100 SXM
issues at most one warp instruction per clock in each of the 4
sub-partitions of each of its 132 SMs, that is 128 lane-instructions
per SM per clock, at most 1.98 GHz (its boost clock).  The
special-function units alone give 16 per SM per clock, an eighth of
this.  Bytes divide by the 3.35 TB/s of HBM3.  The peaks assume the
card's full 700 W power limit."""

SMS = 132
LANES_PER_SM_CLOCK = 128   # 4 sub-partitions x one 32-lane warp instruction
SFU_PER_SM_CLOCK = 16
CLOCK_HZ = 1.98e9
EXP_PER_S = SMS * LANES_PER_SM_CLOCK * CLOCK_HZ     # 3.345e13
SFU_EXP_PER_S = SMS * SFU_PER_SM_CLOCK * CLOCK_HZ   # 4.18e12
HBM_BYTES_PER_S = 3.35e12


def ei_diff_cost(P, n, m):
    """``(exponentials, bytes)`` one ``ei_diff`` launch at ``(P, n, m)`` needs."""
    return 2 * P * n * m, 4 * (2 * P * n + 6 * P * m)


def least_seconds(ops, nbytes):
    """The least time the card could take for ``ops`` exponentials and
    ``nbytes`` bytes: the larger of the two bounds."""
    return max(ops / EXP_PER_S, nbytes / HBM_BYTES_PER_S)


def ei_diff_share(events, shapes, steps):
    """``ei_diff``'s share (%) of its roofline over a traced window: the
    least time of its launches (``shapes``, the configuration's
    ``ei_diff_shapes``, launched once each per TPE step, ``steps`` of
    them) over their summed device time in ``events`` (``(name, start_ns,
    end_ns)``).  None when the trace holds another number of launches than
    the steps imply."""
    launches = [e - s for name, s, e in events if "ei_diff_kernel" in name]
    if not launches or len(launches) != steps * len(shapes):
        return None
    least = steps * sum(least_seconds(*ei_diff_cost(*s)) for s in shapes)
    return 100.0 * least / (sum(launches) / 1e9)
