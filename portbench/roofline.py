"""Frozen operation and byte counts of the port's kernels, and the H100
peaks they divide by.

``ei_diff`` at ``(P, n, m)`` scores ``n`` candidates of ``P`` rows under
two mixtures of ``m`` components: it needs one exponential per
candidate, component and mixture, ``2 P n m``, and reads ``x`` and
writes the result once (``2 P n`` floats) plus six component tables
(``6 P m`` floats), 4 bytes each.  ``ei_diff_cost`` counts the capacity
``m`` the kernel is handed; the device-loop cell reads it so.

A batch configuration's launches (``batch_launches``) are counted by
what their inputs need.  At a TPE generation the two mixtures of a label
hold ``c`` components together: every trial before it (each in one of
the two) and each mixture's prior; the slots past them are empty.
``ei_diff`` then needs one exponential per candidate and held component,
``P n c``, and reads ``x``, writes the result (``2 P n`` floats) and
reads three numbers of each held component (``3 P c``).
``q_mass_diff`` scores ``n`` candidates of ``G`` quantized labels by
their bins' masses under the same mixtures.  Its ``erf`` work hangs on
the data: a candidate's mass depends on its bin alone, so a kernel may
score each distinct bin once, and components of equal centre and width
(a quantized history repeats its values) may be merged.  No count of
``erf`` is a least one for every input, so none is taken: the least time
is the bytes', ``x`` read and the result written (``2 G n`` floats) and
three numbers of each held component read (``3 G c``).

The rate the exponentials divide by is one that no implementation of
the same float32 arithmetic can pass: each costs at least one issued
instruction, whether on the special-function units
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

#: the space families the port scores with ``q_mass_diff``, and those with
#: a bounded support: the port groups a generation's labels by both
QUANTIZED = frozenset({"quniform", "qloguniform", "uniformint", "qnormal", "qlognormal"})
BOUNDED = frozenset({"uniform", "loguniform", "quniform", "qloguniform", "uniformint"})
NUMERIC = QUANTIZED | BOUNDED | {"normal", "lognormal"}


def ei_diff_cost(P, n, m):
    """``(exponentials, bytes)`` one ``ei_diff`` launch at ``(P, n, m)``
    needs over the capacity ``m``."""
    return 2 * P * n * m, 4 * (2 * P * n + 6 * P * m)


def ei_diff_held_cost(P, n, c):
    """``(exponentials, bytes)`` one ``ei_diff`` launch of ``n`` candidates
    of ``P`` labels needs when the mixtures hold ``c`` components."""
    return P * n * c, 4 * (2 * P * n + 3 * P * c)


def q_mass_cost(G, n, c):
    """``(erf evaluations, bytes)`` one ``q_mass_diff`` launch of ``n``
    candidates of ``G`` labels needs when the mixtures hold ``c``
    components: no ``erf`` counted, see above."""
    return 0, 4 * (2 * G * n + 3 * G * c)


def held_components(cfg):
    """The components a label's two mixtures hold together at each TPE
    generation of one search of a batch configuration."""
    T, B, n0 = (int(cfg[k]) for k in ("max_evals", "batch", "n_startup"))
    return [s + 2 for s in range(0, T, B) if s >= n0]


def batch_launches(cfg, kernel):
    """The least ``(operations, bytes)`` of each launch of ``kernel``
    (``"ei_diff"`` or ``"q_mass"``) in one search of a batch
    configuration ``cfg``: at each TPE generation, one launch for each
    group of labels for the candidates (``batch x n_EI_candidates``) and
    one for the epsilon-prior draws (``batch``)."""
    groups = {}
    for family, *_ in cfg["space"].values():
        if family in NUMERIC and (family in QUANTIZED) == (kernel == "q_mass"):
            groups[family in BOUNDED] = groups.get(family in BOUNDED, 0) + 1
    B, k = int(cfg["batch"]), int(cfg["n_EI_candidates"])
    cost = q_mass_cost if kernel == "q_mass" else ei_diff_held_cost
    return [cost(g, n, c)
            for c in held_components(cfg) for n in (B * k, B) for g in groups.values()]


def least_seconds(ops, nbytes):
    """The least time the card could take for ``ops`` exponentials and
    ``nbytes`` bytes: the larger of the two bounds."""
    return max(ops / EXP_PER_S, nbytes / HBM_BYTES_PER_S)


def share(kernel, costs, events):
    """``kernel``'s share (%) of its roofline over a traced window: the
    least time of its launches (``costs``, one ``(ops, bytes)`` each) over
    the summed device time of the events (``(name, start_ns, end_ns)``)
    whose name holds ``kernel``.  None when the trace holds another number
    of launches."""
    launches = [e - s for name, s, e in events if kernel in name]
    if not launches or len(launches) != len(costs):
        return None
    return 100.0 * sum(least_seconds(*c) for c in costs) / (sum(launches) / 1e9)


def ei_diff_share(events, shapes, steps):
    """``ei_diff``'s share (%) of its roofline over the capacity:
    ``shapes`` (a configuration's ``ei_diff_shapes``) launched once each
    per TPE step, ``steps`` of them."""
    return share("ei_diff_kernel", [ei_diff_cost(*s) for s in shapes] * steps, events)


def ei_diff_batch_share(events, cfg):
    """``ei_diff``'s share (%) of its roofline over one search of the batch
    configuration ``cfg``."""
    return share("ei_diff_kernel", batch_launches(cfg, "ei_diff"), events)


def q_mass_share(events, cfg):
    """``q_mass_diff``'s share (%) of its roofline over one search of the
    batch configuration ``cfg``."""
    return share("q_mass_kernel", batch_launches(cfg, "q_mass"), events)
