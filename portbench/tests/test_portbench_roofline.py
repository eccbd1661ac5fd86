"""The frozen roofline: its capacity counts are ``megakernel.ei_cost``
today; a batch configuration's launches are counted by the components
the mixtures hold, and ``q_mass_diff``'s by its bytes alone;
the rate it divides by is at least the special-function units' rate;
and each kernel's share reads only its own launches and reads 100 % at
its least time."""

import json

import pytest

import roofline
from conftest import BENCH

from hyperopt_tpu_torch import megakernel


@pytest.mark.parametrize("shape", [(2, 1024, 1001), (3, 65536, 4097), (3, 1024, 4097),
                                   (1, 24, 17), (27, 1048576, 1025)])
def test_counts_equal_the_ports_cost_today(shape):
    assert roofline.ei_diff_cost(*shape) == megakernel.ei_cost(*shape)


def test_rate_is_no_lower_than_the_special_function_units():
    assert roofline.EXP_PER_S >= roofline.SFU_EXP_PER_S
    assert roofline.SFU_EXP_PER_S == pytest.approx(132 * 16 * 1.98e9)
    assert roofline.EXP_PER_S == pytest.approx(132 * 128 * 1.98e9)


def test_least_time_is_the_larger_bound():
    ops, nbytes = roofline.ei_diff_cost(3, 65536, 4097)
    t = roofline.least_seconds(ops, nbytes)
    assert t == pytest.approx(ops / roofline.EXP_PER_S)
    assert t >= nbytes / roofline.HBM_BYTES_PER_S


def test_share_counts_one_launch_per_shape_and_step():
    shapes, steps = [[3, 65536, 4097], [3, 1024, 4097]], 2
    least = steps * sum(roofline.least_seconds(*roofline.ei_diff_cost(*s)) for s in shapes)
    events = [("ei_diff_kernel", 0, 1e9 * least / 2)] * 4 + [("other", 0, 5)]
    assert roofline.ei_diff_share(events, shapes, steps) == pytest.approx(50.0)
    assert roofline.ei_diff_share(events[:3], shapes, steps) is None


def lcbench():
    return json.loads((BENCH / "configs" / "lcbench.json").read_text())


# (G, n, held components) -> bytes: x read and the result written, three
# numbers of each held component read; no erf counted
@pytest.mark.parametrize("G, n, c, nbytes", [
    (3, 655360, 10242, 4 * (3_932_160 + 92_178)),
    (3, 10240, 30722, 4 * (61_440 + 276_498)),
    (3, 65536, 3074, 4 * (393_216 + 27_666)),
])
def test_q_mass_counts_the_bytes_its_inputs_and_result_need(G, n, c, nbytes):
    assert roofline.q_mass_cost(G, n, c) == (0, nbytes)
    assert roofline.least_seconds(*roofline.q_mass_cost(G, n, c)) == pytest.approx(
        nbytes / roofline.HBM_BYTES_PER_S)


def test_batch_launches_follow_the_configuration():
    cfg = lcbench()
    assert roofline.held_components(cfg) == [10242, 20482, 30722]
    assert roofline.batch_launches(cfg, "q_mass") == [
        roofline.q_mass_cost(3, n, c) for c in (10242, 20482, 30722) for n in (655360, 10240)]
    assert roofline.batch_launches(cfg, "ei_diff") == [
        roofline.ei_diff_held_cost(4, n, c) for c in (10242, 20482, 30722) for n in (655360, 10240)]


Q_MASS = "_anonymous_namespace_::q_mass_kernel_float_const___float_const__"
EI_DIFF = "void__anonymous_namespace_::ei_diff_kernel_4__float_const___floa"


def test_q_mass_share_counts_two_launches_per_generation():
    cfg = lcbench()
    least = sum(roofline.least_seconds(*c) for c in roofline.batch_launches(cfg, "q_mass"))
    events = [(Q_MASS, 0, 1e9 * least / 3)] * 6 + [("other", 0, 5)]
    assert roofline.q_mass_share(events, cfg) == pytest.approx(50.0)
    assert roofline.q_mass_share(events[:5], cfg) is None
    assert roofline.q_mass_share(events + [(Q_MASS, 0, 5)], cfg) is None


def test_each_share_reads_only_its_own_kernel():
    cfg = lcbench()
    q_mass = [(Q_MASS, 0, 1_000_000)] * 6
    ei_diff = [(EI_DIFF, 0, 1_000_000)] * 6
    assert roofline.ei_diff_batch_share(q_mass, cfg) is None
    assert roofline.q_mass_share(ei_diff, cfg) is None
    both = q_mass + ei_diff
    assert roofline.q_mass_share(both, cfg) == pytest.approx(roofline.q_mass_share(q_mass, cfg))
    assert roofline.ei_diff_batch_share(both, cfg) == pytest.approx(
        roofline.ei_diff_batch_share(ei_diff, cfg))


@pytest.mark.parametrize("kernel, name", [("q_mass", Q_MASS), ("ei_diff", EI_DIFF)])
def test_a_kernel_at_its_least_time_reads_100(kernel, name):
    cfg = lcbench()
    events = [(name, 0, 1e9 * roofline.least_seconds(*c))
              for c in roofline.batch_launches(cfg, kernel)]
    read = roofline.q_mass_share if kernel == "q_mass" else roofline.ei_diff_batch_share
    assert read(events, cfg) == pytest.approx(100.0)


def test_q_mass_share_at_the_measured_time_reads_under_100():
    # one launch at (3, 65,536, 4,097) took 6.28 ms of device time on an
    # H100 80GB HBM3 (torch.profiler), at a generation of a batch-1024 search
    # whose mixtures held at most 3,074 components; a kernel that scored each
    # distinct bin once, or merged equal components, would still need this
    # least time
    cost = roofline.q_mass_cost(3, 65536, 3074)
    assert 0.0 < roofline.share("q_mass_kernel", [cost], [(Q_MASS, 0, 6_280_000)]) < 100.0
    # the six launches of a batch-10,240 search took 2.7135 s together
    share = roofline.q_mass_share([(Q_MASS, 0, 452_250_000)] * 6, lcbench())
    assert 0.0 < share < 100.0
