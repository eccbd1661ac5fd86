"""The frozen roofline: its counts are ``megakernel.ei_cost`` today, and
the rate it divides by is at least the special-function units' rate."""

import pytest

import roofline

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
