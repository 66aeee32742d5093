"""The frozen roofline arithmetic gives the bounds PERF.md records at the
shapes chip_smoke.py timed, and the trace reduction adds intervals right."""

import pytest

import roofline
from tracing import kernel_time, reduce_device, short_name

RATE = roofline.H100_SXM_INT32_OPS_PER_S  # 132 x 64 x 1980 MHz


def test_int32_rate_is_labelled_derived():
    assert roofline.INT32_RATE_IS_DERIVED
    assert "DERIVED" in roofline.__doc__
    assert RATE == pytest.approx(16.73e12, rel=1e-3)


@pytest.mark.parametrize("name,lanes,want,by", [
    ("rns_fold_window", 16384, 0.0111, "bytes"),
    ("rns_fold_window_g2", 8192, 0.0138, "operations"),
])
def test_fold_bound_at_recorded_shapes(name, lanes, want, by):
    ms, bound_by = roofline.fold_bound(RATE, name, lanes)
    assert round(ms, 4) == want and bound_by == by
    # B = 16 gathers fewer points than a c = 8 window holds: the widening is the original
    assert roofline.fold_bound(RATE, name, lanes, table_points=lanes // 16 * 129) == (ms, bound_by)


def test_mont_mul_bound_at_recorded_shape():
    ms, by = roofline.mont_mul_bound(RATE, 16384)
    assert round(ms, 5) == 0.00141 and by == "bytes"
    assert roofline.mont_mul_bound(RATE, 16384, nbytes=3 * 24 * 4 * 16384) == (ms, by)
    # a broadcast operand read once lowers the bytes, never the operations
    assert roofline.mont_mul_bound(RATE, 16384, nbytes=2 * 24 * 4 * 16384)[0] < ms


def test_fold_bound_counts_gathered_points_once():
    full = roofline.fold_bound(RATE, "rns_fold_window", 256 * 1024)[0]
    once = roofline.fold_bound(RATE, "rns_fold_window", 256 * 1024, table_points=129 * 1024)[0]
    assert once < full


def test_reduce_device_unions_intervals_and_names_gaps():
    ev = [(0, 10, "k1"), (5, 10, "k2"), (30, 5, "k1"), (100, 50, "(anonymous namespace)::k4<24>(int*)")]
    tr = reduce_device(ev, window_s=200e-9)
    assert tr["busy_s"] == pytest.approx(70e-9)
    assert tr["kernel_n"] == {"k1": 2, "k2": 1, "(anonymous namespace)::k4<24>(int*)": 1}
    assert tr["idle_gaps"][0] == ["before k4<24>", pytest.approx(65e-9)]
    assert kernel_time(tr, "k1") == (pytest.approx(15e-9), 2)
    assert short_name("void (anonymous namespace)::fold_kernel<(anonymous namespace)::G1Ops>(int const*)") \
        == "fold_kernel<G1Ops>"
