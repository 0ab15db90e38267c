"""K1's least time counts one predicate per unordered pair of valid
points, and the trace's reduction adds up what it should."""

import pytest

from regbench import trace as tr
from regbench import yardstick as ys

H100 = "NVIDIA H100 80GB HBM3"


def test_k1_count_on_a_hand_counted_mask():
    # problems of 3 and 5 valid points among 64: 3 + 10 pairs, 21 instructions each
    fp32 = 21 * 13 / 33.5e12
    nbytes = 2 * (2 * 3 * 64 * 4 + 64 + 2 * 64 * 4)
    want = max(fp32, nbytes / 3.35e12)
    assert ys.trim_bits_least_s([3, 5], 64, H100) == pytest.approx(want, rel=1e-12)


def test_k1_bound_of_the_cells():
    # 512 x 1889 points: 512 * 1889 * 1888 / 2 pairs set it, 0.514 ms
    assert ys.trim_bits_least_s([1889] * 512, 1889, H100) == pytest.approx(
        21 * 512 * 1889 * 1888 / 2 / 33.5e12)
    assert ys.trim_bits_least_s([100000], 100000, H100) * 1e3 == pytest.approx(3.134, abs=1e-3)


def test_an_unknown_card_has_no_bound():
    assert ys.trim_bits_least_s([10], 10, "some other card") is None


def _ev(name, dev, a, b, thread=1, note=False):
    return tr.Event(name, dev, a, b, thread, note)


def test_reduce_busy_union_ops_and_named_gaps():
    events = [
        _ev(tr.WINDOW, False, 0, 1000, note=True),
        _ev(tr.WINDOW, True, 0, 1000, note=True),  # its span on the device's timeline
        _ev("aten::a", False, 0, 400),
        _ev("aten::item", False, 600, 900),
        _ev("aten::inner", False, 650, 700),
        _ev("kernel_x", True, 100, 300),
        _ev("kernel_y", True, 250, 350),  # overlaps x: counted once in busy time
        _ev("Memcpy DtoH", True, 800, 900),
        _ev("kernel_late", True, 990, 1500),  # cut at the window's end
        _ev("other thread", False, 0, 1000, thread=2),
    ]
    t = tr.reduce(events)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx((250 + 100 + 10) / 1e9)
    assert t.op_s["kernel_x"] == pytest.approx(200e-9) and t.op_s["kernel_late"] == pytest.approx(10e-9)
    # gaps: [0,100) under aten::a, [350,800) mid 575 under the window only,
    # [900,990) mid 945 under the window only
    assert t.gap_s["aten::a"] == pytest.approx(100e-9)
    assert t.gap_s[tr.WINDOW] == pytest.approx((450 + 90) * 1e-9)
    assert sum(t.gap_s.values()) + t.busy_s == pytest.approx(t.window_s)
    assert tr.top({"a": 1.0, "b": 3.0}, k=1) == [["b", 3.0]]


def test_reduce_without_a_window_is_nothing():
    assert tr.reduce([_ev("k", True, 0, 5)]) is None
