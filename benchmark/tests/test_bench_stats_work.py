"""The statistics of a window on hand-made timings, and each work function
against a count made by hand."""

import pytest

from benchmark import readers, stats, trace, work


def test_rate_is_all_units_over_the_whole_window():
    assert stats.rate(36, 10.0, 13.0) == 12.0
    with pytest.raises(ValueError):
        stats.rate(0, 1.0, 2.0)


def test_nw_fill_work_by_hand():
    nbytes, ops = work.nw_fill([2], [3], 5)
    assert ops == 5 * 20 * 3 * 4
    assert nbytes == 5 * (12 + 4 * 7 + 24)


def test_least_seconds_takes_the_larger_bound():
    w = work.Work()
    w.add("k", work.PEAK_HBM_BYTES, 0)
    w.add("k", 0, 2 * work.PEAK_FP32_FLOPS)
    assert w.least_seconds("k") == 2.0
    assert w.least_seconds("other") is None


def test_busy_time_counts_overlaps_once():
    dev = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 21.0)]
    assert trace.busy_us(dev) == 13.0
    gaps = trace.idle_gaps(dev, [("aten::item", 11.0, 30.0)], 0.0, 25.0)
    assert gaps[0][1] == pytest.approx(8e-6)
    assert "aten::item" in gaps[0][0]


def test_shares_are_never_zero():
    from types import SimpleNamespace

    ctx = SimpleNamespace(dev=[], work=work.Work(), window_s=1.0,
                          busy_s=0.0)
    assert readers.nw_fill_batched_roofline(ctx) is None
    assert readers.mfu("nw_fill")(ctx) is None
    assert readers.device_idle_pct(ctx) is None
