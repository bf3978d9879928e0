"""The readers of the program's spans (``benchmark/spans.py`` and the
four per-layer metrics that bind them) on hand-built traces: host events
and device events as (name, start us, end us)."""

from types import SimpleNamespace

import pytest

from benchmark.run import load_reader

SPAN_METRICS = ("nw_replay_host_ms.grid", "nw_wire_wait_ms.grid",
                "nw_launch_host_ms.grid", "idle_unspanned_pct.grid")


def ctx(host, dev=(), traced=2):
    return SimpleNamespace(host=sorted(host, key=lambda x: x[1]),
                           dev=list(dev), traced=[{}] * traced)


HOST = [
    ("ta.nw.align_grid", 0.0, 60000.0), ("ta.nw.encode", 0.0, 500.0),
    ("ta.nw.fill", 500.0, 1200.0), ("ta.nw.walk", 1200.0, 1500.0),
    ("ta.nw.wire", 1500.0, 1800.0), ("ta.nw.replay", 1800.0, 60000.0),
    ("aten::cat", 1500.0, 1520.0),
    ("ta.nw.align_grid", 70000.0, 120000.0), ("ta.nw.encode", 70000.0,
                                              70700.0),
    ("ta.nw.fill", 70700.0, 71100.0), ("ta.nw.walk", 71100.0, 71300.0),
    ("ta.nw.wire", 71300.0, 71800.0), ("ta.nw.replay", 71800.0, 120000.0),
]


@pytest.mark.parametrize("name, want", [
    ("nw_replay_host_ms.grid", (58.2 + 48.2) / 2),
    ("nw_wire_wait_ms.grid", (0.3 + 0.5) / 2),
    ("nw_launch_host_ms.grid", (1.5 + 1.3) / 2),
])
def test_span_times_are_exact_ms_a_traced_item(name, want):
    assert load_reader(name)(ctx(HOST)) == pytest.approx(want, abs=1e-12)


# the stretch is 0-100 us (its first and last host events); the device
# runs 0-10 and 90-100, so 80 us are idle
@pytest.mark.parametrize("spans, want", [
    ([("ta.nw.replay", 10.0, 90.0)], 0.0),           # covered fully
    ([("ta.nw.replay", 5.0, 50.0)], 50.0),           # partly
    ([("ta.nw.replay", 20.0, 30.0),
      ("ta.nw.align_grid", 25.0, 40.0)], 75.0),      # two that overlap
    ([("ta.nw.fill", 2.0, 8.0)], 100.0),             # not at all
])
def test_idle_unspanned_pct(spans, want):
    host = [("aten::empty", 0.0, 1.0), ("cudaDeviceSynchronize", 95.0,
                                        100.0)] + spans
    got = load_reader("idle_unspanned_pct.grid")(
        ctx(host, [("k", 0.0, 10.0), ("Memcpy", 90.0, 100.0)]))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_span_reads_none(name):
    host = [("aten::cat", 0.0, 10.0), ("python", 10.0, 90.0),
            ("nw.replay", 20.0, 30.0)]
    assert load_reader(name)(ctx(host, [("k", 0.0, 5.0)])) is None
