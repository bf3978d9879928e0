"""The reader of ``nw_replay_distinct_pct.grid`` on hand-built traces:
host events as (name, start us, end us) and the traced items' records."""

from types import SimpleNamespace

import pytest

from benchmark import common, validate
from benchmark.run import load_reader

NAME = "nw_replay_distinct_pct.grid"


def ctx(host, units):
    return SimpleNamespace(host=sorted(host, key=lambda x: x[1]), dev=[],
                           traced=[{"units": u} for u in units])


def grid(t0, replays):
    """One traced grid's spans: the call, its replay and ``replays``
    ``ta.nw.replay_one`` spans inside it."""
    return [("ta.nw.align_grid", t0, t0 + 100.0),
            ("ta.nw.replay", t0 + 50.0, t0 + 90.0)] + [
        ("ta.nw.replay_one", t0 + 50.0 + i, t0 + 50.5 + i)
        for i in range(replays)]


@pytest.mark.parametrize("replays, units, want", [
    ((6, 7, 5), (729, 729, 729), 100.0 * 18 / 2187),
    ((729,), (729,), 100.0),                       # every row distinct
    ((1, 3), (10, 20), 100.0 * 4 / 30),            # grids of two sizes
])
def test_share_of_rows_replayed(replays, units, want):
    host = [e for i, n in enumerate(replays) for e in grid(1000.0 * i, n)]
    host.append(("aten::cat", 10.0, 11.0))
    assert load_reader(NAME)(ctx(host, units)) == pytest.approx(
        want, abs=1e-12)


@pytest.mark.parametrize("host, units", [
    (grid(0.0, 0) + grid(1000.0, 0), (729, 729)),  # the parent's spans
    ([("nw.replay_one", 0.0, 1.0), ("python", 0.0, 5.0)], (729,)),
    (grid(0.0, 6), ()),                            # no traced item
    (grid(0.0, 6), (0,)),                          # an item that failed
])
def test_no_replay_one_span_or_no_row_reads_none(host, units):
    assert load_reader(NAME)(ctx(host, units)) is None


def test_the_metric_is_declared_for_the_grid_cell():
    spec = common.load_spec()
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["salzinnes.grid"]
    assert m["moves"] == "grid_combos_per_s" and m["unit"] == "%"
    assert validate.problems(spec) == []
