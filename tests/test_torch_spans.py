"""The port's spans on the CPU: ``utils.timing.span`` and the ``ta.nw.*``
spans of the NW path's entry points under ``torch.profiler``, the no-op
that ``span`` is when no profiler records, and the ``ta.stage.*`` span of
``StageTimer``."""

import functools
import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from text_alignment_tpu_torch.align import nw_torch, perform_alignment
from text_alignment_tpu_torch.align.scoring import resolve_scoring
from text_alignment_tpu_torch.utils import timing
from text_alignment_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(1)

STAGES = ("ta.nw.encode", "ta.nw.fill", "ta.nw.walk", "ta.nw.wire",
          "ta.nw.replay", "ta.nw.replay_one")
ROWS = [[m, mm, go, go, ge, ge] for m in (1, 2, 3) for mm in (-1, -2, -3)
        for go, ge in [(-2, -1)]]


def pair(seed, n=40, m=40):
    rng = random.Random(seed)
    return ([rng.choice("abcdefg ") for _ in range(n)],
            [rng.choice("abcdefg ") for _ in range(m)])


def run_grid():
    return nw_torch.align_grid(*pair(0), ROWS, device="cpu")


def run_pairs():
    pairs = [pair(1), pair(2, 36, 41), pair(3, 12, 9)]
    return nw_torch.align_pairs(pairs, resolve_scoring(None),
                                min_device_cells=200, device="cpu")


def run_device():
    return perform_alignment(*pair(4), backend="device", device="cpu")


def run_device_plain():
    """A callable scoring: the plain wavefront's route."""
    sc = (lambda a, b: 2 if a == b else -1, -2, -2, -1, -1)
    return perform_alignment(*pair(5), scoring_system=sc, backend="device",
                             device="cpu")


# (entry point, its parent span, whether the replay lies inside it:
# perform_alignment replays after nw_torch.align_ops returns)
CALLS = {
    "align_grid": (run_grid, "ta.nw.align_grid", True),
    "align_pairs": (run_pairs, "ta.nw.align_pairs", True),
    "perform_alignment": (run_device, "ta.nw.align_ops", False),
    "perform_alignment_plain": (run_device_plain, "ta.nw.align_ops", False),
}


def spans_of(prof):
    """(name, start, end, is a user annotation) of every ``ta.`` event."""
    return [(e.name, e.time_range.start, e.time_range.end,
             e.is_user_annotation) for e in prof.events()
            if e.name.startswith("ta.")]


@functools.cache
def profiled(call):
    """One run of ``call`` under a CPU profiler (reading the profiler's
    events takes seconds here, so each call is profiled once): its output
    and its spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = CALLS[call][0]()
    return out, spans_of(prof)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_nw_spans_nest_in_their_order(call):
    _, parent, replay_inside = CALLS[call]
    _, spans = profiled(call)
    (top,) = [s for s in spans if s[0] == parent]
    first = {}
    for name, s, _, _ in spans:
        first.setdefault(name, s)
    assert sorted(first, key=first.get) == [parent, *STAGES]
    assert [s[0] for s in spans].count("ta.nw.replay") == 1
    assert not any(s[3] for s in spans), "a span is a user annotation"
    for name, s, e, _ in spans:
        if name == parent:
            continue
        inside = top[1] <= s <= e <= top[2]
        if name.startswith("ta.nw.replay") and not replay_inside:
            assert s >= top[2], (name, s, top)
        else:
            assert inside, (name, s, e, top)


def replays(call):
    """The ``ta.nw.replay_one`` spans a call should open: one a distinct
    alignment of the grid's rows (each row's wire is distinct exactly
    where its alignment is, on this pair), one a pair that ran on the
    device (two of run_pairs' three: the third has 130 cells), one for
    perform_alignment."""
    if call == "align_grid":
        return len({(tuple(a), tuple(b)) for a, b in profiled(call)[0]})
    return 2 if call == "align_pairs" else 1


@pytest.mark.parametrize("call", sorted(CALLS))
def test_replay_one_spans_nest_in_the_replay(call):
    _, spans = profiled(call)
    (replay,) = [s for s in spans if s[0] == "ta.nw.replay"]
    ones = [s for s in spans if s[0] == "ta.nw.replay_one"]
    assert len(ones) == replays(call)
    for _, s, e, _ in ones:
        assert replay[1] <= s <= e <= replay[2], (s, e, replay)
    if call == "align_grid":
        assert 1 < len(ones) < len(ROWS)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_spans_change_no_alignment(call):
    assert profiled(call)[0] == CALLS[call][0]()


def _no_range(name):
    raise AssertionError(f"a profiler range {name!r} with no profiler")


@pytest.mark.parametrize("call", sorted(CALLS))
def test_no_range_without_a_profiler(call, monkeypatch):
    monkeypatch.setattr(timing, "_range", _no_range)
    assert not torch.autograd._profiler_enabled()
    assert timing.span("ta.a") is timing.span("ta.b")
    CALLS[call][0]()


@pytest.mark.parametrize("enabled", [False, True])
def test_stage_timer_opens_a_stage_span(enabled):
    timer = StageTimer(enabled=enabled)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer("ocr"):
            torch.ones(3).sum()
        with timer("ocr"):
            pass
    assert [s[0] for s in spans_of(prof)] == ["ta.stage.ocr"] * 2
    if enabled:
        assert timer.counts == {"ocr": 2} and timer.totals["ocr"] > 0
        assert timer.report().split()[:1] == ["ocr:"]
        assert timer.report().endswith("x2")
    else:
        assert not timer.totals and timer.report() == ""
