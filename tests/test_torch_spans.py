"""The port's spans on the CPU: ``utils.timing.span`` and the ``ta.nw.*``
spans of the NW path's entry points under ``torch.profiler``, the
``ta.ocr.*`` spans of kraken's VGSL network (one recurrence in each
layer's span), the no-op that ``span`` is when no profiler records, the
``ta.stage.*`` span of ``StageTimer``, and the ``ta.lstm.cluster`` span
of the recurrence's wide launches."""

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


def run_vgsl():
    """kraken's VGSL network at reduced widths on a batch of three lines."""
    import numpy as np

    from text_alignment_tpu_torch.models import vgsl

    p = vgsl.kernel_params(vgsl.params_from_np(vgsl.init_params_np(
        np.random.default_rng(0), 6, height=16,
        convs=((3, 3, 2), (3, 3, 2), (3, 3, 4), (3, 3, 4)), hidden=4)))
    frames = torch.rand((3, 64, 16))
    return vgsl.vgsl_forward_batched(p, frames, torch.tensor([64, 40, 9]))


def test_vgsl_spans_in_their_order_and_three_scans_a_batch(monkeypatch):
    """``ta.ocr.conv``, one ``ta.ocr.lstm`` a layer, then ``ta.ocr.head``,
    none a user annotation; each layer's span holds one recurrence (a
    ``lstm_scan`` launch on the card: three a batch)."""
    from text_alignment_tpu_torch.models import vgsl

    orig = vgsl.bidir_scan

    def marked(*a):
        with timing.span("ta.test.scan"):
            return orig(*a)

    monkeypatch.setattr(vgsl, "bidir_scan", marked)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_vgsl()
    spans = spans_of(prof)
    ocr = [s for s in spans if s[0].startswith("ta.ocr.")]
    scans = [s for s in spans if s[0] == "ta.test.scan"]
    assert [s[0] for s in ocr] == (["ta.ocr.conv"] + ["ta.ocr.lstm"] * 3
                                   + ["ta.ocr.head"])
    assert not any(s[3] for s in ocr)
    assert all(a[2] <= b[1] for a, b in zip(ocr, ocr[1:]))
    assert len(scans) == 3
    for (_, s, e, _), (_, t0, t1, _) in zip(ocr[1:4], scans):
        assert s <= t0 <= t1 <= e


def test_no_vgsl_range_without_a_profiler(monkeypatch):
    monkeypatch.setattr(timing, "_range", _no_range)
    run_vgsl()


@pytest.mark.parametrize("ns", [100, 128, 200, 256])
def test_cluster_span_around_each_wide_launch(monkeypatch, ns):
    """``models.lstm_kernel.bidir_scan_cuda`` opens one ``ta.lstm.cluster``
    span (not a user annotation) around a launch in clusters of more than
    one CTA (the wide route) and none around a narrow launch, and hands the
    library the cluster size of its plan. The library and the stream are
    stood in for, so the wrapper runs on meta tensors."""
    from text_alignment_tpu_torch import _kernels
    from text_alignment_tpu_torch.models import lstm_kernel as lk

    clusters = []

    class Library:
        def ta_lstm_scan(self, *args):
            clusters.append(args[9])
            with timing.span("ta.test.launch"):
                return 0

    monkeypatch.setattr(_kernels, "lib", Library)
    monkeypatch.setattr(_kernels, "stream_handle", lambda device: 0)
    gx = torch.zeros((2, 3, 4, 4 * ns), device="meta")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for bt in (1, 2):
            lk.bidir_scan_cuda(gx, torch.zeros((2, ns, 4 * ns), device="meta"),
                               torch.zeros((2, 3, ns), device="meta"), bt=bt)
    spans = spans_of(prof)
    cluster = [s for s in spans if s[0] == "ta.lstm.cluster"]
    launches = [s for s in spans if s[0] == "ta.test.launch"]
    assert clusters == [lk.cluster_size(ns, 1), lk.cluster_size(ns, 2)]
    assert len(cluster) == (2 if ns > 128 else 0)
    assert not any(s[3] for s in cluster)
    for (_, s, e, _), (_, t0, t1, _) in zip(cluster, launches):
        assert s <= t0 <= t1 <= e
