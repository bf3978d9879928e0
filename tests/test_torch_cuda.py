"""Hardware lane of the port: each CUDA kernel against its plain PyTorch
version on the card, at the main-path shapes and at odd ones, the skew
search on the card against the host oracle, a training step on the card
against the CPU, the golden JSON fixtures of tests/test_torch_golden.py
through process() and process_batch with the raster on the card,
process_batch(backend="hybrid") against process() on the card, and the
mesh's sharded OCR and grid in one NCCL rank and in two gloo ranks sharing
the card, against the one-process run, the mesh of a gloo group started
outside the launcher, on the card, the end-to-end example's
evaluate_checkpoint on the card against the CPU, and ``backend="device"``
(ops/device.py) on the card against the CPU and the golden JSON. Marked
``cuda``; every test skips when ``torch.cuda.is_available()`` is false.

This file imports no JAX, so it also runs on a machine without it, where
the repository's conftest (which imports JAX) is left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from text_alignment_tpu_torch import _kernels
from text_alignment_tpu_torch.align import nw_kernel, nw_torch
from text_alignment_tpu_torch.models import lineest as tle
from text_alignment_tpu_torch.models import lstm as tl
from text_alignment_tpu_torch.models.lineest_kernel import (
    CENTER_TILE, center_full, center_full_cuda, center_full_reference, tail,
    tail_cuda, tail_plan, tail_reference)
from text_alignment_tpu_torch.models import lstm_kernel as lk
from text_alignment_tpu_torch.models.lstm_kernel import (
    bidir_scan, bidir_scan_cuda, bidir_scan_reference)

import test_torch_example as example_cases
import test_torch_golden as golden_cases
from lineest_tail_model import TAIL_CASES, tail_case
from nw_window_model import TB_KERNEL, windowed_walk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    tl.pin_float32()
    return torch.device("cuda")


@pytest.mark.parametrize("B,T,ni,ns,bt", [
    (12, 640, 48, 100, None), (3, 17, 8, 12, None), (128, 64, 48, 100, None),
    (1, 300, 48, 100, None),       # one row, one tile
    (96, 512, 48, 100, None),      # the gate strips' batch
    (12, 1, 48, 100, None),        # one step: no prefetch, no WOP term
    (5, 40, 8, 13, None),          # ns not a multiple of 4: a padded quad
    (12, 640, 48, 100, 2),         # the folio at the other batch tiles
    (12, 640, 48, 100, 4),
    (12, 640, 48, 100, 8),         # a ragged last batch tile
    (20, 64, 48, 100, 2),
    (20, 64, 48, 100, 8),          # all 25 Wh quads in shared memory
    (6, 48, 48, 128, None),        # 512 threads, 12 quads in shared memory
    (300, 16, 48, 128, None),      # bt = 4 at ns = 128, past one wave
    (4, 24, 48, 160, None),        # the wide route: global-tier quads
    (12, 16, 48, 256, None),       # 1024 threads, one unit group
    (96, 8, 48, 256, None),        # bt = 2 on the wide route
    (3, 12, 48, 300, None),        # two unit groups, a padded quad
    (5, 10, 48, 300, 4),           # a ragged wide tile
    (12, 176, 48, 200, None),      # kraken's folio bucket: clusters of 4
    (128, 16, 48, 200, None),      # bt > 1 at ns = 200, past one wave
    (5, 20, 48, 200, 4),           # a ragged tile in a cluster
    (2, 4, 48, 4096, None),        # clusters of 8, the leftover global tier
])
def test_lstm_scan_kernel_matches_plain(cuda, B, T, ni, ns, bt):
    rng = np.random.default_rng(B + T)
    p = tl.params_from_np(tl.init_params_np(rng, ni, ns, 29, 0.3), cuda)
    xs = torch.from_numpy(rng.normal(0, 1, (B, T, ni)).astype(np.float32))
    lens = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype(np.int32))
    gx, whT, peep = tl.scan_inputs(p, xs.to(cuda), lens.to(cuda))
    before = _kernels.launches["lstm_scan"]
    got = (bidir_scan(gx, whT, peep) if bt is None
           else bidir_scan_cuda(gx, whT, peep, bt=bt))
    assert _kernels.launches["lstm_scan"] == before + 1
    ref = bidir_scan_reference(gx, whT, peep)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("ns", [100, 128, 256])
@pytest.mark.parametrize("B", [8, 12, 16, 32, 64, 96, 128])
def test_lstm_scan_plan_fits(cuda, B, ns):
    """For every batch the recognizer plans, the chosen instantiation's
    CTA fits the card: its clusters one wave where a tile allows it (a
    narrow tile is a cluster of one, and the card holds one an SM), its
    threads within the instantiation's limit, its registers within a
    thread's share of one SM sub-partition (16,384 registers for
    ceil(warps / 4) warps), its shared memory within a block's."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    bt = lk.card_plan(B, ns, cuda)
    a = lk.kernel_attrs(ns, bt, cuda)
    assert a["cluster"] == lk.cluster_size(ns, bt)
    assert (a["active_clusters"] == sms if ns <= 128
            else a["active_clusters"] >= 1)
    assert bt == lk.tiles(ns)[-1] or 2 * -(-B // bt) <= a["active_clusters"]
    assert a["threads"] == lk.cta_threads(ns, a["cluster"]) <= a["max_threads"]
    assert a["regs"] * 32 * -(-a["threads"] // 32 // 4) <= 16384
    assert a["shared_bytes"] <= _kernels.SMEM_LIMIT
    assert 0 <= a["quads_in_registers"] <= lk.quads(ns)
    assert (a["quads_in_global"] == 0 if ns <= 128
            else 0 <= a["quads_in_global"] < lk.quads(ns))


def test_lstm_scan_wide_holds_wh_on_chip(cuda):
    """kraken's width, ns = 200, at the folio's tile: a cluster of 4 CTAs
    holds one direction's Wh on chip (at bt = 1 a thread's whole column in
    registers), no quad of a column is read from global memory in the step
    loop, and the card holds the folio's 2 x 12 clusters at once."""
    a = lk.kernel_attrs(200, 1, cuda)
    assert a["cluster"] == 4 == lk.cluster_size(200, 1)
    assert a["quads_in_global"] == 0
    assert a["quads_in_registers"] == lk.quads(200)
    assert a["threads"] == 224 and a["regs"] <= 255
    assert a["active_clusters"] >= 24


@pytest.mark.parametrize("B,Hp,Wp,kind", TAIL_CASES)
def test_lineest_tail_kernel_matches_plain(cuda, B, Hp, Wp, kind):
    """Bit for bit (center, dsum, dcnt), as the kernel's contract says; the
    cases are the CPU model's (tests/lineest_tail_model.py), which equals
    the plain version on each of them."""
    args = [t.to(cuda) for t in tail_case(B, Hp, Wp, kind)]
    before = _kernels.launches["lineest_tail"]
    got = tail(*args)
    assert _kernels.launches["lineest_tail"] == before + 1
    ref = tail_reference(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_lineest_tail_plan_fills_the_card(cuda):
    """At the folio's batch (B = 12, Hp = 96, Wp = 1536) every launch of
    the tail has a CTA for each SM; the center pass tiles CENTER_TILE
    columns; the shared bytes fit one block."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    K2 = 2 * int(4 * 0.3 * 96 + 0.5) + 1
    plan = tail_plan(12, 96, 1536, K2, cuda)
    assert [p["pass"] for p in plan] == ["A", "B", "C"]
    for p in plan:
        assert p["grid"][0] * p["grid"][1] >= sms
        assert p["smem"] <= _kernels.SMEM_LIMIT
    assert plan[2]["grid"] == (1536 // CENTER_TILE, 12)
    assert plan[2]["threads"] == CENTER_TILE


def test_lineest_tail_rejects_bad_inputs(cuda):
    sm, temp, hs, ws, k2 = (t.to(cuda) for t in tail_case(3, 32, 256))
    with pytest.raises(ValueError):
        tail_cuda(sm.double(), temp, hs, ws, k2)
    with pytest.raises(ValueError):  # an even tap count
        tail_cuda(sm, temp, hs, ws, k2[:, :-1].contiguous())
    # Wp = 60,000: pass B's row of Wp floats exceeds shared memory
    big = torch.zeros((1, 8, 60000), device=cuda)
    with pytest.raises(ValueError):
        tail_cuda(big, big.to(torch.uint8), hs[:1], ws[:1], k2[:1, :49])


def _full_inputs(dev, B, Hp, Wp, seed, size=None):
    """Strips of random (h, w) and a last padding strip (h = w = 0); with
    ``size="full"`` every strip fills the batch (h = Hp, w = Wp), with
    ``"narrow"`` the strips are 1 to 40 columns wide."""
    rng = np.random.default_rng(seed)
    hs = rng.integers(Hp // 2, Hp + 1, B).astype(np.int32)
    ws = rng.integers(Wp // 8, Wp + 1, B).astype(np.int32)
    if size == "full":
        hs[:], ws[:] = Hp, Wp
    else:
        if size == "narrow":
            ws = rng.integers(1, 41, B).astype(np.int32)
        hs[-1] = ws[-1] = 0  # a padding strip of the pack ladder
    grey = (rng.random((B, Hp, Wp)) > 0.12).astype(np.uint8)
    hs_t, ws_t = torch.from_numpy(hs).to(dev), torch.from_numpy(ws).to(dev)
    _, _, _, _, temp, k2 = tle.center_inputs(
        torch.from_numpy(grey).to(dev), hs_t, ws_t, onebit=True)
    return (temp, tle.vgauss_bank(hs_t, Hp).contiguous(),
            tle.hgauss_taps(hs_t, Hp).contiguous(), hs_t, ws_t, k2)


@pytest.mark.parametrize("B,Hp,Wp,size", [
    (12, 96, 1536, None), (5, 32, 256, None), (3, 128, 1000, None),
    (4, 64, 512, "full"),      # every strip h = Hp, w = Wp
    (6, 96, 1536, "narrow"),   # w of 1 to 40 columns
    (1, 96, 1536, None),       # B = 1: the one strip is padding
    (1, 48, 700, "full"),      # B = 1, h = Hp, w = Wp
])
def test_lineest_full_kernel_matches_plain_bit_for_bit(cuda, B, Hp, Wp,
                                                       size):
    args = _full_inputs(cuda, B, Hp, Wp, Hp + Wp, size)
    before = _kernels.launches["lineest_full"]
    got = center_full(*args)
    assert _kernels.launches["lineest_full"] == before + 1
    ref = center_full_reference(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_lineest_full_rejects_bad_inputs(cuda):
    args = list(_full_inputs(cuda, 4, 32, 256, 1))
    bad = list(args)
    bad[1] = args[1].double()  # a float64 v-gauss bank
    with pytest.raises(ValueError):
        center_full_cuda(*bad)
    bad = list(args)
    bad[2] = args[2][:, :-1].contiguous()  # an even tap count
    with pytest.raises(ValueError):
        center_full_cuda(*bad)
    # Wp = 60,000: the tail's row of Wp floats exceeds shared memory
    big = _full_inputs(cuda, 2, 32, 60000, 2)
    with pytest.raises(ValueError):
        center_full_cuda(*big)


def test_wrappers_reject_bad_inputs(cuda):
    gx = torch.zeros((2, 4, 2, 400), device=cuda)
    with pytest.raises(ValueError):
        bidir_scan(gx, torch.zeros((2, 100, 400), device=cuda),
                   torch.zeros((2, 3, 100), device=cuda, dtype=torch.float64))
    big = torch.zeros((2, 4, 2, 4 * 160), device=cuda)
    with pytest.raises(ValueError):  # no bt = 8 tile on the wide route
        bidir_scan_cuda(big, torch.zeros((2, 160, 640), device=cuda),
                        torch.zeros((2, 3, 160), device=cuda), bt=8)


def _nw_batch(pairs, dev):
    """Lane-layout tensors of pairs (sentinels appended) on the card."""
    arrays = nw_torch.lane_batch([(t + [" "], o + [" "]) for t, o in pairs])
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def _nw_pair(n, m, seed):
    rng = np.random.default_rng(seed)
    a = list("abcdefgh ")
    return ([a[k] for k in rng.integers(0, len(a), n)],
            [a[k] for k in rng.integers(0, len(a), m)])


def _valid_equal(a, b, nts, nos):
    for k in range(a.shape[0]):
        ii = torch.arange(int(nts[k]), device=a.device)[:, None]
        jj = torch.arange(int(nos[k]), device=a.device)[None, :]
        if not torch.equal(a[k, ii + jj, ii], b[k, ii + jj, ii]):
            return False
    return True


_NW_ROW = [8, -4, -7, -7, -3, 0, -1, -1]


@pytest.mark.parametrize("n,m", [(4095, 4095), (300, 129), (127, 1000),
                                 (2047, 2400)])
def test_nw_fill_kernel_matches_plain(cuda, n, m):
    t, o, nts, nos = _nw_batch([_nw_pair(n, m, n + m)], cuda)
    row = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    before = _kernels.launches["nw_fill"]
    got = nw_kernel.fill(t, o, row)
    assert _kernels.launches["nw_fill"] == before + 1
    ref = nw_kernel.fill_reference(t, o, row)
    torch.cuda.synchronize()
    assert _valid_equal(got, ref, nts, nos)


@pytest.mark.parametrize("n,m,seg", [(1000, 1000, 128), (1000, 1000, 256),
                                     (1000, 300, 128), (300, 1000, 128),
                                     (1000, 700, 96), (1000, 700, 1056)])
def test_nw_fill_segments_match_plain(cuda, n, m, seg):
    """One pair spread over 4 to 11 segments (a forced S; S = 96 leaves a
    ragged last segment), square and uneven, and one segment wider than
    the pair (S = 1056 > L = 1024, its lanes past L masked): pointer bytes
    equal the plain version's on every valid cell. The Python mirror of
    the shared-memory layout equals the library's."""
    t, o, nts, nos = _nw_batch([_nw_pair(n, m, n + 3 * m)], cuda)
    row = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    P = -(-t.shape[1] // seg)
    assert 4 <= P <= 11 or (P == 1 and seg > t.shape[1])
    threads = seg // nw_kernel._lanes_per_thread(seg)
    assert (_kernels.lib().ta_nw_fill_smem(seg, threads)
            == nw_kernel.fill_smem_bytes(seg))
    got = nw_kernel.fill_cuda(t, o, row, seg=seg)
    ref = nw_kernel.fill_reference(t, o, row)
    torch.cuda.synchronize()
    assert _valid_equal(got, ref, nts, nos)


def test_nw_device_alignment_past_the_old_cap(cuda):
    """A 26,000-element transcript against a 2,000-element OCR (L =
    26,112, over the one-block cap of 25,600 lanes) aligns on the card
    exactly as on the host."""
    from text_alignment_tpu_torch.align import perform_alignment

    t, o = _nw_pair(26000, 2000, 26)
    before = _kernels.launches["nw_fill"]
    dev = perform_alignment(t, o, backend="device", device=cuda)
    assert _kernels.launches["nw_fill"] == before + 1
    assert dev == perform_alignment(t, o, backend="host")


def test_nw_fill_batched_past_the_old_cap(cuda):
    """Two pairs of L = 26,112 in one batched launch, planned into
    segments: pointer bytes equal the plain version's."""
    t, o, nts, nos = _nw_batch([_nw_pair(26000, 200, 1),
                                _nw_pair(25800, 230, 2)], cuda)
    assert t.shape[1] == 26112
    row = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    got = nw_kernel.fill_batched(t, o, row)
    ref = nw_kernel.fill_reference(t, o, row)
    torch.cuda.synchronize()
    assert _valid_equal(got, ref, nts, nos)


@pytest.mark.parametrize("mode", ["shared_row", "per_pair_shared_feed",
                                  "per_pair_own_feeds"])
def test_nw_fill_batched_kernel_matches_plain(cuda, mode):
    if mode == "per_pair_shared_feed":
        pairs = [_nw_pair(300, 280, 1)] * 8
    else:
        pairs = [_nw_pair(150 + 40 * k, 330 - 30 * k, k) for k in range(6)]
    t, o, nts, nos = _nw_batch(pairs, cuda)
    B = t.shape[0]
    if mode == "shared_row":
        params = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    else:
        rng = np.random.default_rng(B)
        rows = np.concatenate([rng.integers(1, 12, (B, 1)),
                               -rng.integers(0, 10, (B, 5)),
                               np.full((B, 2), -1)], axis=1)
        params = torch.from_numpy(rows.astype(np.int32)).to(cuda)
    if mode == "per_pair_shared_feed":
        o = o[:1].contiguous()
    before = _kernels.launches["nw_fill_batched"]
    got = nw_kernel.fill_batched(t, o, params)
    assert _kernels.launches["nw_fill_batched"] == before + 1
    ref = nw_kernel.fill_reference(t, o, params)
    torch.cuda.synchronize()
    assert _valid_equal(got, ref, nts, nos)


def _tb_equal_to_plain(packed, nts, nos):
    """The kernel's wire against the plain walk's (k, xpt, ypt, ops[:k]),
    and its window and miss counts against the CPU model's schedule at the
    kernel's constants (``nw_window_model``)."""
    before = _kernels.launches["nw_traceback"]
    w1 = nw_kernel.traceback_batched(packed, nts, nos)
    assert _kernels.launches["nw_traceback"] == before + 1
    w0 = nw_kernel.traceback_reference(packed, nts, nos)
    torch.cuda.synchronize()
    assert torch.equal(w1[:, :3], w0[:, :3])
    for b in range(packed.shape[0]):
        k = int(w1[b, 0])
        assert torch.equal(w1[b, 3:3 + k], w0[b, 3:3 + k])
    model, _ = windowed_walk(packed.cpu().numpy(), nts.cpu().numpy(),
                             nos.cpu().numpy(), **TB_KERNEL)
    windows, misses = nw_kernel.traceback_stats(w1)
    assert windows.tolist() == model[:, -2].tolist()
    assert misses.tolist() == model[:, -1].tolist()
    return w1


def _group_case(mode, pairs, dev, rows=None):
    """t, o, params, nts, nos on the card for one of the batched fill's
    modes: "shared_row" (own rows, one scoring row), "per_pair_shared_feed"
    (the first pair's one transcript and one OCR row, a scoring row each of
    ``rows`` or B seeded rows: the grid) and "per_pair_own_feeds"."""
    t, o, nts, nos = _nw_batch(pairs, dev)
    B = t.shape[0] if rows is None else rows
    rng = np.random.default_rng(B)
    prm = np.concatenate([rng.integers(1, 12, (B, 1)),
                          -rng.integers(0, 10, (B, 5)), np.full((B, 2), -1)],
                         axis=1)
    params = torch.from_numpy(prm.astype(np.int32)).to(dev)
    if mode == "shared_row":
        params = params[:1].contiguous()
    if mode == "per_pair_shared_feed":
        t, o, nts, nos = t[:1], o[:1], nts[:1], nos[:1]
    return t, o, params, nts, nos


def _group_fill_equal(t, o, params, nts, nos, group=None, run=None):
    """The group route's pointer bytes equal the plain version's on every
    valid cell of every pair, and the traceback kernel over them equals the
    plain walk, with the window model's counts."""
    before = _kernels.launches["nw_fill_batched"]
    got = nw_kernel.fill_batched_cuda(t, o, params, nts, nos, group=group,
                                      run=run)
    assert _kernels.launches["nw_fill_batched"] == before + 1
    ref = nw_kernel.fill_reference(t, o, params)
    torch.cuda.synchronize()
    B = got.shape[0]
    bn, bo = nts.expand(B).contiguous(), nos.expand(B).contiguous()
    assert _valid_equal(got, ref, bn, bo)
    _tb_equal_to_plain(got, bn, bo)


@pytest.mark.parametrize("mode", ["shared_row", "per_pair_shared_feed",
                                  "per_pair_own_feeds"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_nw_fill_batched_groups_match_plain(cuda, mode, group):
    """The group route at G = 1, 2 and 4 pairs a CTA in all three modes,
    7 pairs (a ragged last group for G = 2 and 4), each filled only over its
    extent: valid cells equal the plain version's, and the traceback kernel
    walks them as the plain walk does."""
    pairs = [_nw_pair(200 + 45 * k, 330 - 30 * k, 60 + k) for k in range(7)]
    _group_fill_equal(*_group_case(mode, pairs, cuda, rows=7), group=group)


@pytest.mark.parametrize("group,run", [(1, 1), (2, 2), (4, 2), (2, 4),
                                       (1, 8)])
def test_nw_fill_batched_mixed_extents(cuda, group, run):
    """One bucket (L = 1024) of pairs of very different sizes, most with
    Nt much below L and one with No = 1: each pair stops at its own extent
    inside a group whose CTA is shaped by the largest Nt."""
    pairs = [_nw_pair(n, m, n + m) for n, m in
             [(900, 40), (30, 700), (120, 120), (600, 0), (5, 900), (50, 60)]]
    t, o, nts, nos = _nw_batch(pairs, cuda)
    assert t.shape[1] == 1024
    row = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    _group_fill_equal(t, o, row, nts, nos, group=group, run=run)


@pytest.mark.parametrize("mode", ["shared_row", "per_pair_own_feeds"])
def test_nw_fill_batched_full_and_unit_extents(cuda, mode):
    """Full buckets (Nt = L, No = NoP), Nt = 1, No = 1 and Nt = No = 1 in
    one launch, at G = 2 and 4 and the plan."""
    pairs = [_nw_pair(127, 255, 1), _nw_pair(0, 200, 2), _nw_pair(100, 0, 3),
             _nw_pair(0, 0, 4), _nw_pair(127, 3, 5)]
    case = _group_case(mode, pairs, cuda)
    assert case[0].shape[1] == 128 and case[1].shape[1] == 256
    assert int(case[3].max()) == 128 and int(case[4].max()) == 256
    for group in (2, 4, None):
        _group_fill_equal(*case, group=group)


def test_nw_fill_batched_grid_rows(cuda):
    """Six rows of the 2400^2 grid (one transcript and one OCR row, a
    scoring row each) at the plan and at G = 1 and 2: valid cells equal
    the plain version's, and the walks the plain walk's."""
    t, o = _nw_pair(2400, 2400, 2400)
    tt, oo, nts, nos = _nw_batch([(t, o)], cuda)
    rows = np.concatenate([np.array([[8, -4, -7, -7, -3, 0], [5, -5, -3, -3,
                                     -1, -1], [10, -2, -9, -4, -4, -2],
                                     [3, -6, -2, -8, 0, -3], [7, -3, -7, -7,
                                     -3, 0], [6, -6, -6, -6, -2, -2]]),
                           np.full((6, 2), -1)], axis=1)
    pr = torch.from_numpy(rows.astype(np.int32)).to(cuda)
    for group in (None, 1, 2):
        _group_fill_equal(tt, oo, pr, nts, nos, group=group)


def test_nw_group_attrs_cover_every_instantiation(cuda):
    """Every (run, G) of nw_kernel.GROUPS is compiled in both id forms, and
    the plan refuses none of the grids' shapes for spilling."""
    for shared in (False, True):
        attrs = nw_kernel.group_attrs(cuda, shared)
        assert sorted(attrs) == sorted(nw_kernel.GROUPS)
        for regs, spill, max_threads in attrs.values():
            assert 0 < regs <= 255 and max_threads >= 32 and spill == 0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    attrs = nw_kernel.group_attrs(cuda, True)
    for B, n, L in ((729, 316, 512), (243, 2401, 2560)):
        assert nw_kernel.group_plan(B, n, L, sms, attrs) is not None


def test_nw_traceback_kernel_matches_plain(cuda):
    pairs = [_nw_pair(1100 + 150 * k, 1900 - 140 * k, 50 + k)
             for k in range(6)]
    t, o, nts, nos = _nw_batch(pairs, cuda)
    row = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    _tb_equal_to_plain(nw_kernel.fill_batched(t, o, row), nts, nos)


def test_nw_traceback_kernel_crosses_many_windows(cuda):
    """A 6000-character pair that differs in one character in 50 walks an
    almost diagonal path through dozens of 256 x 128 windows, each taken
    from the prefetch (no miss), and a random 3000 x 2500 pair through
    dozens more: wires equal the plain walk's."""
    rng = np.random.default_rng(11)
    a = list("abcdefgh")
    t = [a[k] for k in rng.integers(0, 8, 6000)]
    o = [a[(a.index(c) + 1) % 8] if k % 50 == 7 else c
         for k, c in enumerate(t)]
    row = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    for n, pair in enumerate([(t, o), _nw_pair(3000, 2500, 9)]):
        tt, oo, nts, nos = _nw_batch([pair], cuda)
        wire = _tb_equal_to_plain(nw_kernel.fill(tt, oo, row), nts, nos)
        windows, misses = nw_kernel.traceback_stats(wire)
        assert int(windows[0]) >= int(wire[0, 0]) // nw_kernel.TB_LANES >= 20
        if n == 0:
            assert int(misses[0]) == 0


def test_nw_traceback_kernel_when_the_prediction_misses(cuda):
    """Gap runs of 400 characters in either sequence bend the path away
    from the slope the prefetch extrapolates: the kernel stages windows on
    demand (misses >= 1) in a batch of both and a plain pair, and its wires
    equal the plain walk's."""
    rng = np.random.default_rng(12)
    a = list("abcdefgh")
    base = [a[k] for k in rng.integers(0, 8, 2500)]
    junk = ["z"] * 400
    pairs = [(base, base[:1200] + junk + base[1200:]),
             (base[:1200] + junk + base[1200:], base), (base, list(base))]
    t, o, nts, nos = _nw_batch(pairs, cuda)
    row = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    wire = _tb_equal_to_plain(nw_kernel.fill_batched(t, o, row), nts, nos)
    windows, misses = nw_kernel.traceback_stats(wire)
    assert int(misses[0]) >= 1 and int(misses[1]) >= 1
    assert int(misses[2]) == 0


def test_nw_wrappers_reject_bad_inputs(cuda):
    t, o, nts, nos = _nw_batch([_nw_pair(100, 100, 0)] * 3, cuda)
    row = torch.tensor([_NW_ROW], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # int64 ids
        nw_kernel.fill_batched(t.long(), o, row)
    with pytest.raises(ValueError):  # a 6-value scoring row
        nw_kernel.fill_batched(t, o, row[:, :6].contiguous())
    with pytest.raises(ValueError):  # 2 OCR rows for 3 pairs
        nw_kernel.fill_batched(t, o[:2].contiguous(), row)
    with pytest.raises(ValueError):  # the single-pair entry takes one pair
        nw_kernel.fill(t, o, row)
    with pytest.raises(ValueError):  # a segment over 32 lanes x 1024 threads
        nw_kernel.fill_cuda(t[:1].contiguous(), o[:1].contiguous(), row,
                            seg=65536)
    packed = nw_kernel.fill_batched(t, o, row)
    with pytest.raises(ValueError):  # No past the bucket
        nw_kernel.traceback_batched(packed, nts, nos + 1000)
    with pytest.raises(ValueError):  # int64 sizes
        nw_kernel.traceback_batched(packed, nts.long(), nos)
    with pytest.raises(ValueError):  # L not a multiple of the window's lanes
        nw_kernel.traceback_batched(
            torch.zeros((3, 300, 200), dtype=torch.uint8, device=cuda), nts,
            nos)


def _stroke(H, W):
    """One tall stroke through every band, a staircase diagonal (whose
    bands meet only through 8-connectivity) and a comb whose teeth, each
    rooted in the first band, join only in the last row."""
    img = np.zeros((H, W), bool)
    img[:, W // 2:W // 2 + 3] = True
    y = np.arange(H)
    img[y, (y * 7 // 5) % (W // 3)] = True
    img[:, W - 60:W - 2:6] = True
    img[-1, W - 60:W - 2] = True
    return img


def _cc_pages():
    rng = np.random.default_rng(21)
    bars = np.zeros((300, 1000), bool)
    bars[:, ::3] = True
    bars[150, :] = True
    return {"random30": rng.random((257, 999)) < 0.3,
            "random60": rng.random((64, 96)) < 0.6,
            "bars": bars, "empty": np.zeros((40, 33), bool),
            "one_row": rng.random((1, 999)) < 0.4,
            "short": rng.random((5, 300)) < 0.4,         # H below one band
            # > 4096 runs a band: the band works in device memory
            "dense": rng.random((24, 6000)) < 0.5,
            **{f"stroke{H}": _stroke(H, 400) for H in (300, 2000, 5000, 9000)}}


def test_cc_pages_cover_several_band_heights(cuda):
    """The pages of the next test give the band kernel heights of 8 to 64
    rows, bands that do not divide H, and pages of fewer rows than one
    band."""
    band = {name: _kernels.lib().ta_cc_band_rows(img.shape[0])
            for name, img in _cc_pages().items()}
    assert len(set(band.values())) >= 4
    assert band["stroke300"] == 8 and band["stroke9000"] == 64
    assert 300 % band["stroke300"] and 5000 % band["stroke5000"] == 0
    assert band["short"] > 5 and band["one_row"] > 1


@pytest.mark.parametrize("name", list(_cc_pages()))
def test_cc_kernels_match_plain(cuda, name):
    from text_alignment_tpu_torch.ops import cc

    img = _cc_pages()[name]
    H, W = img.shape
    page = torch.from_numpy(cc.pack_page(img))
    dev = page.to(cuda)
    for mode in (cc.MODE_BLACK, cc.MODE_WHITE, cc.MODE_TALL):
        for k in (0, 3, 25, 175):
            before = _kernels.launches["cc_filter"]
            got, ok = cc.cc_filter(dev, H, W, k, mode, by_area=k == 25)
            assert _kernels.launches["cc_filter"] == before + 1
            ref, ok_ref = cc.filter_reference(page, H, W, k, mode, k == 25,
                                              cc.MAX_RUNS)
            assert torch.equal(got.cpu(), ref) and torch.equal(ok.cpu(),
                                                               ok_ref)
    got, ok = cc.cc_clean(dev, H, W, 10, 20)
    ref, ok_ref = cc.clean_reference(page, H, W, 10, 20, False, cc.MAX_RUNS)
    assert torch.equal(got.cpu(), ref) and torch.equal(ok.cpu(), ok_ref)
    for thresh in (-1, 4):
        got, ok = cc.cc_table(dev, H, W, thresh, 4096)
        ref, ok_ref = cc.table_reference(page, H, W, thresh, 4096,
                                         cc.TABLE_MAX_RUNS)
        assert torch.equal(got.cpu(), ref) and torch.equal(ok.cpu(), ok_ref)


def test_cc_kernels_overflow_like_plain(cuda):
    from text_alignment_tpu_torch.ops import cc

    img = np.zeros((64, 90), bool)
    img[::2, ::2] = True  # 1440 black runs and components, 1472 white runs
    page = torch.from_numpy(cc.pack_page(img))
    got, ok = cc.cc_filter(page.to(cuda), 64, 90, 0, cc.MODE_WHITE,
                           max_runs=512)
    ref, ok_ref = cc.filter_reference(page, 64, 90, 0, cc.MODE_WHITE, False,
                                      512)
    assert torch.equal(got.cpu(), ref)
    assert ok.tolist() == ok_ref.tolist() and ok_ref.tolist()[0] == 0
    tab, ok = cc.cc_table(page.to(cuda), 64, 90, -1, 100)
    tab_ref, ok_ref = cc.table_reference(page, 64, 90, -1, 100, 8192)
    assert torch.equal(tab.cpu(), tab_ref)
    assert ok.tolist() == ok_ref.tolist() == [0, 100]


def test_cc_table_while_another_thread_allocates(cuda):
    """cc_table in this thread while a second thread allocates and writes
    blocks of its scratch's size on the same stream (as the batch's OCR
    worker does): every table equals the first. A wrapper that freed its
    scratch before the C call returned got some of them wrong here."""
    import threading

    from text_alignment_tpu_torch.ops import cc
    from text_alignment_tpu_torch.synth import make_page

    page = make_page(np.random.default_rng(3000), n_lines=11,
                     words_per_line=3, H=2000, W=1600, char_h=66, char_w=36,
                     gap=6, space_w=44, line_spacing=170, speckles=200,
                     margin_x=60)
    img = np.asarray(page.image).mean(axis=2) < 128
    H, W = img.shape
    dev = torch.from_numpy(cc.pack_page(img)).to(cuda)
    R = 65536  # the page's ~41k black runs, before the cleanup
    ref = [t.cpu() for t in cc.cc_table(dev, H, W, 100, 2048, R)]
    assert ref[1].tolist() == [1, 229]
    n = _kernels.lib().ta_cc_scratch_ints(H, R)
    stream = torch.cuda.current_stream(cuda)
    stop = threading.Event()

    def allocate():
        with torch.cuda.stream(stream):
            while not stop.is_set():
                torch.empty(n, dtype=torch.int32, device=cuda).fill_(-7)

    th = threading.Thread(target=allocate, daemon=True)
    th.start()
    try:
        wrong = sum(not all(torch.equal(g.cpu(), r) for g, r in zip(
            cc.cc_table(dev, H, W, 100, 2048, R), ref))
            for _ in range(300))
    finally:
        stop.set()
        th.join()
    assert wrong == 0


def test_skew_search_on_the_card(cuda):
    from text_alignment_tpu_torch.ops import device as dv
    from text_alignment_tpu_torch.ops import oracle
    from text_alignment_tpu_torch.synth import make_page

    page = make_page(np.random.default_rng(12), n_lines=4, words_per_line=2)
    img = oracle.to_onebit(page.image)
    for angle in (None, 1.37, -2.6):
        a = oracle.rotate_onebit(img, angle) if angle else img
        assert (dv.rotation_angle_projections(a, device=cuda)
                == oracle.rotation_angle_projections(a, -6, 6))


def _bench_page(seed):
    """The benchmark's page geometry (2000 x 1600, 10 lines of 3 words,
    0.8 degree skew)."""
    from text_alignment_tpu_torch.synth import make_page

    return make_page(np.random.default_rng(seed), n_lines=10,
                     words_per_line=3, H=2000, W=1600, char_h=70, char_w=40,
                     gap=8, space_w=60, line_spacing=180, speckles=200,
                     margin_x=60, angle=0.8)


def _raster_pages():
    """(name, stage-1 page, runs, n_runs): the bench page's native stage 1,
    and a seeded page wide enough that a CTA takes fewer rows."""
    from text_alignment_tpu_torch.ops import host_native

    wide = np.where(np.random.default_rng(9).random((90, 12005, 3)) < 0.4,
                    0, 255).astype(np.uint8)
    return [("bench",) + host_native.preprocess_page_phase1(
                _bench_page(24).image, 100, 150),
            ("wide",) + host_native.preprocess_page_phase1(wide, 2, 150)]


# None: correct_rotation=False; then seeded angles of the search's range
RASTER_ANGLES = [None, 0.8, -0.8, 6.0, -6.0] + [
    round(float(a), 2) for a in np.random.default_rng(3).uniform(-6, 6, 3)]


@pytest.mark.parametrize("angle", RASTER_ANGLES)
def test_raster_kernel_matches_plain_and_native(cuda, angle):
    """ta_raster_rotate_erode on the packed stage-1 page gives its plain
    version's rotated page, eroded page and projection bit for bit, and
    the native engine's rotate + erode (ta_erode2) and row projection."""
    from text_alignment_tpu_torch.ops import cc, host_native
    from text_alignment_tpu_torch.ops import device as dv
    from text_alignment_tpu_torch.ops import fixedpoint as fxp

    for name, img, runs, n_runs in _raster_pages():
        H, W = img.shape
        if angle is None:
            cfix, sfix, H2, W2 = fxp.SCALE, 0, H, W
        else:
            cfix, sfix = fxp.rotation_coeffs(angle)
            H2, W2 = fxp.rotated_canvas(H, W, angle)
        packed = torch.from_numpy(cc.pack_page(img.astype(bool)))
        _kernels.reset_launches()
        got = dv.rotate_erode_project_packed(packed.to(cuda), H, W, cfix,
                                             sfix, H2, W2)
        torch.cuda.synchronize()
        assert _kernels.launches["raster_rotate_erode"] == 1
        band = _kernels.lib().ta_raster_band_rows(-(-W2 // 32))
        assert (band < 16) == (name == "wide")
        want = dv.rotate_erode_project_reference(packed, H, W, cfix, sfix,
                                                 H2, W2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), name)
        bin_n, ero_n = host_native.preprocess_page_phase2(
            img, runs, n_runs, 0.0 if angle is None else angle, 1, 2,
            angle is not None)
        np.testing.assert_array_equal(
            cc.unpack_page(got[0].cpu().numpy(), H2, W2), bin_n)
        np.testing.assert_array_equal(
            cc.unpack_page(got[1].cpu().numpy(), H2, W2), ero_n)
        np.testing.assert_array_equal(got[2].cpu().numpy(),
                                      host_native.projection_rows(ero_n))


def test_process_hybrid_rasters_on_the_card(cuda, monkeypatch):
    """process(backend="hybrid") on the card rasters the folio there: one
    raster_rotate_erode, one cc_clean and one cc_table launch a folio, the
    native engine's strips (the CPU's route) and the CPU's JSON."""
    import importlib

    from text_alignment_tpu_torch.pipeline import to_JSON_dict
    from text_alignment_tpu_torch.pipeline.assemble import to_processed_frame
    from text_alignment_tpu_torch.pipeline.preprocess import preprocess_images
    from text_alignment_tpu_torch.synth import corrupt_ocr, ocr_with_spaces

    proc = importlib.import_module(
        "text_alignment_tpu_torch.pipeline.process")
    page = _bench_page(31)
    image, _, angle = preprocess_images(page.image, backend="hybrid")
    ocr = [to_processed_frame(cb, angle, image.shape, page.image.shape)
           for cb in ocr_with_spaces(corrupt_ocr(np.random.default_rng(5),
                                                 page.char_boxes))]
    finder, seen = proc.identify_text_lines, []

    def lines(image, eroded, backend, **kw):
        out = finder(image, eroded, backend=backend, **kw)
        seen.append((type(eroded).__name__,
                     [(s.offset_x, s.offset_y, s.img.tobytes())
                      for s in out[0]]))
        return out

    monkeypatch.setattr(proc, "identify_text_lines", lines)
    out = {}
    for dev in ("cpu", cuda, cuda):
        _kernels.reset_launches()
        res = proc.process(page.image, page.transcript, existing_ocr=ocr,
                           verbose=False, backend="hybrid", device=dev)
        torch.cuda.synchronize()
        out[str(dev)] = to_JSON_dict(res[0], res[2])
        launches = dict(_kernels.launches)
    for k in ("raster_rotate_erode", "cc_clean", "cc_table"):
        assert launches[k] == 1, (k, launches)
    assert [b for b, _ in seen] == ["ndarray", "PackedPage", "PackedPage"]
    assert seen[1][1] == seen[2][1] == seen[0][1] and len(seen[0][1]) == 10
    assert out["cuda"] == out["cpu"] and out["cpu"]["syl_boxes"]


def test_batch_hybrid_matches_process_on_the_card(cuda):
    """process_batch(backend="hybrid") on the card rasters there as
    process() does (one raster_rotate_erode launch a folio), with the OCR
    pipelined, and gives process()'s JSON folio for folio."""
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
    from text_alignment_tpu_torch.parallel import process_batch
    from text_alignment_tpu_torch.pipeline import process, to_JSON_dict

    rec = SeqRecognizer(tl.params_from_np(example_cases.peaky_params()),
                        Codec(), normalize_on_device=True, device=cuda)
    pages = [_bench_page(40 + k) for k in range(4)]
    want = []
    for p in pages:
        out = process(p.image, p.transcript, ocropus_model=rec,
                      backend="hybrid", verbose=False, device=cuda)
        want.append(None if out is None else to_JSON_dict(out[0], out[2]))
    _kernels.reset_launches()
    got = process_batch([(p.image, p.transcript) for p in pages], rec,
                        backend="hybrid", device=cuda)
    torch.cuda.synchronize()
    assert _kernels.launches["raster_rotate_erode"] == len(pages)
    assert any(w is not None for w in want)
    assert [None if r is None else r.json_dict for r in got] == want


def _train_batch(B, T, ni, nlab, seed):
    rng = np.random.default_rng(seed)
    xs = rng.random((B, T, ni)).astype(np.float32)
    xs[:, 10:14] = 0.0  # empty frames for the grounding term
    xl = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lb = rng.integers(1, nlab, (B, 12)).astype(np.int32)
    ll = rng.integers(0, 13, B).astype(np.int32)
    for b in range(B):
        lb[b, ll[b]:] = 0
    return xs, xl, lb, ll


@pytest.mark.parametrize("gw", [0.0, 0.5])
def test_train_step_card_matches_cpu(cuda, gw):
    """One Trainer step at the recognizer's width (ni = 48, ns = 100) from
    the same seeded weights and batch: the loss to 1e-5 relative, every
    gradient to 1e-4 x the global norm, the weights after the step to
    1e-5 wherever the gradient exceeds 1e-6."""
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.train import Trainer

    codec = Codec()
    batch = _train_batch(6, 96, 48, len(codec), 11)
    trainers = [Trainer(codec, seed=2, ground_weight=gw, device=d)
                for d in ("cpu", cuda)]
    grads, losses = [], []
    for tr in trainers:
        args = tr.tensors(*batch)
        loss = tr.loss(*args, gw)
        loss.backward()
        losses.append(loss.item())
        grads.append([p.grad.cpu() for p in tr.model.parameters()])
        tr.optimizer.zero_grad(set_to_none=True)
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads[0])))
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * norm
    steps = [tr.step(*batch) for tr in trainers]
    assert abs(steps[1] - steps[0]) <= 1e-5 * abs(steps[0])
    for a, b, g in zip(tl.params_leaves(trainers[0].params),
                       tl.params_leaves(trainers[1].params), grads[0]):
        sure = g.abs() > 1e-6
        assert (a[sure] - b.cpu()[sure]).abs().max().item() <= 1e-5


def test_train_resume_is_bit_exact_on_the_card(cuda, tmp_path):
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.train import Trainer

    codec = Codec()
    batch = _train_batch(8, 128, 48, len(codec), 12)
    straight = Trainer(codec, seed=3, device=cuda)
    for _ in range(6):
        straight.step(*batch)
    first = Trainer(codec, seed=3, device=cuda)
    for _ in range(3):
        first.step(*batch)
    resumed = Trainer.load_state(first.save_state(str(tmp_path / "t.state")),
                                 device=cuda)
    for _ in range(3):
        resumed.step(*batch)
    for a, b in zip(tl.params_leaves(straight.params),
                    tl.params_leaves(resumed.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", ["trained", "peaky"])
def test_example_evaluate_checkpoint_on_the_card(cuda, tmp_path, model):
    """The end-to-end example's evaluate_checkpoint on the card (the
    recurrence and the device normalizer's tail kernel) against the same
    call on the CPU, on tests/test_torch_example.py's two files: the
    Trainer(seed=1) of two steps on the example's first minibatch (trained
    on the card, its losses to 1e-5 relative of the CPU's) and the peaky
    seeded weights. The bar is decode equality, which equal syllable
    counts, IoUs and diagnosis show."""
    from text_alignment_tpu_torch.examples import end_to_end_synthetic as e2e
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
    from text_alignment_tpu_torch.models.train import Trainer

    if model == "trained":
        codec, batch = example_cases.first_minibatch()
        trainers = [Trainer(codec=codec, lr=3e-3, seed=1, clip_norm=1.0,
                            device=d) for d in (cuda, "cpu")]
        losses = [[tr.step(*batch) for _ in range(2)] for tr in trainers]
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
        path = trainers[0].save(str(tmp_path / "synthetic"))
    else:
        path = str(tmp_path / "peaky.pyrnn.gz")
        save_pyrnn(path, example_cases.peaky_params(), Codec())
    page, gt = e2e.heldout_page()
    _kernels.reset_launches()
    got = e2e.evaluate_checkpoint(path, page, gt, "hybrid", "region", cuda)
    assert _kernels.launches["lstm_scan"] >= 1
    assert _kernels.launches["lineest_tail"] >= 1
    assert got == e2e.evaluate_checkpoint(path, page, gt, "hybrid",
                                          "region", "cpu")


@pytest.mark.parametrize("name", sorted(golden_cases.GOLDEN))
def test_golden_json_on_the_card(cuda, name):
    """process(backend="hybrid") on the card, and process_batch with the
    same backend, both rastering on the card (the CC kernels, the skew
    search, the rotate + erode + project kernel), give the golden JSON."""
    from text_alignment_tpu_torch.parallel import process_batch

    want = golden_cases.golden(name)
    assert golden_cases.run_golden(name, "hybrid", cuda) == want
    make, params = golden_cases.GOLDEN[name]
    page, transcript, ocr = make()
    res, = process_batch([(page.image, transcript)], None,
                         backend="hybrid", preproc_params=params,
                         existing_ocr=[ocr], device=cuda)
    assert (None if res is None else res.json_dict) == want


@pytest.mark.parametrize("name", sorted(golden_cases.GOLDEN))
def test_golden_json_on_the_device_backend(cuda, name):
    """process(backend="device") on the card (ops/device.py through the CC
    kernels, NW through the fill and traceback kernels) and
    process_batch with its default backend, "device", give the golden
    JSON."""
    from text_alignment_tpu_torch.parallel import process_batch

    want = golden_cases.golden(name)
    _kernels.reset_launches()
    assert golden_cases.run_golden(name, "device", cuda) == want
    for kernel in ("cc_clean", "cc_table", "nw_fill", "nw_traceback"):
        assert _kernels.launches[kernel] >= 1, kernel
    make, params = golden_cases.GOLDEN[name]
    page, transcript, ocr = make()
    res, = process_batch([(page.image, transcript)], None,
                         preproc_params=params, existing_ocr=[ocr],
                         device=cuda)
    assert (None if res is None else res.json_dict) == want


def _serpentine(n=250, width=40):
    img = np.zeros((2 * n - 1, width), bool)
    img[::2] = True
    for i in range(n - 1):
        img[2 * i + 1, width - 1 if i % 2 == 0 else 0] = True
    return img


def _device_op_cases():
    """ops/device.py calls on seeded pages, each a function of the
    device."""
    from text_alignment_tpu_torch.ops import device as dv
    from text_alignment_tpu_torch.ops import fixedpoint as fxp

    rng = np.random.default_rng(5)
    r = rng.random((300, 257)) < 0.3
    dense = rng.random((24, 6000)) < 0.5  # > 4096 runs a band
    rgb = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (90, 120, 4), dtype=np.uint8)
    mask = np.arange(300) % 37 < 2
    cf, sf = fxp.rotation_coeffs(1.3)
    H2, W2 = fxp.rotated_canvas(300, 257, 1.3)
    return {
        "to_onebit_rgb": lambda d: dv.to_onebit(rgb, d),
        "to_onebit_rgba": lambda d: dv.to_onebit(rgba, d),
        "grey_histogram": lambda d: dv.grey_histogram(
            dv.to_greyscale(rgb, d), d),
        "despeckle": lambda d: dv.despeckle(r, 3, d),
        "despeckle_dense": lambda d: dv.despeckle(dense, 3, d),
        "despeckle_white": lambda d: dv.despeckle_white(r, 3, d),
        "remove_small_ccs": lambda d: dv.remove_small_ccs(r, 4, d),
        "remove_tall_ccs": lambda d: dv.remove_tall_ccs(r, 6, d),
        "remove_big_ccs": lambda d: dv.remove_big_ccs(r, 20, d),
        "cc_label": lambda d: dv.cc_label(r, d),
        "cc_stats_compact": lambda d: dv.cc_stats_compact(r, device=d),
        "cc_stats_past_max_ccs": lambda d: dv.cc_stats_compact(
            r, 50, device=d),
        "filter_runs": lambda d: dv.filter_narrow_runs(r, 3, "white", d),
        "preproc_stage1": lambda d: dv.preproc_stage1(
            dv.to_greyscale(rgb, d), 120, 3, 30, device=d),
        "preproc_stage1_dense": lambda d: dv.preproc_stage1(
            np.where(dense, 0, 255).astype(np.uint8), 120, 3, 10,
            sat_by_area=True, device=d),
        "rotate_onebit": lambda d: dv.rotate_onebit(r, -4.2, d),
        "rotate_erode_project": lambda d: dv.rotate_erode_project(
            r, cf, sf, H2, W2, 1, 2, d),
        "shear_projections": lambda d: dv.shear_projections(
            r, fxp.shear_shifts_batch([-3.0, 0.0, 1.5], 257), d),
        "rotation_angle_projections": lambda d:
            dv.rotation_angle_projections(r, device=d),
        "erase_and_ccstats": lambda d: dv.erase_and_ccstats(r, mask,
                                                            device=d),
        "serpentine": lambda d: dv.cc_stats_compact(_serpentine(),
                                                    device=d),
    }


def _as_np(x):
    if isinstance(x, tuple):
        return [_as_np(v) for v in x]
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("name", sorted(_device_op_cases()))
def test_device_ops_on_the_card_match_the_cpu(cuda, name):
    """Each ops/device.py function on the card (the CC kernels, torch ops)
    gives its CPU result (the CC kernels' plain versions) bit for bit."""
    fn = _device_op_cases()[name]
    got, want = _as_np(fn(cuda)), _as_np(fn(torch.device("cpu")))
    np.testing.assert_equal(got, want)
    if name == "serpentine":
        assert got[1] == 1


def _device_strips(page, params, despeckle_amt, cuda):
    from text_alignment_tpu_torch.pipeline.preprocess import raster_stream

    (_, angle, strips, peaks), = raster_stream(
        [page.image], backend="hybrid", despeckle_amt=despeckle_amt,
        params=params, device=cuda)
    return angle, [(s.offset_x, s.offset_y) + s.img.shape for s in strips], \
        peaks


def _host_strips(page, params, despeckle_amt):
    image, eroded, angle = golden_cases.preprocess_images(
        page.image, despeckle_amt=despeckle_amt, backend="hybrid",
        params=params)
    strips, peaks, _ = golden_cases.identify_text_lines(
        image, eroded, backend="hybrid", params=params)
    return angle, [(s.offset_x, s.offset_y) + s.img.shape for s in strips], \
        peaks


@pytest.mark.parametrize("case", ["skew_pos", "skew_neg", "touching",
                                  "noise", "empty"])
def test_raster_boundaries_on_the_card(cuda, case):
    """The boundary pages of tests/test_torch_golden.py through the raster
    on the card (``"hybrid"`` on a CUDA device): the angle at the +-6 deg
    search limit, one strip a line across ink bridges, the area-100 CC
    dropped and the area-102 CC kept, no line on a blank page; angles,
    peaks and strip boxes equal to the host engine's."""
    from text_alignment_tpu_torch.pipeline.preprocess import DESPECKLE_AMT
    from text_alignment_tpu_torch.synth import SynthPage

    despeckle, params = DESPECKLE_AMT, golden_cases.PARAMS
    if case.startswith("skew"):
        page, _, _ = golden_cases.fixture_skew(+1 if case == "skew_pos"
                                               else -1)
    elif case == "touching":
        page, _, _ = golden_cases.fixture_touching_lines()
    elif case == "noise":
        page = golden_cases.noise_boundary_page()
        despeckle, params = 20, golden_cases.NOISE_PARAMS
    else:
        page = SynthPage(image=np.full((400, 600, 3), 255, np.uint8),
                         transcript="")
    got = _device_strips(page, params, despeckle, cuda)
    want = _host_strips(page, params, despeckle)
    assert got[0] == want[0] and list(got[2]) == list(want[2])
    assert got[1] == want[1]
    if case.startswith("skew"):
        assert abs(got[0] - (5.9 if case == "skew_neg" else -5.9)) < 0.5
    else:
        assert len(got[1]) == {"touching": 3, "noise": 1, "empty": 0}[case]
    if case == "noise":
        x, _, _, w = got[1][0]
        assert x + w - 1 >= 780 and x >= 100


def test_sat_boundary_page_on_the_card(cuda):
    """The saturated-CC boundary page through the raster on the card: the
    same rotated page as the host engine's (whose 151-row bar is removed
    and 150-row bar kept, test_torch_golden)."""
    from text_alignment_tpu_torch.pipeline.preprocess import (
        preprocess_device_packed)

    page = golden_cases.sat_boundary_page()
    got, _, angle = preprocess_device_packed(page.image, device=cuda)
    image, _, want_angle = golden_cases.preprocess_images(page.image,
                                                          backend="hybrid")
    assert angle == want_angle
    np.testing.assert_array_equal(got, image)


def _card_mesh_rank(out_dir, world):
    """One rank of the card's mesh: the sharded OCR wire and the sharded
    grid of tests/test_torch_parallel.py's inputs, its backend, device and
    kernel launches; written to ``rank<r>.pkl``."""
    import pickle

    import torch.distributed as dist

    import test_torch_parallel as tp
    from text_alignment_tpu_torch.align.api import align_grid
    from text_alignment_tpu_torch.models.lineest_host import DEFAULT_PAD
    from text_alignment_tpu_torch.parallel import infer_dp, make_mesh

    with open(f"{out_dir}/inputs.pkl", "rb") as f:
        packed_meta, t_max = pickle.load(f)
    mesh = make_mesh(world)
    _kernels.reset_launches()
    wire = infer_dp.recognize_sharded_meta(
        tl.params_from_np(tp.peaky_params()), packed_meta, mesh, t_max=t_max,
        target_height=48, pad=DEFAULT_PAD, max_regions=tp.WIRE_REGIONS)
    grid = align_grid(list(tp.GRID_T), list(tp.GRID_O), tp.GRID_ROWS,
                      mesh=mesh)
    out = {"wire": wire, "grid": grid, "backend": dist.get_backend(),
           "device": str(torch.device("cuda", torch.cuda.current_device())),
           "shares": dict(infer_dp.LAST_WORK_SHARES),
           "launches": dict(_kernels.launches)}
    with open(f"{out_dir}/rank{dist.get_rank()}.pkl", "wb") as f:
        pickle.dump(out, f)


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")],
                         ids=["one-nccl-rank", "two-gloo-ranks"])
def test_mesh_on_the_card_matches_one_process(cuda, tmp_path, world,
                                              backend):
    """The sharded OCR wire and the sharded grid on the card, one NCCL
    rank or two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
    card), byte-identical to the one-process run, through the kernels."""
    import pickle

    import test_torch_parallel as tp
    from text_alignment_tpu_torch.align.api import align_grid
    from text_alignment_tpu_torch.models.lineest_host import DEFAULT_PAD
    from text_alignment_tpu_torch.models.recognizer import (
        _recognize_device_impl)
    from text_alignment_tpu_torch.parallel.multihost import launch

    _kernels.lib()  # built once here, loaded by the ranks
    packed_meta, t_max = tp.packed_batch(tp.strip_batch())
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump((packed_meta, t_max), f)
    launch(_card_mesh_rank, world, args=(str(tmp_path), world),
           device="cuda", store_dir=str(tmp_path), deadline_s=300)
    wire = _recognize_device_impl(
        tl.params_from_np(tp.peaky_params()).to(cuda),
        torch.from_numpy(packed_meta).to(cuda), t_max=t_max,
        target_height=48, pad=DEFAULT_PAD, max_regions=tp.WIRE_REGIONS)
    grid = align_grid(list(tp.GRID_T), list(tp.GRID_O), tp.GRID_ROWS,
                      device=cuda)
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out = pickle.load(f)
        assert out["backend"] == backend and out["device"] == "cuda:0"
        np.testing.assert_array_equal(out["wire"], wire)
        assert out["grid"] == grid
        assert len(out["shares"]) == world
        for name in ("lstm_scan", "lineest_tail", "nw_fill_batched",
                     "nw_traceback"):
            assert out["launches"][name] >= 1, (name, out["launches"])


def test_mesh_in_a_group_started_elsewhere_is_on_the_card(cuda, tmp_path):
    """A gloo group from a plain init_process_group (not init_rank): the
    mesh is a card mesh and the sharded grid runs through the kernels,
    equal to the one-process grid."""
    import os

    import torch.distributed as dist

    import test_torch_parallel as tp
    from text_alignment_tpu_torch.align.api import align_grid
    from text_alignment_tpu_torch.parallel import make_mesh

    want = align_grid(list(tp.GRID_T), list(tp.GRID_O), tp.GRID_ROWS,
                      device=cuda)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.device_type == "cuda"
        _kernels.reset_launches()
        assert align_grid(list(tp.GRID_T), list(tp.GRID_O), tp.GRID_ROWS,
                          mesh=mesh) == want
        assert _kernels.launches["nw_fill_batched"] >= 1
    finally:
        dist.destroy_process_group()
