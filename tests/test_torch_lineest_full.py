"""The port's full-chain normalizer (``lineest_kernel.center_full`` and the
``TEXT_ALIGNMENT_TPU_TAIL=full`` route of ``lineest.normalize_batch_device``)
against the JAX package.

- The plain version against the JAX ``lineest_pallas.center_from_temp`` in
  interpret mode, on tests/test_lineest_pallas.py's case and on a narrow
  strip height. Bar: ink counts exact, center within one row on every
  valid column, dsum within the JAX test's bound: the JAX kernel smooths
  the argmax row in float32, the port in scipy's float64 arithmetic.
- Against the port's default route (``center_inputs`` + ``tail``), which
  sums the h-gauss in another order. Same bar.
- The recognizer on real strips with the full route against the default,
  under the reference's own gate (tests/test_tpu_hw.py:338-344): decoded
  counts and classes identical on every strip, >= 95% of wires
  byte-identical.
"""

import numpy as np
import pytest
import torch

from test_lineest_pallas import _build_case
from text_alignment_tpu.models import lineest_pallas as lp
from text_alignment_tpu_torch import _kernels
from text_alignment_tpu_torch.models import lineest as tle
from text_alignment_tpu_torch.models import lstm as tl
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lineest_kernel import (
    center_full, center_full_reference, tail)
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch.pipeline.preprocess import (
    identify_text_lines, preprocess_images)
from text_alignment_tpu_torch.synth import make_page

torch.set_num_threads(1)


def _narrow_case(B=5, Hp=32, Wp=256, seed=4):
    rng = np.random.default_rng(seed)
    temp = (rng.random((B, Hp, Wp)) < 0.12).astype(np.uint8)
    hs = rng.integers(Hp // 2, Hp + 1, B).astype(np.int32)
    ws = rng.integers(Wp - 255, Wp + 1, B).astype(np.int32)
    valid = ((np.arange(Hp)[None, :, None] < hs[:, None, None])
             & (np.arange(Wp)[None, None, :] < ws[:, None, None]))
    return temp * valid.astype(np.uint8), hs, ws


def _case(kind):
    if kind == "wide":
        _, tj, hs, ws, _ = _build_case(6, 96, 768)
        return np.array(tj, np.uint8), hs, ws
    return _narrow_case()


def _inputs(temp, hs, ws):
    Hp = temp.shape[1]
    hs_t = torch.from_numpy(np.asarray(hs, np.int32))
    ws_t = torch.from_numpy(np.asarray(ws, np.int32))
    return (torch.from_numpy(temp), tle.vgauss_bank(hs_t, Hp),
            tle.hgauss_taps(hs_t, Hp), hs_t, ws_t,
            torch.from_numpy(tle.smoothing_taps(hs, Hp)))


def _assert_close(got, ref, ws):
    cg, dsg, dcg = (np.asarray(a) for a in got)
    cr, dsr, dcr = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(dcg, dcr)
    for b, w in enumerate(ws):
        d = np.abs(cg[b, :w].astype(np.int64) - cr[b, :w])
        assert d.max() <= 1, (b, d.max())
    assert np.abs(dsg.astype(np.int64) - dsr).max() <= int(dcr.max())


@pytest.mark.parametrize("kind", ["wide", "narrow"])
def test_center_full_matches_pallas_interpret(kind):
    temp, hs, ws = _case(kind)
    args = _inputs(temp, hs, ws)
    ref = lp.center_from_temp(temp, args[1].numpy(), args[2].numpy(), hs, ws,
                              interpret=True)
    before = _kernels.launches["lineest_full"]
    got = center_full(*args)
    assert _kernels.launches["lineest_full"] == before  # CPU: plain version
    _assert_close(got, ref, ws)


@pytest.mark.parametrize("kind", ["wide", "narrow"])
def test_center_full_matches_default_route(kind):
    temp, hs, ws = _case(kind)
    hs_t = torch.from_numpy(np.asarray(hs, np.int32))
    ws_t = torch.from_numpy(np.asarray(ws, np.int32))
    grey = torch.from_numpy(1 - temp)
    _, _, _, sm, temp_d, k2 = tle.center_inputs(grey, hs_t, ws_t, onebit=True)
    ref = tail(sm, temp_d, hs_t, ws_t, k2)
    got = center_full_reference(temp_d, tle.vgauss_bank(hs_t, temp.shape[1]),
                                tle.hgauss_taps(hs_t, temp.shape[1]), hs_t,
                                ws_t, k2)
    _assert_close(got, ref, ws)


def test_plain_sums_follow_the_kernels_order():
    """The v-gauss and h-gauss plain versions equal a scalar loop in the
    kernel's order (j ascending, then t ascending, each product and sum
    rounded in float32) on a few columns."""
    temp, hs, ws = _narrow_case(B=2, Hp=32, Wp=256, seed=9)
    args = _inputs(temp, hs, ws)
    from text_alignment_tpu_torch.models.lineest_kernel import (
        hgauss_reference, vgauss_reference)

    sm1 = vgauss_reference(args[0], args[1])
    sm = hgauss_reference(sm1, args[2])
    w0, k1 = args[1].numpy(), args[2].numpy()
    f = np.float32
    r = k1.shape[1] // 2
    for b, i, p in ((0, 3, 0), (1, 17, 100), (1, 31, 255)):
        col = np.asarray(temp[b, :, p])
        acc = f(0)
        for j in range(temp.shape[1]):
            acc = f(acc + f(w0[b, i, j] * f(col[j] != 0)))
        assert acc == sm1[b, i, p].item()
        row = sm1[b, i].numpy()
        acc = f(0)
        for t in range(k1.shape[1]):
            q = p - r + t
            x = row[q] if 0 <= q < row.size else f(0)
            acc = f(acc + f(x * k1[b, t]))
        assert acc == sm[b, i, p].item()


def _peaky(seed, nout):
    """Random weights with peaky posteriors and a tame recurrence (the
    weights chip_smoke.py's phase 15 uses)."""
    rng = np.random.default_rng(seed)
    d = tl.init_params_np(rng, 48, 100, nout, initial_range=0.3)
    for direction in ("fwd", "bwd"):
        for k in ("WGI", "WGF", "WGO", "WCI"):
            d[direction][k][:, 1:49] *= 2.0 / 0.3
    d["W2"] = rng.uniform(-2, 2, d["W2"].shape).astype(np.float32)
    d["W2"][0, 0] += 9.0
    return d


def test_recognizer_full_route_passes_the_reference_gate(monkeypatch):
    strips = []
    for seed in (30, 31):
        page = make_page(np.random.default_rng(seed), n_lines=4,
                         words_per_line=2, H=800, W=700, char_h=50,
                         char_w=30, gap=6, space_w=40, line_spacing=150,
                         speckles=30, margin_x=30, angle=0.4)
        image, eroded, _ = preprocess_images(page.image, backend="hybrid")
        ls, _, _ = identify_text_lines(image, eroded, backend="hybrid",
                                       verbose=False)
        strips.extend(np.asarray(s.img) for s in ls)
    assert len(strips) >= 6
    codec = Codec()
    rec = SeqRecognizer(tl.params_from_np(_peaky(0, len(codec))), codec,
                        normalize_on_device=True, device="cpu")
    packed_meta, _, ws, Wp = rec._pack_strips(strips)
    t_max = rec._initial_t_max(Wp, ws[:len(strips)])
    rows = {}
    for mode in ("default", "full"):
        if mode == "full":
            monkeypatch.setenv("TEXT_ALIGNMENT_TPU_TAIL", "full")
        else:
            monkeypatch.delenv("TEXT_ALIGNMENT_TPU_TAIL", raising=False)
        rows[mode] = rec._dispatch_device(packed_meta, t_max, 128)
    wa, wb = rows["default"], rows["full"]
    n_same = 0
    for b in range(len(strips)):
        ca, cb = wa[b, 0], wb[b, 0]
        assert ca == cb, (b, ca, cb)
        R = (wa.shape[1] - 3) // 2
        assert np.array_equal(wa[b, 3 + R:3 + R + ca],
                              wb[b, 3 + R:3 + R + cb]), b
        if np.array_equal(wa[b], wb[b]):
            n_same += 1
    assert int(wa[:len(strips), 0].sum()) > 0  # the weights decode something
    assert n_same >= 0.95 * len(strips), (n_same, len(strips))


def _vh_inside(temp, w0, k1, hs, ws):
    """The fused pass of csrc/lineest_full.cu on the CPU: for each strip
    only rows i < h and columns p < w, the v-gauss over rows j < h alone and
    the h-gauss over the taps that reach columns [0, w) among the strip's
    nonzero taps, each output skipping (not adding) the rest; NaN outside
    (h, w), where the kernel leaves rows unwritten."""
    B, Hp, Wp = temp.shape
    r = k1.shape[1] // 2
    sm = torch.full((B, Hp, Wp), float("nan"))
    for b in range(B):
        h, w = int(hs[b]), int(ws[b])
        if h == 0 or w == 0:
            continue
        ink = (temp[b, :h, :w] != 0).to(torch.float32)
        sm1 = torch.zeros((h, w))
        for j in range(h):
            sm1 = sm1 + w0[b, :h, j:j + 1] * ink[j:j + 1, :]
        nz = torch.nonzero(k1[b] != 0).flatten()
        lo, hi = int(nz.min()), int(nz.max())
        xp = torch.nn.functional.pad(sm1, (r, r))
        p = torch.arange(w)
        acc = torch.zeros((h, w))
        for t in range(lo, hi + 1):
            reach = (t >= r - p) & (t <= r - p + w - 1)
            acc = torch.where(reach, acc + xp[:, t:t + w] * k1[b, t], acc)
        sm[b, :h, :w] = acc
    return sm


@pytest.mark.parametrize("seed", [30, 34])
def test_full_kernel_skips_only_exact_zeros_and_unread_cells(seed):
    """On the padded batch the recognizer builds from a page's strips: the
    ink mask is zero outside each strip's (h, w); the sums the full kernel
    skips (rows j >= h, taps that reach no column below w) are exact zeros,
    so its sm equals the plain version's inside (h, w) bit for bit; and the
    tail never reads sm outside (h, w): center, dsum and dcnt are the same
    with NaN or huge values there."""
    from text_alignment_tpu_torch.models.lineest_kernel import (
        hgauss_reference, tail_reference, vgauss_reference)
    from text_alignment_tpu_torch.models.recognizer import _unpack_bits

    page = make_page(np.random.default_rng(seed), n_lines=4,
                     words_per_line=2, H=800, W=700, char_h=50, char_w=30,
                     gap=6, space_w=40, line_spacing=150, speckles=30,
                     margin_x=30, angle=0.4)
    image, eroded, _ = preprocess_images(page.image, backend="hybrid")
    ls, _, _ = identify_text_lines(image, eroded, backend="hybrid",
                                   verbose=False)
    codec = Codec()
    rec = SeqRecognizer(tl.params_from_np(_peaky(0, len(codec))), codec,
                        normalize_on_device=True, device="cpu")
    packed_meta = rec._pack_strips([np.asarray(s.img) for s in ls])[0]
    grey, hs, ws = _unpack_bits(torch.from_numpy(packed_meta))
    B, Hp, Wp = grey.shape
    temp = (tle._front(grey, hs, ws, True)[3] != 0).to(torch.uint8)
    w0, k1 = tle.vgauss_bank(hs, Hp), tle.hgauss_taps(hs, Hp)
    k2 = torch.from_numpy(tle.smoothing_taps(hs.numpy(), Hp))
    inside = ((torch.arange(Hp)[None, :, None] < hs[:, None, None])
              & (torch.arange(Wp)[None, None, :] < ws[:, None, None]))
    assert (hs < Hp).any() and (ws < Wp).any() and temp.any()
    assert not temp[~inside].any()

    sm = hgauss_reference(vgauss_reference(temp, w0), k1)
    fused = _vh_inside(temp, w0, k1, hs, ws)
    assert torch.equal(fused[inside], sm[inside])
    assert sm[~inside].abs().max() > 0  # the skipped cells are not zeros

    want = tail_reference(sm, temp, hs, ws, k2)
    rng = np.random.default_rng(seed)
    for fill in (fused, torch.where(inside, sm, torch.from_numpy(
            rng.uniform(-1e6, 1e6, sm.shape).astype(np.float32)))):
        got = tail_reference(fill, temp, hs, ws, k2)
        for g, r in zip(got, want):
            assert torch.equal(g, r)
