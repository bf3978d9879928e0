"""The folio's raster on the card in ``process(backend="hybrid")``, on the
CPU: the route rule, the rotate + erode + project step on the bit-packed
page (its plain version and a CPU model of the ``csrc/raster.cu``
kernel's banded word schedule) against the native engine, the line finder
on the packed eroded page, and ``process()`` through the card route's code
on CPU tensors against the native engine."""

import importlib

import numpy as np
import pytest
import torch

from text_alignment_tpu_torch.ops import cc, host_native
from text_alignment_tpu_torch.ops import device as dv
from text_alignment_tpu_torch.ops import fixedpoint as fxp
from text_alignment_tpu_torch.pipeline import to_JSON_dict
from text_alignment_tpu_torch.pipeline.assemble import to_processed_frame
from text_alignment_tpu_torch.pipeline.preprocess import (
    PackedPage, PreprocParams, identify_text_lines, preprocess_device_packed,
    preprocess_images)
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)

process_mod = importlib.import_module(
    "text_alignment_tpu_torch.pipeline.process")
torch.set_num_threads(1)
CPU = torch.device("cpu")
SYNTH_PARAMS = PreprocParams(filter_size=8)
ANGLES = [0.0, 0.8, -0.8, 6.0, -6.0]
WIDTHS = [416, 405]  # a multiple of 32 and not


def _stage1(W, seed):
    """A seeded page's native stage 1: (img uint8 0/1, runs, n_runs)."""
    page = make_page(np.random.default_rng(seed), n_lines=4,
                     words_per_line=3, H=300, W=W)
    out = host_native.preprocess_page_phase1(page.image, 100, 150)
    assert out[0].shape == (300, W)
    return out


def _canvas(H, W, angle):
    if angle == 0.0:  # correct_rotation=False's identity map too
        return fxp.SCALE, 0, H, W
    return (*fxp.rotation_coeffs(angle), *fxp.rotated_canvas(H, W, angle))


def kernel_model(packed, H, W, cfix, sfix, H2, W2, band):
    """``csrc/raster.cu``'s schedule on the CPU, word for word: a band of
    ``band`` output rows rotates its rows and a halo row either side into
    packed words (a word is the 32 lanes' bits, as ``__ballot_sync`` packs
    them), erodes them vertically against the words above and below, then
    horizontally with the neighbouring words' carries, and counts each row
    with popcounts."""
    src = np.ascontiguousarray(packed).view(np.uint32)
    Wq2 = -(-W2 // 32)
    rot = np.zeros((H2, Wq2), np.uint32)
    ero = np.zeros((H2, Wq2), np.uint32)
    proj = np.zeros(H2, np.int64)
    S = 1 << fxp.SCALE_BITS
    bx, by = (W - 1) * S + S, (H - 1) * S + S
    x2 = (32 * np.arange(Wq2)[:, None] + np.arange(32)[None, :]).astype(
        np.int64)                                           # (Wq2, lanes)
    lane_bit = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for r0 in range(0, H2, band):
        nrows = min(band, H2 - r0)
        R = np.zeros((nrows + 2, Wq2), np.uint32)
        for i in range(nrows + 2):
            y2 = r0 - 1 + i
            dx2, dy2 = 2 * x2 - (W2 - 1), 2 * y2 - (H2 - 1)
            sx = (cfix * dx2 + sfix * dy2 + bx) >> (fxp.SCALE_BITS + 1)
            sy = (-sfix * dx2 + cfix * dy2 + by) >> (fxp.SCALE_BITS + 1)
            ok = ((0 <= y2 < H2) & (x2 < W2) & (sy >= 0) & (sy < H)
                  & (sx >= 0) & (sx < W))
            words = src[sy.clip(0, H - 1), sx.clip(0, W - 1) >> 5]
            bits = ((words >> (sx & 31).astype(np.uint32)) & 1).astype(bool)
            R[i] = np.where(ok & bits, lane_bit, 0).sum(
                axis=1, dtype=np.uint64).astype(np.uint32)
        c = R[1:-1]
        rot[r0:r0 + nrows] = c
        v = c & (R[:-2] | R[2:])
        zero = np.zeros((nrows, 1), np.uint32)
        left = np.hstack([zero, v[:, :-1]])
        right = np.hstack([v[:, 1:], zero])
        e = v & (((v << 1) | (left >> 31)) | ((v >> 1) | (right << 31)))
        ero[r0:r0 + nrows] = e
        proj[r0:r0 + nrows] = np.unpackbits(
            e.view(np.uint8), axis=1).sum(axis=1)
    return rot.view(np.int32), ero.view(np.int32), proj


def test_route_rule():
    """hybrid on a CUDA device rasters on the card; on a CPU device it
    keeps the native engine; host and device are their own."""
    cuda = torch.device("cuda")
    assert process_mod.raster_backend("hybrid", cuda) == "device"
    assert process_mod.raster_backend("hybrid", CPU) == "hybrid"
    for dev in (cuda, CPU):
        assert process_mod.raster_backend("host", dev) == "host"
        assert process_mod.raster_backend("device", dev) == "device"


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("angle", ANGLES)
def test_plain_rotate_erode_project_matches_native(angle, W):
    """The plain version on the packed stage-1 page gives the native
    phase 2's rotated and eroded pages and the native row projection."""
    img, runs, n_runs = _stage1(W, 7)
    H = img.shape[0]
    cfix, sfix, H2, W2 = _canvas(H, W, angle)
    rot, ero, proj = dv.rotate_erode_project_packed(
        torch.from_numpy(cc.pack_page(img.astype(bool))), H, W, cfix, sfix,
        H2, W2)
    bin_n, ero_n = host_native.preprocess_page_phase2(
        img, runs, n_runs, angle, 1, 2, angle != 0.0)
    np.testing.assert_array_equal(cc.unpack_page(rot.numpy(), H2, W2), bin_n)
    np.testing.assert_array_equal(cc.unpack_page(ero.numpy(), H2, W2), ero_n)
    np.testing.assert_array_equal(proj.numpy(),
                                  host_native.projection_rows(ero_n))


@pytest.mark.parametrize("band", [1, 3, 16])
@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("angle", [0.8, -6.0])
def test_kernel_model_matches_plain(angle, W, band):
    """The kernel's banded word schedule gives the plain version's bits,
    whatever rows a band holds (the halos at every band edge)."""
    img, _, _ = _stage1(W, 8)
    H = img.shape[0]
    cfix, sfix, H2, W2 = _canvas(H, W, angle)
    packed = cc.pack_page(img.astype(bool))
    want = dv.rotate_erode_project_reference(
        torch.from_numpy(packed), H, W, cfix, sfix, H2, W2)
    got = kernel_model(packed, H, W, cfix, sfix, H2, W2, band)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("seed", [3, 4])
def test_packed_line_finder_matches_native(seed):
    """The line finder on the eroded page left packed on the device (its
    projection from the raster step, the separator rows cleared on the
    words) gives the native engine's strips, peaks and smoothed
    projection."""
    page = make_page(np.random.default_rng(seed), n_lines=5,
                     words_per_line=3, angle=0.6)
    image, eroded, angle = preprocess_device_packed(
        page.image, params=SYNTH_PARAMS, device=CPU)
    assert isinstance(eroded, PackedPage)
    assert eroded.shape == image.shape
    image_n, eroded_n, angle_n = preprocess_images(
        page.image, backend="hybrid", params=SYNTH_PARAMS)
    assert angle == angle_n
    np.testing.assert_array_equal(image, image_n)
    np.testing.assert_array_equal(
        cc.unpack_page(eroded.words.numpy(), *eroded.shape), eroded_n)
    s, p, sm = identify_text_lines(image, eroded, backend="device",
                                   params=SYNTH_PARAMS, device=CPU)
    s_n, p_n, sm_n = identify_text_lines(image_n, eroded_n, backend="hybrid",
                                         params=SYNTH_PARAMS)
    assert p == p_n and len(p) == 5
    np.testing.assert_array_equal(sm, sm_n)
    assert [(x.offset_x, x.offset_y, x.img.tobytes()) for x in s] == \
        [(x.offset_x, x.offset_y, x.img.tobytes()) for x in s_n]


def _process(page, ocr, monkeypatch, route=None):
    """process(backend="hybrid") on the CPU with injected OCR: (JSON, the
    raster backends it took, the strips the line finder gave)."""
    seen, strips = [], []
    finder = process_mod.identify_text_lines

    def lines(image, eroded, backend, **kw):
        seen.append(backend)
        out = finder(image, eroded, backend=backend, **kw)
        strips.extend((s.offset_x, s.offset_y, s.img.tobytes())
                      for s in out[0])
        return out

    monkeypatch.setattr(process_mod, "identify_text_lines", lines)
    if route is not None:
        monkeypatch.setattr(process_mod, "raster_backend", route)
    out = process_mod.process(page.image, page.transcript, existing_ocr=ocr,
                              verbose=False, backend="hybrid", device=CPU,
                              preproc_params=SYNTH_PARAMS)
    monkeypatch.undo()
    return to_JSON_dict(out[0], out[2]), seen, strips


def test_process_card_route_matches_native_on_cpu(monkeypatch):
    """process(backend="hybrid") through the card route's code (the route
    forced onto CPU tensors) gives the native engine's strips and JSON; on
    a CPU device the route itself keeps the native engine."""
    page = make_page(np.random.default_rng(12), n_lines=5, words_per_line=3,
                     angle=-0.7)
    image, _, angle = preprocess_images(page.image, backend="hybrid",
                                        params=SYNTH_PARAMS)
    ocr = [to_processed_frame(cb, angle, image.shape, page.image.shape)
           for cb in ocr_with_spaces(corrupt_ocr(np.random.default_rng(13),
                                                 page.char_boxes))]
    js_n, seen_n, strips_n = _process(page, ocr, monkeypatch)
    assert seen_n == ["hybrid"]
    js_c, seen_c, strips_c = _process(page, ocr, monkeypatch,
                                      route=lambda backend, device: "device")
    assert seen_c == ["device"]
    assert js_c == js_n and js_n["syl_boxes"]
    assert strips_c == strips_n and len(strips_n) == 5
