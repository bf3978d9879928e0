"""The raster on the card (``ops/device.py``'s packed chain), which
``"hybrid"`` takes on a CUDA device for every caller, on the CPU: the
route rule of ``pipeline/preprocess``, the whole chain and its line finder
against the host oracle (skewed pages, the area filter, an empty page), a
run overflow raising, the rotate + erode + project step on the bit-packed
page (its plain version and a CPU model of the ``csrc/raster.cu``
kernel's banded word schedule) against the native engine, the line finder
on the packed eroded page, and ``process()`` through the card route's code
on CPU tensors against the native engine."""

import importlib

import numpy as np
import pytest
import torch

from text_alignment_tpu_torch.ops import cc, host_native, oracle
from text_alignment_tpu_torch.ops import device as dv
from text_alignment_tpu_torch.ops import fixedpoint as fxp
from text_alignment_tpu_torch.pipeline import to_JSON_dict
from text_alignment_tpu_torch.pipeline.assemble import to_processed_frame
from text_alignment_tpu_torch.pipeline.preprocess import (
    PackedPage, PreprocParams, identify_text_lines, preprocess_device_packed,
    preprocess_images)
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)

preprocess_mod = importlib.import_module(
    "text_alignment_tpu_torch.pipeline.preprocess")
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


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("backend", ["hybrid", "host", "device"])
def test_route_rule(backend, device):
    """hybrid on a CUDA device rasters on the card; on a CPU device it
    keeps the native engine; host and device are their own. The span of a
    folio on the card follows the same rule."""
    want = "device" if (backend, device) == ("hybrid", "cuda") else backend
    assert preprocess_mod.raster_backend(backend, torch.device(device)) \
        == want
    assert preprocess_mod.raster_backend(backend, device) == want
    assert preprocess_mod.rasters_on_card(backend, device) == (
        device == "cuda" and want == "device")


DAMT, SAT = 10, 60


def _grey(seed, skew=None):
    """A seeded page binarized, rotated by ``skew``, as a two-level grey
    image."""
    page = make_page(np.random.default_rng(seed), n_lines=4,
                     words_per_line=2)
    img = oracle.to_onebit(page.image)
    img = oracle.rotate_onebit(img, skew) if skew else img
    return np.where(img, 0, 255).astype(np.uint8)


def _oracle_chain(grey, by_area, sat):
    img = oracle.to_onebit(grey)
    img = oracle.despeckle(img, DAMT)
    img = ~oracle.despeckle(~img, DAMT)
    img = (oracle.remove_big_ccs if by_area else oracle.remove_tall_ccs)(
        img, sat)
    angle = oracle.rotation_angle_projections(img, -6, 6)
    rot = oracle.rotate_onebit(img, angle)
    er = oracle.filter_short_runs(rot, 2, "black")
    er = oracle.filter_narrow_runs(er, 2, "black")
    return rot, er, angle


@pytest.mark.parametrize("skew,by_area", [(None, False), (1.37, False),
                                          (-2.6, False), (None, True)])
def test_packed_chain_matches_oracle(skew, by_area):
    """preprocess_device_packed and the line finder on its packed page
    give the host oracle's rotated page, eroded page, projection, angle,
    strips and peaks (the cleanup chain with the row or the area filter,
    the skew search, rotate + erode + project, the masked CC table)."""
    grey = _grey(12, skew)
    sat = SAT * SAT if by_area else SAT  # an area keeps the glyphs
    params = PreprocParams(sat_area_thresh=sat, sat_filter_area=by_area,
                           filter_size=8)
    image, eroded, angle = preprocess_device_packed(grey, DAMT,
                                                    params=params, device=CPU)
    want_rot, want_er, want_angle = _oracle_chain(grey, by_area, sat)
    assert angle == want_angle
    np.testing.assert_array_equal(image, want_rot)
    np.testing.assert_array_equal(
        cc.unpack_page(eroded.words.numpy(), *eroded.shape), want_er)
    np.testing.assert_array_equal(eroded.proj,
                                  oracle.projection_rows(want_er))
    s, p, sm = identify_text_lines(image, eroded, backend="device",
                                   params=params, device=CPU)
    s_o, p_o, sm_o = identify_text_lines(want_rot, want_er, backend="host",
                                         params=params)
    assert p == p_o and len(p) >= 3
    np.testing.assert_array_equal(sm, sm_o)
    assert [(x.offset_x, x.offset_y, x.img.tobytes()) for x in s] == \
        [(x.offset_x, x.offset_y, x.img.tobytes()) for x in s_o]


def test_packed_chain_on_an_empty_page():
    image, eroded, angle = preprocess_device_packed(
        np.full((96, 160), 255, np.uint8), DAMT, device=CPU)
    assert not image.any() and not eroded.proj.any()
    strips, peaks, _ = identify_text_lines(image, eroded, backend="device",
                                           device=CPU)
    assert strips == [] and len(peaks) == 0


@pytest.mark.parametrize("kernel", ["cc_clean", "cc_table"])
def test_packed_chain_raises_on_a_run_overflow(kernel, monkeypatch):
    """The chain's capacity is the most runs a page can hold, so a kernel's
    ok of 0 is a fault: with the capacity of the cleanup chain or of the
    table lowered below the page's runs, the route raises; there is no
    host fallback."""
    orig = getattr(cc, kernel)

    def lowered(*args):
        return orig(*args[:-1], 64)

    monkeypatch.setattr(cc, kernel, lowered)
    grey = _grey(12)
    with pytest.raises(RuntimeError, match=kernel):
        image, eroded, _ = preprocess_device_packed(grey, DAMT, device=CPU)
        identify_text_lines(image, eroded, backend="device", device=CPU)


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
    eroded page's type at the line finder, the strips it gave)."""
    seen, strips = [], []
    finder = process_mod.identify_text_lines

    def lines(image, eroded, backend, **kw):
        seen.append(type(eroded).__name__)
        out = finder(image, eroded, backend=backend, **kw)
        strips.extend((s.offset_x, s.offset_y, s.img.tobytes())
                      for s in out[0])
        return out

    monkeypatch.setattr(process_mod, "identify_text_lines", lines)
    if route is not None:
        monkeypatch.setattr(preprocess_mod, "raster_backend", route)
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
    assert seen_n == ["ndarray"]
    js_c, seen_c, strips_c = _process(page, ocr, monkeypatch,
                                      route=lambda backend, device=None:
                                      "device")
    assert seen_c == ["PackedPage"]
    assert js_c == js_n and js_n["syl_boxes"]
    assert strips_c == strips_n and len(strips_n) == 5
