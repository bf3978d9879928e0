"""The port's device raster (``ops/raster_device.py``) against the JAX
package's (``ops/raster_device.py``, its CC kernel in interpret mode) and
the host oracle chain, as tests/test_raster_device.py holds the JAX one:
program A's rotated page, eroded page, projection, angle and exact canvas,
program B's separator-masked table and program C's strip wire are
identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_alignment_tpu.ops import oracle
from text_alignment_tpu.ops import raster_device as jax_rd
from text_alignment_tpu.synth import make_page
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch.ops import raster_device as rd

torch.set_num_threads(1)

DAMT, SAT = 10, 60


def _binarized(seed, skew=None):
    page = make_page(np.random.default_rng(seed), n_lines=4,
                     words_per_line=2)
    img = oracle.to_onebit(page.image)
    return oracle.rotate_onebit(img, skew) if skew else img


def _oracle_chain(img, by_area=False):
    img = oracle.despeckle(img, DAMT)
    img = ~oracle.despeckle(~img, DAMT)
    img = (oracle.remove_big_ccs if by_area else oracle.remove_tall_ccs)(
        img, SAT)
    angle = oracle.rotation_angle_projections(img, -6, 6)
    rot = oracle.rotate_onebit(img, angle)
    er = oracle.filter_short_runs(rot, 2, "black")
    er = oracle.filter_narrow_runs(er, 2, "black")
    return rot, er, oracle.projection_rows(er), angle


def _program_a(img, by_area=False):
    return rd.raster_page(img, DAMT, SAT, max_runs=1 << 15,
                          sat_by_area=by_area, device="cpu")


@pytest.mark.parametrize("skew,by_area", [(None, False), (1.37, False),
                                          (-2.6, False), (None, True)])
def test_program_a_matches_oracle(skew, by_area):
    img = _binarized(12, skew)
    bin_rot, eroded, proj, angle, ok, (H2, W2) = _program_a(img, by_area)
    assert ok
    want_rot, want_er, want_proj, want_angle = _oracle_chain(img, by_area)
    assert angle == want_angle
    assert (H2, W2) == want_rot.shape
    got_rot, got_er = bin_rot.numpy(), eroded.numpy()
    np.testing.assert_array_equal(got_rot[:H2, :W2], want_rot)
    np.testing.assert_array_equal(got_er[:H2, :W2], want_er)
    assert not got_rot[H2:].any() and not got_rot[:, W2:].any()
    np.testing.assert_array_equal(proj[:H2], want_proj)
    assert not proj[H2:].any()


def test_programs_match_jax_raster_device():
    """A, B and C on one page through both packages: every output equal."""
    img = _binarized(13, 1.37)
    got = _program_a(img)
    ref = jax_rd.raster_page(img, DAMT, SAT, max_runs=1 << 15)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    assert got[3:] == ref[3:]

    H2 = got[5][0]
    sep_rows = [H2 // 3, 2 * H2 // 3]
    table, ok = rd.masked_cc_table(got[1], sep_rows, H2, noise_thresh=4)
    table_j, ok_j = jax_rd.masked_cc_table(ref[1], sep_rows, H2,
                                           noise_thresh=4)
    assert ok and ok_j
    np.testing.assert_array_equal(table, table_j)
    cut = got[1].numpy()[:H2, :got[5][1]].copy()
    for r in sep_rows:
        cut[r: r + 2] = False
    _, want = oracle.cc_stats(cut)
    np.testing.assert_array_equal(table, want[want[:, 4] > 4])

    bb = np.array([[10, 5, 40, 200], [H2 - 30, 33, 30, 99], [0, 0, 0, 0]],
                  np.int32)
    page = rd.pack_page(got[0].numpy())
    np.testing.assert_array_equal(
        rd.extract_strips_packed(torch.from_numpy(page), bb, 64, 256).numpy(),
        np.asarray(jax_rd.extract_strips_packed(jnp.asarray(page), bb, 64,
                                                256)))


def test_program_c_matches_pack_strips():
    img = _binarized(14)
    page = _program_a(img)[0].numpy()
    H2max, W2max = page.shape
    rng = np.random.default_rng(3)
    bboxes, crops = [], []
    for _ in range(5):
        h = int(rng.integers(9, 70))
        w = int(rng.integers(17, 300))
        y = int(rng.integers(0, H2max - h))
        x = int(rng.integers(0, W2max - w))
        bboxes.append((y, x, h, w))
        crops.append(page[y: y + h, x: x + w])
    want_meta, _, _, Wp = SeqRecognizer._pack_strips(
        SeqRecognizer.__new__(SeqRecognizer), crops)
    B, Hp1, _ = want_meta.shape
    bb = np.zeros((B, 4), np.int32)
    bb[: len(bboxes)] = np.asarray(bboxes, np.int32)
    # the torch page packer and the host packer give the same words
    packed = rd.pack_bool(torch.from_numpy(page))
    np.testing.assert_array_equal(packed.numpy(), rd.pack_page(page))
    got = rd.extract_strips_packed(packed, bb, Hp1 - 1, Wp)
    np.testing.assert_array_equal(got.numpy(), want_meta)


def test_empty_page_ok():
    img = np.zeros((96, 160), bool)
    bin_rot, eroded, proj, angle, ok, _ = rd.raster_page(
        img, DAMT, SAT, max_runs=1 << 12, device="cpu")
    assert ok and not bin_rot.any() and not proj.any()


def test_program_a_run_overflow_clears_ok():
    img = _binarized(12)
    assert not rd.raster_page(img, DAMT, SAT, max_runs=64, device="cpu")[4]
