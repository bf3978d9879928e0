"""The port's copy of ``training_data`` (the training cleaner) against the
JAX package's: tests/test_aux.py's two cleaner cases on the copy, and the
cleaned pages, angles and unioned strips equal to the original's on the
same pages, host and hybrid engines."""

import numpy as np
import pytest

from text_alignment_tpu import training_data as jax_td
from text_alignment_tpu.pipeline.preprocess import \
    PreprocParams as JaxPreprocParams
from text_alignment_tpu_torch.ops import host_native
from text_alignment_tpu_torch.pipeline.preprocess import PreprocParams
from text_alignment_tpu_torch.synth import make_page
from text_alignment_tpu_torch.training_data import (clean_image,
                                                    union_line_strips)

SYNTH_PARAMS = PreprocParams(filter_size=8)


def test_training_data_cleaner():
    page = make_page(np.random.default_rng(2), n_lines=4, words_per_line=2)
    cleaned, _ = clean_image(page.image)
    assert cleaned.dtype == bool
    assert cleaned.any()

    unioned, strips = union_line_strips(page.image,
                                        preproc_params=SYNTH_PARAMS)
    assert len(strips) == 4
    assert unioned.any()
    # the unioned page only holds ink inside strip bboxes
    mask = np.zeros_like(unioned)
    for s in strips:
        h, w = s.img.shape
        mask[s.offset_y: s.offset_y + h, s.offset_x: s.offset_x + w] = True
    assert not (unioned & ~mask).any()


def test_training_data_cleaner_backend_parity():
    """clean_image(backend="hybrid") runs the native engine and stays
    bit-identical to the host oracle."""
    if not host_native.available():
        pytest.skip("native toolchain unavailable")
    page = make_page(np.random.default_rng(7), n_lines=3, words_per_line=2)
    host_img, host_angle = clean_image(page.image, backend="host")
    hyb_img, hyb_angle = clean_image(page.image, backend="hybrid")
    assert host_angle == hyb_angle
    assert np.array_equal(host_img, hyb_img)


@pytest.mark.parametrize("backend", ["host", "hybrid"])
def test_training_data_matches_jax(backend):
    page = make_page(np.random.default_rng(2), n_lines=4, words_per_line=2,
                     angle=1.5)
    img, angle = clean_image(page.image, backend=backend)
    img_j, angle_j = jax_td.clean_image(page.image, backend=backend)
    assert angle == angle_j
    np.testing.assert_array_equal(img, img_j)

    unioned, strips = union_line_strips(page.image, backend=backend,
                                        preproc_params=SYNTH_PARAMS)
    unioned_j, strips_j = jax_td.union_line_strips(
        page.image, backend=backend,
        preproc_params=JaxPreprocParams(filter_size=8))
    np.testing.assert_array_equal(unioned, unioned_j)
    assert len(strips) == len(strips_j) == 4
    for s, t in zip(strips, strips_j):
        assert (s.offset_x, s.offset_y) == (t.offset_x, t.offset_y)
        np.testing.assert_array_equal(s.img, t.img)
