"""The port's own copies of the JAX package's host code against the
originals, on the same inputs: the raster and line segmentation (host and
hybrid), syllabification, the host NW fill and traceback, and .pyrnn
I/O."""

import numpy as np
import pytest

from text_alignment_tpu.align.nw_host import fill_host as jax_fill_host
from text_alignment_tpu.align.scoring import resolve_scoring as jax_scoring
from text_alignment_tpu.align.traceback import DensePtrView as JaxPtrView
from text_alignment_tpu.align.traceback import traceback as jax_traceback
from text_alignment_tpu.lang.syllabify import syllabify_text as jax_syl
from text_alignment_tpu.models.pyrnn import load_pyrnn as jax_load_pyrnn
from text_alignment_tpu.pipeline import preprocess as jax_pre
from text_alignment_tpu.synth import make_page
from text_alignment_tpu_torch.align.nw_host import fill_host
from text_alignment_tpu_torch.align.scoring import resolve_scoring
from text_alignment_tpu_torch.align.traceback import DensePtrView, traceback
from text_alignment_tpu_torch.lang.syllabify import syllabify_text
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lstm import init_params_np
from text_alignment_tpu_torch.models.pyrnn import load_pyrnn, save_pyrnn
from text_alignment_tpu_torch.pipeline import preprocess as pre


@pytest.mark.parametrize("backend", ["host", "hybrid"])
def test_raster_and_lines_match_jax(backend):
    page = make_page(np.random.default_rng(31), n_lines=3, words_per_line=2,
                     H=520, W=600, speckles=20)
    got = pre.preprocess_images(page.image, backend=backend)
    ref = jax_pre.preprocess_images(page.image, backend=backend)
    assert got[2] == ref[2]
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    strips, peaks, sm = pre.identify_text_lines(got[0], got[1],
                                                backend=backend)
    strips_j, peaks_j, sm_j = jax_pre.identify_text_lines(ref[0], ref[1],
                                                          backend=backend)
    assert peaks == peaks_j and len(strips) == len(strips_j) >= 2
    np.testing.assert_array_equal(sm, sm_j)
    for s, t in zip(strips, strips_j):
        assert (s.offset_x, s.offset_y) == (t.offset_x, t.offset_y)
        np.testing.assert_array_equal(s.img, t.img)


def test_syllabify_matches_jax():
    text = ("Alleluia confitemini domino quoniam bonus quoniam in "
            "seculum misericordia eius Gloria patri et filio")
    assert syllabify_text(text) == jax_syl(text)


@pytest.mark.parametrize("system", [None, [5, -7, -5, -5, 0, -3]])
def test_host_fill_and_traceback_match_jax(system):
    rng = np.random.default_rng(4)
    a = list("abcdefgh ")
    t = [a[k] for k in rng.integers(0, 9, 150)] + [" "]
    o = [a[k] for k in rng.integers(0, 9, 170)] + [" "]
    got = fill_host(t, o, resolve_scoring(system))
    ref = jax_fill_host(t, o, jax_scoring(system))
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)
    assert traceback(t, o, DensePtrView(*got)) == \
        jax_traceback(t, o, JaxPtrView(*ref))


def test_pyrnn_round_trip_reads_in_both_packages(tmp_path):
    d = init_params_np(np.random.default_rng(2), 48, 12, len(Codec()))
    path = str(tmp_path / "m.pyrnn.gz")
    save_pyrnn(path, d, Codec())
    got, codec, height = load_pyrnn(path)
    ref, codec_j, height_j = jax_load_pyrnn(path)
    assert codec.charset == codec_j.charset and height == height_j
    for direction in ("fwd", "bwd"):
        for k, v in d[direction].items():
            np.testing.assert_array_equal(got[direction][k], v)
            np.testing.assert_array_equal(ref[direction][k], v)
    np.testing.assert_array_equal(got["W2"], ref["W2"])
