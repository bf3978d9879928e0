"""The port's own copies of the JAX package's host code against the
originals, on the same inputs: the raster and line segmentation (host and
hybrid), syllabification, the host NW fill and traceback, .pyrnn I/O,
the stage cache's keys and store, and the MEI merge."""

import xml.etree.ElementTree as ET

import numpy as np
import pytest

from test_aux import _mini_mei
from text_alignment_tpu import mei as jax_mei
from text_alignment_tpu.utils import cache as jax_cache
from text_alignment_tpu_torch import mei
from text_alignment_tpu_torch.utils import cache

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


def test_stage_cache_keys_and_store_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    parts = ("ocr", rng.random((7, 9)).astype(np.float32),
             np.arange(12, dtype=np.int16).reshape(3, 4), b"\x00\x01",
             repr((1, "a")), None, 3.5)
    assert cache.content_key(*parts) == jax_cache.content_key(*parts)
    assert cache.content_key(*parts[:-1]) != cache.content_key(*parts)
    value = ({"a": np.arange(3)}, [1, 2])
    ours = cache.StageCache(str(tmp_path / "ours"))
    theirs = jax_cache.StageCache(str(tmp_path / "theirs"))
    for store in (ours, theirs):
        assert store.get("ocr", "k") is None
        calls = []
        got = store.cached("ocr", "k", lambda: calls.append(1) or value)
        again = store.cached("ocr", "k", lambda: calls.append(1) or value)
        assert calls == [1]
        np.testing.assert_array_equal(got[0]["a"], again[0]["a"])
    assert (sorted(p.name for p in (tmp_path / "ours").iterdir())
            == sorted(p.name for p in (tmp_path / "theirs").iterdir()))


@pytest.mark.parametrize("boxes", [
    [("al", (10, 50), (40, 70)), ("le", (60, 50), (90, 70)),
     ("lu", (110, 50), (140, 70))],
    [("al", (10, 50), (140, 70))]])
def test_mei_merge_matches_jax(boxes):
    outs = []
    for module in (mei, jax_mei):
        np.random.seed(7)  # the new zones' ids come from np.random
        tree, bboxes, lines = module.add_text_to_mei_file(_mini_mei(), boxes,
                                                          40)
        outs.append((ET.tostring(tree.getroot()), bboxes, lines))
    assert outs[0] == outs[1]
    raw = '<mei meiversion="4.0.0"></mei>'
    assert mei.repair_xml(raw) == jax_mei.repair_xml(raw)
    assert (mei.intersect((0, 0), (10, 10), (5, 5), (15, 15))
            == jax_mei.intersect((0, 0), (10, 10), (5, 5), (15, 15)))
