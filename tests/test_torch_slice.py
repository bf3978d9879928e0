"""The slice as a whole: the port's SeqRecognizer and process() against the
JAX package's, on the same weights and the same synthetic page.

The decode wire is the reference's parity surface. Fed the same frames,
the port's BiLSTM, decode and wire packing give the JAX package's wire
exactly. Through the normalizers, a strip's center can truncate the other
way on a plateau of equal argmax rows (the knife edge docs/DESIGN.md
documents): the port smooths the argmax row with scipy's float64
arithmetic and the JAX package's device normalizer in float32, so the two
device paths agree on lengths and t_raw while the frames of a few columns
shift by a row, which can move a region; the port's device path decodes
exactly as the scipy normalizer does. process() is held to an equal
to_JSON_dict through the host normalizer, which both packages share, and
with injected OCR. The weights are peaky but
not saturated (input weights in +-2, W2 in +-1, a blank bias), so that no
argmax is decided by a float tie and lines decode to several regions.
"""

import numpy as np
import pytest
import torch

from text_alignment_tpu.models.codec import Codec
from text_alignment_tpu.models import lineest_jax
from text_alignment_tpu.models.lstm_jax import params_from_np as jax_params
from text_alignment_tpu.models.recognizer import SeqRecognizer as JaxRec
from text_alignment_tpu.pipeline.process import process as jax_process
from text_alignment_tpu.pipeline.process import to_JSON_dict as jax_json
from text_alignment_tpu.synth import make_page
from text_alignment_tpu_torch.models.codec import Codec as TCodec
from text_alignment_tpu_torch.models.lstm import init_params_np, params_from_np
from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch.pipeline import process, to_JSON_dict
from text_alignment_tpu_torch.pipeline.preprocess import (
    identify_text_lines, preprocess_images)

torch.set_num_threads(1)


def peaky_params(seed=0, ni=48, ns=100, nout=29):
    """Input weights in +-2 (the ink drives the gates), recurrent weights
    in +-0.3 (larger ones make the recurrence chaotic, so float roundoff
    grows without bound along a line), W2 in +-1 (wider saturates the
    softmax into exact ties at 1.0) and a blank bias of 2."""
    rng = np.random.default_rng(seed)
    d = init_params_np(rng, ni, ns, nout, initial_range=0.3)
    for direction in ("fwd", "bwd"):
        for k in ("WGI", "WGF", "WGO", "WCI"):
            d[direction][k][:, 1:1 + ni] *= 2.0 / 0.3
    d["W2"] = rng.uniform(-1, 1, d["W2"].shape).astype(np.float32)
    d["W2"][0, 0] += 2.0
    return d


@pytest.fixture(scope="module")
def case():
    page = make_page(np.random.default_rng(42), n_lines=4, words_per_line=2,
                     H=800, W=700, char_h=50, char_w=30, gap=6, space_w=40,
                     line_spacing=150, speckles=30, margin_x=30)
    image, eroded, _ = preprocess_images(page.image, backend="hybrid")
    strips, _, _ = identify_text_lines(image, eroded, backend="hybrid")
    assert len(strips) >= 3
    d = peaky_params()
    rec_j = JaxRec(jax_params(d), Codec(), normalize_on_device=True)
    rec_t = SeqRecognizer(params_from_np(d), TCodec(),
                          normalize_on_device=True, device="cpu")
    return page, [s.img for s in strips], rec_j, rec_t


def _wires(rec_j, rec_t, inks):
    packed_meta, _, ws, Wp = rec_t._pack_strips(inks)
    t_max = rec_t._initial_t_max(Wp, ws[:len(inks)])
    return (rec_t._dispatch_device(packed_meta, t_max, max_regions=128),
            rec_j._dispatch_device(packed_meta, t_max, max_regions=128))


@pytest.fixture
def jax_frames(monkeypatch):
    """Feed the port's recognizer the JAX normalizer's frames."""
    from text_alignment_tpu_torch.models import recognizer

    def frames(grey, hs, ws, **kw):
        out = lineest_jax.normalize_batch_device(
            grey.numpy(), hs.numpy(), ws.numpy(), **kw)
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(recognizer, "normalize_batch_device", frames)


def test_decode_wire_matches_jax_on_equal_frames(case, jax_frames):
    """Unpack, BiLSTM, CTC decode and wire packing, fed the JAX
    normalizer's frames: the wire is identical row for row."""
    _, inks, rec_j, rec_t = case
    wire_t, wire_j = _wires(rec_j, rec_t, inks)
    np.testing.assert_array_equal(wire_t, wire_j)
    assert wire_t[:len(inks), 0].sum() > len(inks)  # several regions


def test_recognized_rows_match_jax_on_equal_frames(case, jax_frames):
    _, inks, rec_j, rec_t = case
    rows_t = rec_t.recognize_batch(inks)
    assert rows_t == rec_j.recognize_batch(inks)
    assert sum(len(r) for r in rows_t) > len(inks)


def test_decode_wire_matches_jax(case):
    """The whole device path, the port's normalizer included: every
    strip's length and t_raw are exact, and every line decodes."""
    _, inks, rec_j, rec_t = case
    n = len(inks)
    wire_t, wire_j = _wires(rec_j, rec_t, inks)
    np.testing.assert_array_equal(wire_t[:, 1:3], wire_j[:, 1:3])
    assert (wire_t[:n, 0] > 0).all()


def test_device_path_decodes_as_scipy_normalizer(case):
    """The port's device normalizer (here its plain versions) against the
    JAX package's scipy normalizer, the ocrolib canon: every line decodes
    to the same characters at the same positions."""
    _, inks, _, rec_t = case
    rows_j = JaxRec(jax_params(peaky_params()), Codec()).recognize_batch(inks)
    rows_t = rec_t.recognize_batch(inks)
    assert rows_t == rows_j
    assert sum(len(r) for r in rows_t) > len(inks)


def test_host_normalizer_branch_matches_jax(case):
    _, inks, _, _ = case
    d = peaky_params()
    rows_j = JaxRec(jax_params(d), Codec()).recognize_batch(inks)
    rows_t = SeqRecognizer(params_from_np(d), TCodec(),
                           device="cpu").recognize_batch(inks)
    assert rows_t == rows_j


def test_process_json_matches_jax(case):
    """Recognizer objects on the host normalizer, which both packages
    share: the whole OCR stage and everything after it agree exactly."""
    page = case[0]
    d = peaky_params()
    out_j = jax_process(page.image, page.transcript,
                        ocropus_model=JaxRec(jax_params(d), Codec()),
                        backend="hybrid", verbose=False)
    out_t = process(page.image, page.transcript,
                    ocropus_model=SeqRecognizer(params_from_np(d),
                                                TCodec(), device="cpu"),
                    backend="hybrid", verbose=False, device="cpu")
    assert out_j is not None and out_t is not None
    assert to_JSON_dict(out_t[0], out_t[2]) == jax_json(out_j[0], out_j[2])


def test_process_injected_ocr_matches_jax(case):
    """The host stages around the OCR (NW on the host, assembly) with the
    page's ground-truth char stream injected: a non-empty JSON."""
    from text_alignment_tpu.synth import ocr_with_spaces

    page = case[0]
    chars = ocr_with_spaces(page.char_boxes)
    out_j = jax_process(page.image, page.transcript, existing_ocr=chars,
                        backend="hybrid", verbose=False)
    out_t = process(page.image, page.transcript, existing_ocr=chars,
                    backend="hybrid", verbose=False, device="cpu")
    js_t = to_JSON_dict(out_t[0], out_t[2])
    assert js_t == jax_json(out_j[0], out_j[2])
    assert len(js_t["syl_boxes"]) >= 4


def test_process_from_pyrnn_path(case, tmp_path):
    """A .pyrnn.gz path resolves to the port's recognizer on the device
    asked for; on the CPU the reference's scipy normalizer runs, as the
    JAX package does on a CPU-only runtime."""
    page, _, _, _ = case
    d = peaky_params()
    path = str(tmp_path / "m.pyrnn.gz")
    save_pyrnn(path, d, TCodec())
    out_t = process(page.image, page.transcript, ocropus_model=path,
                    backend="hybrid", verbose=False, device="cpu")
    out_j = jax_process(page.image, page.transcript, ocropus_model=path,
                        backend="hybrid", verbose=False)
    assert to_JSON_dict(out_t[0], out_t[2]) == jax_json(out_j[0], out_j[2])


def test_unknown_backend_raises(case):
    page = case[0]
    with pytest.raises(ValueError, match="unknown backend 'xla'"):
        process(page.image, page.transcript, existing_ocr=[],
                backend="xla", device="cpu")
