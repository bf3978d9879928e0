"""The port's batched pipeline (``parallel/batch.process_batch``) against
the JAX package's, on tests/test_device_raster_pipeline.py's six 500 x 460
pages, with the same weights carried across (``params_from_jax``): the JSON
dumps (sort_keys) and the all_chars streams are byte-identical, with the
raster on the device (``backend="device"``, ``ops/device.py`` with the CC
kernels' plain versions here) and on the native host engine
(``"hybrid"`` on the CPU, pipelined or on a thread pool), and with
injected OCR. The batched CLI writes the sequential CLI's files.

The port's device normalizer smooths its argmax row in float64 (scipy's
arithmetic) and the JAX package's in float32, so their centers can differ
by a row on a plateau (the knife edge of docs/DESIGN.md, see
tests/test_torch_slice.py); here the port's recognizer is fed the JAX
normalizer's frames, so that the OCR is the same and everything around it
is compared exactly. Without a card, the entry points refuse to run
unless the CPU is named."""

import csv
import json

import numpy as np
import pytest
import torch
from PIL import Image

from text_alignment_tpu.models.codec import Codec
from text_alignment_tpu.models import lineest_jax
from text_alignment_tpu.models.lstm_jax import params_from_np as jax_params
from text_alignment_tpu.models.lstm_jax import params_to_np
from text_alignment_tpu.models.recognizer import SeqRecognizer as JaxRec
from text_alignment_tpu.parallel.batch import process_batch as jax_batch
from text_alignment_tpu.synth import corrupt_ocr, make_page, ocr_with_spaces
from text_alignment_tpu_torch.models import recognizer
from text_alignment_tpu_torch.models.lstm import init_params_np
from text_alignment_tpu_torch.models.lstm import params_from_jax
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch.parallel import process_batch

torch.set_num_threads(1)


def _pages(n=6):
    return [
        make_page(np.random.default_rng(70 + i), n_lines=2, words_per_line=2,
                  H=500, W=460, char_h=40, char_w=26, gap=5, space_w=30,
                  line_spacing=140, speckles=10, margin_x=25)
        for i in range(n)
    ]


def _weights():
    """Peaky but not chaotic weights (as tests/test_torch_slice.py), so
    that every line decodes to several characters."""
    rng = np.random.default_rng(0)
    d = init_params_np(rng, 48, 100, len(Codec()), initial_range=0.3)
    for direction in ("fwd", "bwd"):
        for k in ("WGI", "WGF", "WGO", "WCI"):
            d[direction][k][:, 1:49] *= 2.0 / 0.3
    d["W2"] = rng.uniform(-1, 1, d["W2"].shape).astype(np.float32)
    d["W2"][0, 0] += 2.0
    return jax_params(d)


@pytest.fixture(scope="module")
def recognizers():
    params = _weights()
    rec_j = JaxRec(params, Codec(), normalize_on_device=True)
    rec_t = SeqRecognizer(params_from_jax(params_to_np(params)), Codec(),
                          normalize_on_device=True, device="cpu")
    return rec_j, rec_t


@pytest.fixture
def jax_frames(monkeypatch):
    def frames(grey, hs, ws, **kw):
        out = lineest_jax.normalize_batch_device(
            grey.numpy(), hs.numpy(), ws.numpy(), **kw)
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(recognizer, "normalize_batch_device", frames)


def _assert_identical(got, ref):
    assert any(r is not None for r in ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if g is None or r is None:
            assert g is None and r is None
            continue
        assert json.dumps(g.json_dict, sort_keys=True) == \
            json.dumps(r.json_dict, sort_keys=True)
        assert [(c.char, c.ul, c.lr) for c in g.all_chars] == \
            [(c.char, c.ul, c.lr) for c in r.all_chars]


@pytest.mark.parametrize("backend,workers", [("hybrid", None),
                                             ("device", None),
                                             ("hybrid", 2)])
def test_batch_matches_jax(backend, workers, recognizers, jax_frames):
    """The native host raster with the OCR pipelined, ops/device.py's
    packed chain (the card's raster, on CPU tensors here), and the native
    raster on a thread pool, each against the JAX package's hybrid
    batch."""
    rec_j, rec_t = recognizers
    folios = [(p.image, p.transcript) for p in _pages()]
    got = process_batch(folios, rec_t, backend=backend, device="cpu",
                        raster_workers=workers)
    ref = jax_batch(folios, rec_j, backend="hybrid")
    _assert_identical(got, ref)
    assert sum(len(r.all_chars) for r in got) > 6 * 6


@pytest.mark.parametrize("backend", ["hybrid", "host"])
def test_injected_ocr_matches_jax(backend):
    pages = _pages(3)
    folios = [(p.image, p.transcript) for p in pages]
    ocr = [ocr_with_spaces(corrupt_ocr(np.random.default_rng(i),
                                       p.char_boxes))
           for i, p in enumerate(pages)]
    got = process_batch(folios, None, backend=backend, existing_ocr=ocr,
                        device="cpu")
    _assert_identical(got, jax_batch(folios, None, backend=backend,
                                     existing_ocr=ocr))
    assert all(r.json_dict["syl_boxes"] for r in got)


def test_batch_cli_writes_the_sequential_files(tmp_path):
    from text_alignment_tpu_torch.cli import main
    from text_alignment_tpu_torch.models.codec import Codec as TCodec
    from text_alignment_tpu_torch.models.pyrnn import save_pyrnn

    pages = _pages(3)
    png = tmp_path / "png"
    png.mkdir()
    with open(tmp_path / "chants.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["h"] * 15)
        for k, p in enumerate(pages):
            Image.fromarray(p.image).save(png / f"ms_f{k}_text.png")
            row = [""] * 15
            row[2], row[3], row[10], row[14] = f"f{k}", "1", "1", p.transcript
            w.writerow(row)
    save_pyrnn(str(tmp_path / "m.pyrnn.gz"),
               params_to_np(_weights()), TCodec())

    def run(out, *extra):
        assert main(["align", "--csv", str(tmp_path / "chants.csv"),
                     "--manuscript", "ms", "--model",
                     str(tmp_path / "m.pyrnn.gz"), "--png-dir", str(png),
                     "--out-json", str(tmp_path / out), "--folios", "f0",
                     "f1", "f2", "--device", "cpu", *extra]) == 0
        return {p.name: p.read_text()
                for p in sorted((tmp_path / out).iterdir())}

    batched = run("batched", "--batch", "3")
    assert len(batched) == 3
    assert batched == run("sequential")


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch):
    """Without a card, every entry point of the port that is not given
    the CPU raises, and none falls back to it."""
    from text_alignment_tpu_torch.align import (align_grid,
                                                perform_alignment)
    from text_alignment_tpu_torch.align.nw_torch import align_pairs
    from text_alignment_tpu_torch.align.scoring import resolve_scoring
    from text_alignment_tpu_torch.evaluate import grid_search
    from text_alignment_tpu_torch.pipeline import process

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    page = _pages(1)[0]
    d = params_to_np(_weights())
    from text_alignment_tpu_torch.models.lstm import params_from_np

    calls = [
        lambda: process(page.image, page.transcript,
                        existing_ocr=page.char_boxes, backend="hybrid",
                        verbose=False),
        lambda: process_batch([(page.image, page.transcript)], None,
                              existing_ocr=[page.char_boxes]),
        lambda: SeqRecognizer(params_from_np(d), Codec()),
        lambda: perform_alignment(list("abc"), list("abd")),
        lambda: align_grid(list("abc"), list("abd"), [[8, -4, -7, -7, -3,
                                                       0]]),
        lambda: align_pairs([(list("abc"), list("abd"))],
                            resolve_scoring(None)),
        lambda: grid_search([], shuffle=False, verbose=False,
                            params_list=[[8, -4, -7, -7, -3, 0]]),
        lambda: process_batch([(page.image, page.transcript)], None,
                              existing_ocr=[page.char_boxes],
                              device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    out = process(page.image, page.transcript, existing_ocr=page.char_boxes,
                  backend="hybrid", verbose=False, device="cpu")
    assert out is not None
