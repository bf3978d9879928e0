"""The port's gtedit round trip (line-crop extraction -> correction HTML ->
ground truth) and the CLI's ``lines`` and ``gtedit``: the six cases of
tests/test_gtedit.py on the port's copy, the crops against the JAX
package's (the same files, byte for byte, from the library and from the
CLI), and the ``--model`` prefill through the port's recognizer."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from text_alignment_tpu import gtedit as jax_gtedit
from text_alignment_tpu.cli import main as jax_main
from text_alignment_tpu.pipeline.preprocess import \
    PreprocParams as JaxPreprocParams
from text_alignment_tpu_torch import gtedit
from text_alignment_tpu_torch.cli import main
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lstm import (init_params_np,
                                                  params_from_np)
from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch.pipeline.preprocess import PreprocParams
from text_alignment_tpu_torch.synth import make_page

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lines_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lines")
    page = make_page(np.random.default_rng(5), n_lines=3, words_per_line=2)
    paths = gtedit.extract_lines(
        page.image, str(d), "p001", backend="host",
        preproc_params=PreprocParams(filter_size=8))
    assert len(paths) == 3
    return d


def _files(d):
    return {fn: (d / fn).read_bytes() for fn in sorted(os.listdir(d))}


@pytest.mark.parametrize("backend", ["host", "hybrid"])
def test_extract_lines_matches_jax(tmp_path, backend):
    page = make_page(np.random.default_rng(5), n_lines=3, words_per_line=2)
    port, ref = tmp_path / "port", tmp_path / "jax"
    gtedit.extract_lines(page.image, str(port), "p001", backend=backend,
                         preproc_params=PreprocParams(filter_size=8))
    jax_gtedit.extract_lines(page.image, str(ref), "p001", backend=backend,
                             preproc_params=JaxPreprocParams(filter_size=8))
    got = _files(port)
    assert len(got) == 3 and got == _files(ref)


def test_extract_lines_polarity_round_trips_into_train(lines_dir):
    # crops are ink-black-on-white uint8 PNGs: the polarity
    # lineest_host.normalize_strip expects for grey images, so the same
    # files feed `train --lines-dir` unmodified
    from text_alignment_tpu_torch.models.lineest_host import normalize_strip

    img = np.asarray(Image.open(os.path.join(lines_dir, "p001_0000.png")))
    assert img.dtype == np.uint8
    assert img.max() == 255 and img.min() == 0
    assert img[0].max() == 255 and img[-1].max() == 255
    norm = normalize_strip(img)
    assert norm is not None
    frames, raw_w = norm
    assert frames.shape[1] == 48 and raw_w == img.shape[1]


def test_html_prefills_gt_and_escapes(lines_dir, tmp_path):
    with open(os.path.join(lines_dir, "p001_0000.gt.txt"), "w") as f:
        f.write('do<mi>nus "a&b"\n')
    out = tmp_path / "correction.html"
    assert gtedit.make_html(str(lines_dir), str(out)) == 3
    content = out.read_text()
    assert content.count('<input class="gt"') == 3
    assert content.count("data:image/png;base64,") == 3
    assert "do&lt;mi&gt;nus &quot;a&amp;b&quot;" in content
    rows = gtedit.parse_corrections(str(out))
    assert rows["p001_0000"] == 'do<mi>nus "a&b"'
    assert rows["p001_0001"] == ""
    # the JAX package's parser reads the port's page the same way
    assert jax_gtedit.parse_corrections(str(out)) == rows


def test_saved_html_edit_extracts_gt(lines_dir, tmp_path):
    out = tmp_path / "correction.html"
    gtedit.make_html(str(lines_dir), str(out))
    content = out.read_text().replace(
        'name="p001_0001" value=""', 'name="p001_0001" value="alleluia"')
    saved = tmp_path / "saved.html"
    saved.write_text(content)
    gt_dir = tmp_path / "gt"
    # the prefilled p001_0000 and the corrected p001_0001; the untouched
    # empty p001_0002 must not become an empty CTC training pair
    assert gtedit.extract(str(saved), str(gt_dir)) == 2
    assert (gt_dir / "p001_0001.gt.txt").read_text() == "alleluia\n"
    assert not (gt_dir / "p001_0002.gt.txt").exists()


def test_tsv_extract_and_traversal_guard(tmp_path):
    tsv = tmp_path / "corrections.tsv"
    tsv.write_text("p001_0000\tdominus deus\n"
                   "../evil\towned\n"          # path traversal: ignored
                   "p001_0001\tin excelsis\n")
    gt_dir = tmp_path / "gt"
    assert gtedit.extract(str(tsv), str(gt_dir)) == 2
    assert sorted(os.listdir(gt_dir)) == ["p001_0000.gt.txt",
                                          "p001_0001.gt.txt"]
    assert (gt_dir / "p001_0000.gt.txt").read_text() == "dominus deus\n"


def test_cli_lines_and_gtedit(tmp_path):
    page = make_page(np.random.default_rng(6), n_lines=2, words_per_line=2)
    png = tmp_path / "folio.png"
    Image.fromarray(page.image).save(png)
    out_dir, jax_dir = tmp_path / "lines", tmp_path / "jax_lines"
    assert main(["lines", str(png), "--out-dir", str(out_dir),
                 "--filter-size", "8", "--device", "cpu"]) == 0
    assert jax_main(["lines", str(png), "--out-dir", str(jax_dir),
                     "--filter-size", "8"]) == 0
    assert sorted(os.listdir(out_dir)) == ["folio_0000.png",
                                           "folio_0001.png"]
    assert _files(out_dir) == _files(jax_dir)

    html = tmp_path / "c.html"
    assert main(["gtedit", "html", "--lines-dir", str(out_dir),
                 "--out", str(html), "--device", "cpu"]) == 0
    tsv = tmp_path / "c.tsv"
    tsv.write_text("folio_0000\tgloria\nfolio_0001\tkyrie\n")
    assert main(["gtedit", "extract", str(tsv), "--out-dir", str(out_dir),
                 "--device", "cpu"]) == 0
    assert (out_dir / "folio_0000.gt.txt").read_text() == "gloria\n"
    pairs = [fn for fn in os.listdir(out_dir) if fn.endswith(".png")
             and os.path.isfile(os.path.join(out_dir, fn[:-4] + ".gt.txt"))]
    assert len(pairs) == 2


def test_cli_lines_and_gtedit_need_a_card_unless_given_the_cpu(
        tmp_path, monkeypatch):
    page = make_page(np.random.default_rng(6), n_lines=2, words_per_line=2)
    png = tmp_path / "folio.png"
    Image.fromarray(page.image).save(png)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["lines", str(png), "--out-dir", str(tmp_path / "l")],
                 ["gtedit", "html", "--lines-dir", str(tmp_path),
                  "--out", str(tmp_path / "c.html")],
                 ["gtedit", "extract", str(png), "--out-dir",
                  str(tmp_path)]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(argv)
    assert not (tmp_path / "l").exists()


def _prefill_recognizer():
    codec = Codec(["", "~", " ", "a", "b", "c"])
    d = init_params_np(np.random.default_rng(1), 48, 12, len(codec))
    return d, codec


def test_html_recognizer_prefill(lines_dir, tmp_path):
    # crops without .gt.txt get one batched recognizer pass as prefill;
    # existing gt wins over OCR. Untrained weights give arbitrary (possibly
    # empty) text; the contract is that the pass runs and fills the field
    with open(os.path.join(lines_dir, "p001_0000.gt.txt"), "w") as f:
        f.write('do<mi>nus "a&b"\n')
    d, codec = _prefill_recognizer()
    rec = SeqRecognizer(params_from_np(d), codec, device="cpu")
    out = tmp_path / "c.html"
    assert gtedit.make_html(str(lines_dir), str(out), recognizer=rec) == 3
    rows = gtedit.parse_corrections(str(out))
    assert set(rows) == {"p001_0000", "p001_0001", "p001_0002"}
    assert rows["p001_0000"] == 'do<mi>nus "a&b"'
    for stem in ("p001_0001", "p001_0002"):
        assert set(rows[stem]) <= set(codec.charset)


def test_cli_gtedit_html_model_prefill_matches_jax(lines_dir, tmp_path):
    """``gtedit html --model`` on the port (CPU) and on the JAX package,
    host backend (the scipy normalizer on both): the same prefills."""
    d, codec = _prefill_recognizer()
    d["W2"] *= 20.0  # peaky posteriors: a non-empty decode
    model = str(tmp_path / "m.pyrnn.gz")
    save_pyrnn(model, d, codec)
    for stem in ("p001_0001", "p001_0002"):
        gt = os.path.join(lines_dir, stem + ".gt.txt")
        if os.path.exists(gt):
            os.remove(gt)
    port, ref = tmp_path / "port.html", tmp_path / "jax.html"
    assert main(["gtedit", "html", "--lines-dir", str(lines_dir), "--out",
                 str(port), "--model", model, "--backend", "host",
                 "--device", "cpu"]) == 0
    assert jax_main(["gtedit", "html", "--lines-dir", str(lines_dir),
                     "--out", str(ref), "--model", model, "--backend",
                     "host"]) == 0
    got = gtedit.parse_corrections(str(port))
    assert got == jax_gtedit.parse_corrections(str(ref))
    assert any(got[s] for s in ("p001_0001", "p001_0002"))
