"""``python -m text_alignment_tpu_torch align`` against the JAX package's
``align`` on the same fixture folio: the JSON it writes is equal, with OCR
from a .pyrnn.gz model on the CPU and with reused OCR pickles; and the
batched ``--batch`` run against the sequential loop."""

import csv
import json
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from text_alignment_tpu.cli import main as jax_main
from text_alignment_tpu.synth import corrupt_ocr, make_page, ocr_with_spaces
from text_alignment_tpu_torch.cli import main
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lstm import init_params_np
from text_alignment_tpu_torch.models.pyrnn import save_pyrnn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    page = make_page(np.random.default_rng(8), n_lines=3, words_per_line=2)
    png = root / "png"
    png.mkdir()
    Image.fromarray(page.image).save(png / "synth_001r_text.png")
    pik = root / "pik"
    pik.mkdir()
    chars = ocr_with_spaces(corrupt_ocr(np.random.default_rng(3),
                                        page.char_boxes))
    with open(pik / "synth_001r_boxes.pickle", "wb") as f:
        pickle.dump(chars, f, -1)
    with open(root / "chants.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["h"] * 15)
        row = [""] * 15
        row[2], row[3], row[10], row[14] = "001r", "1", "1", page.transcript
        w.writerow(row)
    d = init_params_np(np.random.default_rng(0), 48, 16, len(Codec()))
    d["W2"] *= 20.0
    save_pyrnn(str(root / "m.pyrnn.gz"), d, Codec())
    return root


def _args(root, out, *extra):
    return ["align", "--csv", str(root / "chants.csv"), "--manuscript",
            "synth", "--model", str(root / "m.pyrnn.gz"), "--png-dir",
            str(root / "png"), "--out-json", str(root / out), "--folios",
            "001r", "--backend", "hybrid", *extra]


@pytest.mark.parametrize("reuse", [False, True])
def test_align_json_matches_jax(fixture_dir, reuse):
    extra = ["--pickle-dir", str(fixture_dir / "pik"), "--reuse-ocr"] \
        if reuse else []
    tag = "reuse" if reuse else "model"
    assert main(_args(fixture_dir, f"t_{tag}", "--device", "cpu",
                      *extra)) == 0
    assert jax_main(_args(fixture_dir, f"j_{tag}", *extra)) == 0
    got = json.load(open(fixture_dir / f"t_{tag}" / "synth_001r.json"))
    ref = json.load(open(fixture_dir / f"j_{tag}" / "synth_001r.json"))
    assert got == ref
    if reuse:
        assert got["syl_boxes"]


def test_batch_is_refused_with_the_roadmap_item(fixture_dir):
    """``--batch`` was refused until the batched pipeline was ported; now
    ``--batch 4`` runs it and writes the sequential loop's JSON."""
    assert main(_args(fixture_dir, "t_batch", "--batch", "4", "--device",
                      "cpu")) == 0
    assert main(_args(fixture_dir, "t_seq", "--device", "cpu")) == 0
    got = (fixture_dir / "t_batch" / "synth_001r.json").read_text()
    assert got == (fixture_dir / "t_seq" / "synth_001r.json").read_text()
