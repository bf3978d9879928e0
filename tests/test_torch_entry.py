"""The port's entry points around process() against the JAX package's, on
the CPU: the Rodan task body, the real-asset harness (verify_reference, on
tests/test_verify_reference.py's checkouts), the content-addressed stage
cache of process() and ``align --cache-dir``, and the CLI subcommands
``serve``, ``evaluate``, ``mei`` and ``verify-reference``."""

import csv
import importlib
import json
import os
import pickle
import shutil
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch
from PIL import Image

from test_aux import _mini_mei
from test_verify_reference import checkout, full_checkout  # noqa: F401
from text_alignment_tpu import rodan_job as jax_rodan
from text_alignment_tpu.cli import main as jax_main
from text_alignment_tpu.pipeline import process as jax_process
from text_alignment_tpu.verify_reference import verify as jax_verify
from text_alignment_tpu_torch import rodan_job
from text_alignment_tpu_torch.cli import main
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lstm import init_params_np
from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch.pipeline import process, to_JSON_dict
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)
from text_alignment_tpu_torch.verify_reference import verify

torch.set_num_threads(1)
process_mod = importlib.import_module(
    "text_alignment_tpu_torch.pipeline.process")


def _model(path):
    """A small .pyrnn.gz whose decodes are not empty (scaled output
    layer), readable by both packages."""
    d = init_params_np(np.random.default_rng(0), 48, 16, len(Codec()))
    d["W2"] *= 20.0
    save_pyrnn(str(path), d, Codec())
    return str(path)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """One folio in the reference's checkout layout: page image, chant CSV,
    OCR pickle, GT XML (from the JAX package's host output), a raw MEI and
    a model."""
    root = tmp_path_factory.mktemp("entry")
    for d in ("png", "pik", "gt"):
        (root / d).mkdir()
    page = make_page(np.random.default_rng(8), n_lines=3, words_per_line=2)
    Image.fromarray(page.image).save(root / "png" / "synth_001r_text.png")
    chars = ocr_with_spaces(corrupt_ocr(np.random.default_rng(3),
                                        page.char_boxes))
    with open(root / "pik" / "synth_001r_boxes.pickle", "wb") as f:
        pickle.dump(chars, f, -1)
    with open(root / "chants.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["h"] * 15)
        row = [""] * 15
        row[2], row[3], row[10], row[14] = "001r", "1", "1", page.transcript
        w.writerow(row)
    (root / "transcript.txt").write_text(page.transcript + "\n")
    syl_boxes, _, peaks, _ = jax_process(page.image, page.transcript,
                                         existing_ocr=chars, verbose=False,
                                         backend="host")
    js = to_JSON_dict(syl_boxes, peaks)
    ann = ET.Element("annotation")
    for s in js["syl_boxes"][:6]:
        obj = ET.SubElement(ann, "object")
        ET.SubElement(obj, "name").text = s["syl"]
        ET.SubElement(obj, "difficult").text = "0"
        bb = ET.SubElement(obj, "bndbox")
        for tag, v in (("xmin", s["ul"][0] + 2), ("ymin", s["ul"][1]),
                       ("xmax", s["lr"][0]), ("ymax", s["lr"][1] - 1)):
            ET.SubElement(bb, tag).text = str(v)
    ET.ElementTree(ann).write(root / "gt" / "synth_001r_gt.xml")
    _mini_mei().write(root / "raw.mei")
    _model(root / "m.pyrnn.gz")
    return root, page


def test_rodan_task_body_matches_jax(assets, tmp_path):
    root, page = assets
    inputs = {"Transcript": [{"resource_path": str(root / "transcript.txt")}],
              "Text Layer": [{"resource_path": str(
                  root / "png" / "synth_001r_text.png")}]}
    settings = {"MEI Version": "3.9.9",
                "OCR Model": str(root / "m.pyrnn.gz")}
    outs = {}
    for tag, mod, extra in (("port", rodan_job, {"device": "cpu"}),
                            ("jax", jax_rodan, {})):
        out = tmp_path / f"{tag}.json"
        ok = mod.run_task(inputs, settings,
                          {"JSON": [{"resource_path": str(out)}]},
                          backend="hybrid", **extra)
        assert ok, tag
        outs[tag] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    for name in ("SETTINGS", "INPUT_PORT_TYPES", "OUTPUT_PORT_TYPES",
                 "RESOURCE_TYPES", "JOB_NAME", "JOB_CATEGORY"):
        assert getattr(rodan_job, name) == getattr(jax_rodan, name)


def test_verify_reference_matches_jax(checkout):  # noqa: F811
    got = verify(str(checkout), backend="host", verbose=False, device="cpu")
    ref = jax_verify(str(checkout), backend="host", verbose=False)
    assert got.to_dict() == ref.to_dict()
    assert got.n_match == 1


def test_verify_reference_cli_matches_jax(full_checkout, tmp_path):  # noqa: F811,E501
    out, out_j = tmp_path / "port.json", tmp_path / "jax.json"
    rc = main(["verify-reference", "--assets", str(full_checkout),
               "--backend", "host", "--device", "cpu", "--out", str(out)])
    rc_j = jax_main(["verify-reference", "--assets", str(full_checkout),
                     "--backend", "host", "--out", str(out_j)])
    assert rc == rc_j == 1  # a mismatch and an error in the checkout
    assert json.load(open(out)) == json.load(open(out_j))


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(process_mod, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(process_mod, name, counted)
    return calls


def test_stage_cache_hits_with_identical_result(assets, tmp_path,
                                                monkeypatch):
    root, page = assets
    model = str(root / "m.pyrnn.gz")
    cache = tmp_path / "cache"
    pre = _count_calls(monkeypatch, "preprocess_images")
    ocr = _count_calls(monkeypatch, "_resolve_recognizer")
    kw = dict(ocropus_model=model, backend="hybrid", verbose=False,
              device="cpu")
    first = process(page.image, page.transcript, stage_cache=str(cache), **kw)
    assert (len(pre), len(ocr)) == (1, 1)
    assert sorted(p.split("_")[0] for p in os.listdir(cache)) == [
        "ocr", "preproc"]
    second = process(page.image, page.transcript, stage_cache=str(cache),
                     **kw)
    assert (len(pre), len(ocr)) == (1, 1)  # both stages hit
    plain = process(page.image, page.transcript, **kw)
    for out in (first, second):
        assert (json.dumps(to_JSON_dict(out[0], out[2]))
                == json.dumps(to_JSON_dict(plain[0], plain[2])))
        assert out[3] == plain[3]
    # the OCR key names the normalizer actually taken: a model path on the
    # CPU device keeps scipy's, so the full route's switch is still a hit
    n_pre, n_ocr = len(pre), len(ocr)
    monkeypatch.setenv("TEXT_ALIGNMENT_TPU_TAIL", "full")
    process(page.image, page.transcript, stage_cache=str(cache), **kw)
    assert (len(pre), len(ocr)) == (n_pre, n_ocr)
    # a recognizer that normalizes on the device keys the route it takes,
    # and only the OCR key changes with it, not the raster's
    rec = SeqRecognizer.from_pyrnn(model, device="cpu")
    rec.normalize_on_device = True
    kw["ocropus_model"] = rec
    for route, misses in (("full", 1), ("default", 2), ("default", 2),
                          ("full", 2)):
        if route == "full":
            monkeypatch.setenv("TEXT_ALIGNMENT_TPU_TAIL", "full")
        else:
            monkeypatch.delenv("TEXT_ALIGNMENT_TPU_TAIL", raising=False)
        process(page.image, page.transcript, stage_cache=str(cache), **kw)
        assert (len(pre), len(ocr)) == (n_pre, n_ocr + misses), route


def test_stage_cache_written_by_the_jax_package_misses(assets, tmp_path):
    root, page = assets
    model = str(root / "m.pyrnn.gz")
    cache = tmp_path / "shared"
    jax_process(page.image, page.transcript, ocropus_model=model,
                backend="host", verbose=False, stage_cache=str(cache))
    jax_entries = set(os.listdir(cache))
    assert len(jax_entries) == 2
    got = process(page.image, page.transcript, ocropus_model=model,
                  backend="host", verbose=False, stage_cache=str(cache),
                  device="cpu")
    entries = set(os.listdir(cache))
    assert jax_entries < entries and len(entries) == 4  # two misses
    plain = process(page.image, page.transcript, ocropus_model=model,
                    backend="host", verbose=False, device="cpu")
    assert to_JSON_dict(got[0], got[2]) == to_JSON_dict(plain[0], plain[2])


def _align_args(root, out, *extra):
    return ["align", "--csv", str(root / "chants.csv"), "--manuscript",
            "synth", "--model", str(root / "m.pyrnn.gz"), "--png-dir",
            str(root / "png"), "--out-json", str(out), "--folios", "001r",
            "--backend", "hybrid", "--device", "cpu", *extra]


def test_cli_align_cache_dir(assets, tmp_path):
    root, _ = assets
    cache = tmp_path / "cache"
    for k in range(2):
        assert main(_align_args(root, tmp_path / f"out{k}", "--cache-dir",
                                str(cache))) == 0
    assert main(_align_args(root, tmp_path / "plain")) == 0
    assert len(os.listdir(cache)) == 2
    want = (tmp_path / "plain" / "synth_001r.json").read_bytes()
    for k in range(2):
        assert (tmp_path / f"out{k}" / "synth_001r.json").read_bytes() == want


def test_cli_serve(assets, tmp_path, capsys):
    root, page = assets
    spool = tmp_path / "spool"
    spool.mkdir()
    shutil.copy(root / "png" / "synth_001r_text.png", spool / "p.png")
    for name, extra in (("a", {"existing_ocr_pickle": str(
            root / "pik" / "synth_001r_boxes.pickle")}), ("b", {})):
        with open(spool / f"{name}.job.json", "w") as f:
            json.dump({"image": "p.png", "transcript": page.transcript,
                       **extra}, f)
    rc = main(["serve", "--spool", str(spool), "--model",
               str(root / "m.pyrnn.gz"), "--once", "--batch", "2",
               "--device", "cpu"])
    assert rc == 0
    assert "processed 2 job(s), 0 failed" in capsys.readouterr().out
    assert (spool / "a.job.done").exists() and (spool / "b.job.done").exists()
    assert json.load(open(spool / "a.json"))["syl_boxes"]


def _evaluate_args(root, *extra):
    return ["evaluate", "--csv", str(root / "chants.csv"), "--manuscript",
            "synth", "--png-dir", str(root / "png"), "--pickle-dir",
            str(root / "pik"), "--gt-dir", str(root / "gt"), "--folios",
            "001r", "--backend", "host", *extra]


def test_cli_evaluate_matches_jax(assets, capsys):
    root, _ = assets
    for extra in ([], ["--scoring", "[5,-4,-2,-2,0,0]"]):
        assert main(_evaluate_args(root, "--device", "cpu", *extra)) == 0
        got = capsys.readouterr().out
        assert jax_main(_evaluate_args(root, *extra)) == 0
        assert got == capsys.readouterr().out
        assert "mean: bbox IoU" in got


def test_cli_evaluate_grid(assets, capsys):
    root, _ = assets
    assert main(_evaluate_args(root, "--grid", "--device", "cpu")) == 0
    ranked = capsys.readouterr().out.strip().splitlines()[-1]
    assert ranked.startswith("[((") and ranked.count("((") == 10


def test_cli_mei_matches_jax(assets, tmp_path):
    root, _ = assets
    outs = {}
    for tag, fn, extra in (("port", main, ["--device", "cpu"]),
                           ("jax", jax_main, [])):
        out = tmp_path / f"{tag}.mei"
        np.random.seed(5)  # the new zones' ids come from np.random
        assert fn(["mei", "--transcript", str(root / "transcript.txt"),
                   "--image", str(root / "png" / "synth_001r_text.png"),
                   "--mei", str(root / "raw.mei"), "--out", str(out),
                   "--ocr-pickle",
                   str(root / "pik" / "synth_001r_boxes.pickle"),
                   "--backend", "hybrid", *extra]) == 0
        outs[tag] = out.read_bytes()
    assert outs["port"] == outs["jax"]


def test_serving_entry_points_need_a_card_unless_given_the_cpu(
        assets, tmp_path, monkeypatch):
    from text_alignment_tpu_torch import serve as serve_mod

    root, _ = assets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inputs = {"Transcript": [{"resource_path": str(root / "transcript.txt")}],
              "Text Layer": [{"resource_path": str(
                  root / "png" / "synth_001r_text.png")}]}
    out = {"JSON": [{"resource_path": str(tmp_path / "r.json")}]}
    calls = [
        lambda: serve_mod.serve(str(tmp_path), None, once=True),
        lambda: serve_mod.warmup(None, "hybrid"),
        lambda: rodan_job.run_task(inputs, {"OCR Model": str(
            root / "m.pyrnn.gz")}, out),
        lambda: main(["serve", "--spool", str(tmp_path), "--once"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    assert serve_mod.serve(str(tmp_path), None, once=True,
                           device="cpu").attempted == 0
