"""``backend="device"`` through the port's entry points on the CPU, against
the JAX package's device path and the port's other backends: the raster
and line segmentation (tests/test_pipeline.py), process()'s JSON, the
batch (tests/test_parallel.py), the non-strict area filter
(tests/test_strict.py), the stage cache, the Rodan job's default, the
CLI's seven --backend options and its subcommands run with
``--backend device``, serve, and the grid search. JAX's device raster
costs seconds a page on the CPU, so each page runs it once, in a
module-scoped fixture."""

import csv
import json
import os
import pickle
import shutil
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch
from PIL import Image

from text_alignment_tpu import cli as jax_cli
from text_alignment_tpu import rodan_job as jax_rodan
from text_alignment_tpu.parallel.batch import process_batch as jax_batch
from text_alignment_tpu.pipeline import process as jax_process
from text_alignment_tpu.pipeline import to_JSON_dict as jax_json
from text_alignment_tpu.pipeline.preprocess import (
    identify_text_lines as jax_lines, preprocess_images as jax_preprocess)
from text_alignment_tpu_torch import cli, rodan_job
from text_alignment_tpu_torch.evaluate import grid_search, parse_gt_xml
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lstm import init_params_np
from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
from text_alignment_tpu_torch.parallel import process_batch
from text_alignment_tpu_torch.pipeline import process, to_JSON_dict
from text_alignment_tpu_torch.pipeline.assemble import to_processed_frame
from text_alignment_tpu_torch.pipeline.preprocess import (
    PreprocParams, identify_text_lines, preprocess_images, raster_stream)
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)

torch.set_num_threads(1)
CPU = "cpu"
SYNTH_PARAMS = PreprocParams(filter_size=8)


def _strips(strips):
    return [(s.offset_x, s.offset_y, s.img.tobytes()) for s in strips]


@pytest.fixture(scope="module")
def page():
    return make_page(np.random.default_rng(3), n_lines=5, words_per_line=3)


@pytest.fixture(scope="module")
def jax_device(page):
    """The JAX package's device raster and lines of ``page``, once."""
    image, eroded, angle = jax_preprocess(page.image, backend="device")
    strips, peaks, smoothed = jax_lines(image, eroded, backend="device",
                                        params=SYNTH_PARAMS)
    return (np.asarray(image), np.asarray(eroded), angle), \
        (strips, peaks, smoothed)


def test_preprocess_device_matches_jax_device(page, jax_device):
    (img_j, er_j, ang_j), (s_j, p_j, sm_j) = jax_device
    img, er, ang = preprocess_images(page.image, backend="device",
                                     device=CPU)
    assert ang == ang_j
    np.testing.assert_array_equal(img, img_j)
    np.testing.assert_array_equal(er, er_j)
    s, p, sm = identify_text_lines(img, er, backend="device",
                                   params=SYNTH_PARAMS, device=CPU)
    assert p == p_j and len(p) == 5
    np.testing.assert_array_equal(sm, sm_j)
    assert _strips(s) == _strips(s_j)
    # and the port's host engine
    img_h, er_h, ang_h = preprocess_images(page.image, backend="host")
    assert ang_h == ang
    np.testing.assert_array_equal(img_h, img)
    np.testing.assert_array_equal(er_h, er)


def test_device_lines_take_the_eroded_page_as_a_tensor(page, jax_device):
    """identify_text_lines(backend="device") on the eroded page already on
    the device gives what it gives on the numpy page, and
    raster_stream(backend="device"), which keeps that page on the device,
    gives the JAX device path's raster and lines."""
    (img_j, er_j, ang_j), (s_j, p_j, sm_j) = jax_device
    s, p, sm = identify_text_lines(img_j, torch.from_numpy(er_j),
                                   backend="device", params=SYNTH_PARAMS,
                                   device=CPU)
    assert p == p_j
    np.testing.assert_array_equal(sm, sm_j)
    assert _strips(s) == _strips(s_j)
    [(img, ang, s, p)] = raster_stream([page.image], backend="device",
                                       params=SYNTH_PARAMS, device=CPU)
    assert ang == ang_j and p == p_j
    np.testing.assert_array_equal(img, img_j)
    assert _strips(s) == _strips(s_j)


def test_process_device_matches_jax_device_json(page, jax_device):
    """process(backend="device") on the CPU gives the JAX device path's
    JSON (the JAX call reuses the fixture's raster)."""
    pre = jax_device[0]
    ocr = ocr_with_spaces(corrupt_ocr(np.random.default_rng(11),
                                      page.char_boxes))
    lifted = [to_processed_frame(cb, pre[2], pre[0].shape, page.image.shape)
              for cb in ocr]
    got = process(page.image, page.transcript, existing_ocr=lifted,
                  verbose=False, backend="device", device=CPU,
                  preproc_params=SYNTH_PARAMS)
    want = jax_process(page.image, page.transcript, existing_ocr=lifted,
                       existing_preproc_images=pre, verbose=False,
                       backend="device", preproc_params=SYNTH_PARAMS)
    assert to_JSON_dict(got[0], got[2]) == jax_json(want[0], want[2])
    host = process(page.image, page.transcript, existing_ocr=lifted,
                   verbose=False, backend="host", device=CPU,
                   preproc_params=SYNTH_PARAMS)
    assert to_JSON_dict(got[0], got[2]) == to_JSON_dict(host[0], host[2])


def test_process_batch_device_backend_matches_host():
    rng = np.random.default_rng(22)
    folios, injected = [], []
    for i in range(2):
        pg = make_page(np.random.default_rng(40 + i), n_lines=4,
                       words_per_line=2)
        ocr = ocr_with_spaces(corrupt_ocr(rng, pg.char_boxes))
        image, _, angle = preprocess_images(pg.image, backend="host")
        injected.append([to_processed_frame(cb, angle, image.shape,
                                            pg.image.shape) for cb in ocr])
        folios.append((pg.image, pg.transcript))
    kw = dict(preproc_params=SYNTH_PARAMS, existing_ocr=injected)
    dev = process_batch(folios, None, backend="device", device=CPU, **kw)
    host = process_batch(folios, None, backend="host", device=CPU, **kw)
    jax_host = jax_batch(folios, None, backend="host", **kw)
    for d, h, j in zip(dev, host, jax_host):
        assert d.json_dict == h.json_dict == j.json_dict
        assert d.syl_boxes


def test_unknown_backend_raises_value_error():
    img = np.full((40, 40, 3), 255, np.uint8)
    with pytest.raises(ValueError, match="unknown backend"):
        process_batch([(img, "a")], None, backend="xla", existing_ocr=[[]],
                      device=CPU)
    with pytest.raises(ValueError, match="unknown backend"):
        process(img, "a", existing_ocr=[], backend="tpu", device=CPU)


@pytest.mark.parametrize("backend", ["host", "hybrid", "device"])
def test_nonstrict_sat_filter_uses_area(backend):
    """A wide, 3-row bar: nrows (3) <= 180 so parity mode keeps it; its
    area (600) > 180 so strict=False removes it. The tall thin bar exceeds
    the threshold both ways (tests/test_strict.py)."""
    ink = np.zeros((260, 260), bool)
    ink[10:13, 20:220] = True      # wide bar: nrows 3, area 600
    ink[30:230, 240:241] = True    # tall bar: nrows 200, area 200
    img = np.where(ink, 0, 255).astype(np.uint8)
    kw = dict(correct_rotation=False, backend=backend, despeckle_amt=0,
              device=CPU)
    bs, _, _ = preprocess_images(
        img, params=PreprocParams(sat_area_thresh=180), **kw)
    bf, _, _ = preprocess_images(
        img, params=PreprocParams(sat_area_thresh=180, sat_filter_area=True),
        **kw)
    assert bs[11, 100] and not bs[100, 240]
    assert not bf[11, 100] and not bf[100, 240]


def test_stage_cache_keys_name_the_backend(page, tmp_path, monkeypatch):
    """The preprocess entry of backend="device" is its own: a hybrid run
    on the same directory misses, and a second device run hits."""
    import importlib

    process_mod = importlib.import_module(
        "text_alignment_tpu_torch.pipeline.process")
    calls = []
    real = process_mod.preprocess_images

    def counted(*a, **k):
        calls.append(k["backend"])
        return real(*a, **k)

    monkeypatch.setattr(process_mod, "preprocess_images", counted)
    ocr = ocr_with_spaces(corrupt_ocr(np.random.default_rng(4),
                                      page.char_boxes))
    outs = [process(page.image, page.transcript, existing_ocr=ocr,
                    backend=b, verbose=False, device=CPU,
                    stage_cache=str(tmp_path))
            for b in ("device", "device", "hybrid")]
    assert calls == ["device", "hybrid"]
    js = [to_JSON_dict(o[0], o[2]) for o in outs]
    assert js[0] == js[1] == js[2]


# ---------------------------------------------------------------------------
# the entry points around process()
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """One folio in the reference's checkout layout (png/, pik/, a chant
    CSV, a transcript) and a small model both packages read."""
    root = tmp_path_factory.mktemp("device_entry")
    for d in ("png", "pik", "gt"):
        (root / d).mkdir()
    pg = make_page(np.random.default_rng(8), n_lines=3, words_per_line=2)
    Image.fromarray(pg.image).save(root / "png" / "synth_001r_text.png")
    chars = ocr_with_spaces(corrupt_ocr(np.random.default_rng(3),
                                        pg.char_boxes))
    with open(root / "pik" / "synth_001r_boxes.pickle", "wb") as f:
        pickle.dump(chars, f, -1)
    with open(root / "chants.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["h"] * 15)
        row = [""] * 15
        row[2], row[3], row[10], row[14] = "001r", "1", "1", pg.transcript
        w.writerow(row)
    (root / "transcript.txt").write_text(pg.transcript + "\n")
    syl_boxes, _, peaks, _ = process(pg.image, pg.transcript,
                                     existing_ocr=chars, verbose=False,
                                     backend="host", device=CPU)
    ann = ET.Element("annotation")
    for s in to_JSON_dict(syl_boxes, peaks)["syl_boxes"][:6]:
        obj = ET.SubElement(ann, "object")
        ET.SubElement(obj, "name").text = s["syl"]
        ET.SubElement(obj, "difficult").text = "0"
        bb = ET.SubElement(obj, "bndbox")
        for tag, v in (("xmin", s["ul"][0] + 2), ("ymin", s["ul"][1]),
                       ("xmax", s["lr"][0]), ("ymax", s["lr"][1] - 1)):
            ET.SubElement(bb, tag).text = str(v)
    ET.ElementTree(ann).write(root / "gt" / "synth_001r_gt.xml")
    d = init_params_np(np.random.default_rng(0), 48, 16, len(Codec()))
    d["W2"] *= 20.0
    save_pyrnn(str(root / "m.pyrnn.gz"), d, Codec())
    return root, pg


def test_rodan_default_backend_is_the_jax_packages(assets, tmp_path):
    """Both task bodies default to backend="device"; on the CPU they write
    the same bytes."""
    import inspect

    for mod in (rodan_job, jax_rodan):
        assert inspect.signature(mod.run_task).parameters[
            "backend"].default == "device"
    assert inspect.signature(process_batch).parameters[
        "backend"].default == "device"
    root, _ = assets
    inputs = {"Transcript": [{"resource_path": str(root / "transcript.txt")}],
              "Text Layer": [{"resource_path": str(
                  root / "png" / "synth_001r_text.png")}]}
    settings = {"OCR Model": str(root / "m.pyrnn.gz")}
    outs = {}
    for tag, mod, extra in (("port", rodan_job, {"device": CPU}),
                            ("jax", jax_rodan, {})):
        out = tmp_path / f"{tag}.json"
        assert mod.run_task(inputs, settings,
                            {"JSON": [{"resource_path": str(out)}]}, **extra)
        outs[tag] = out.read_bytes()
    assert outs["port"] == outs["jax"]


# the least arguments of each subcommand with a --backend option
SUBCOMMANDS = {
    "align": ["align", "--csv", "c", "--manuscript", "m", "--model", "x",
              "--folios", "1"],
    "evaluate": ["evaluate", "--csv", "c", "--manuscript", "m", "--folios",
                 "1"],
    "verify-reference": ["verify-reference", "--assets", "a"],
    "mei": ["mei", "--transcript", "t", "--image", "i", "--mei", "m",
            "--out", "o"],
    "lines": ["lines", "p.png"],
    "gtedit html": ["gtedit", "html", "--lines-dir", "d"],
    "serve": ["serve", "--spool", "s"],
}


def _parsed_backend(mod, argv, monkeypatch):
    """The backend a CLI's parser gives ``argv`` (its command not run)."""
    seen = []
    for name in dir(mod):
        if name.startswith("cmd_"):
            monkeypatch.setattr(mod, name,
                                lambda args: seen.append(args.backend) or 0)
    assert mod.main(argv) == 0
    return seen[0]


@pytest.mark.parametrize("name", sorted(SUBCOMMANDS))
def test_cli_backend_option_matches_jax(name, monkeypatch):
    from text_alignment_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "ensure_compile_cache", lambda: None)
    argv = SUBCOMMANDS[name]
    assert _parsed_backend(cli, argv, monkeypatch) == _parsed_backend(
        jax_cli, argv, monkeypatch)
    for backend in ("host", "hybrid", "device"):
        assert _parsed_backend(cli, argv + ["--backend", backend],
                               monkeypatch) == backend
    with pytest.raises(SystemExit):
        cli.main(argv + ["--backend", "xla"])


def _align_args(root, out, backend, *extra):
    return ["align", "--csv", str(root / "chants.csv"), "--manuscript",
            "synth", "--model", str(root / "m.pyrnn.gz"), "--png-dir",
            str(root / "png"), "--out-json", str(out), "--folios", "001r",
            "--backend", backend, "--device", CPU, *extra]


@pytest.mark.parametrize("extra", [[], ["--batch", "2"]])
def test_cli_align_device_backend(assets, tmp_path, extra):
    """align --backend device (sequential and batched, the OCR pickle
    reused) writes the hybrid run's bytes."""
    root, _ = assets
    for b in ("device", "hybrid"):
        pik = tmp_path / f"pik_{b}"  # align writes the pickle back
        shutil.copytree(root / "pik", pik)
        assert cli.main(_align_args(root, tmp_path / b, b, "--pickle-dir",
                                    str(pik), "--reuse-ocr", *extra)) == 0
    got = (tmp_path / "device" / "synth_001r.json").read_bytes()
    assert got == (tmp_path / "hybrid" / "synth_001r.json").read_bytes()
    assert json.loads(got)["syl_boxes"]


def test_cli_evaluate_device_backend(assets, capsys):
    root, _ = assets
    outs = []
    for b in ("device", "host"):
        assert cli.main(["evaluate", "--csv", str(root / "chants.csv"),
                         "--manuscript", "synth", "--png-dir",
                         str(root / "png"), "--pickle-dir", str(root / "pik"),
                         "--gt-dir", str(root / "gt"), "--folios", "001r",
                         "--backend", b, "--device", CPU]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "mean: bbox IoU" in outs[0]


def test_grid_search_device_backend_matches_host(assets):
    root, pg = assets
    with open(root / "pik" / "synth_001r_boxes.pickle", "rb") as f:
        chars = pickle.load(f)
    gt = parse_gt_xml(str(root / "gt" / "synth_001r_gt.xml"))
    fx = [{"raw_image": pg.image, "transcript": pg.transcript,
           "gt_boxes": gt, "existing_ocr": chars}]
    rows = [[8, -4, -7, -7, -3, 0], [5, -4, -2, -2, 0, 0]]
    got = {b: grid_search(fx, shuffle=False, backend=b, verbose=False,
                          params_list=rows, device=CPU)
           for b in ("device", "host")}
    assert got["device"] == got["host"]
    assert len(got["host"][0]) == 2 and max(got["host"][0].values()) > 0


def test_cli_lines_device_backend(assets, tmp_path):
    root, _ = assets
    page_png = str(root / "png" / "synth_001r_text.png")
    for b in ("device", "host"):
        assert cli.main(["lines", page_png, "--out-dir", str(tmp_path / b),
                         "--backend", b, "--filter-size", "8",
                         "--device", CPU]) == 0
    names = sorted(os.listdir(tmp_path / "host"))
    assert names and names == sorted(os.listdir(tmp_path / "device"))
    for n in names:
        assert (tmp_path / "device" / n).read_bytes() == \
            (tmp_path / "host" / n).read_bytes()


@pytest.mark.parametrize("batch", ["1", "2"])
def test_cli_serve_device_backend(assets, tmp_path, capsys, batch):
    root, pg = assets
    outs = {}
    for b in ("device", "hybrid"):
        spool = tmp_path / b
        spool.mkdir()
        shutil.copy(root / "png" / "synth_001r_text.png", spool / "p.png")
        for name, extra in (("a", {"existing_ocr_pickle": str(
                root / "pik" / "synth_001r_boxes.pickle")}), ("b", {})):
            with open(spool / f"{name}.job.json", "w") as f:
                json.dump({"image": "p.png", "transcript": pg.transcript,
                           **extra}, f)
        assert cli.main(["serve", "--spool", str(spool), "--model",
                         str(root / "m.pyrnn.gz"), "--once", "--batch",
                         batch, "--backend", b, "--device", CPU]) == 0
        assert "processed 2 job(s), 0 failed" in capsys.readouterr().out
        outs[b] = [(spool / f"{n}.json").read_bytes() for n in "ab"]
    assert outs["device"] == outs["hybrid"]
