"""The port needs no JAX and no file of the JAX package: in a fresh
interpreter whose import system refuses ``jax`` and ``jaxlib``,
text_alignment_tpu_torch and its bench import, process() runs a small
synthetic page end to end on the CPU, from a .pyrnn.gz model and through
the device normalizer's plain versions (the full-chain route,
``TEXT_ALIGNMENT_TPU_TAIL=full``), process_batch(backend="device") runs
it on ops/device.py's raster (the CC kernels' plain versions),
process(backend="device")
gives the hybrid JSON (ops/device.py's plain versions), the NW device
path's plain versions align a pair as the host fill does, diagnose_alignment
classifies the page's syllables, the end-to-end example's perfect-OCR rung
aligns its held-out page, serve drains a spool, the
Rodan task body, verify_reference and the MEI merge run, a stage cache the
JAX package wrote yields misses, a training step runs and the CLI's
``lines``, ``gtedit`` and ``train`` (with a resume) turn a page into a
checkpoint, a one-rank gloo mesh runs the sharded train step and the
sharded grid, and no loaded module's file lies under
``text_alignment_tpu/``."""

import os
import subprocess
import sys
import textwrap

_SCRIPT = textwrap.dedent("""
    import sys

    class _BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("blocked jax: " + name)
            return None

    sys.meta_path.insert(0, _BlockJax())

    import json
    import os
    import tempfile

    import numpy as np
    import torch

    torch.set_num_threads(1)
    os.environ["TEXT_ALIGNMENT_TPU_TAIL"] = "full"

    import text_alignment_tpu_torch
    from text_alignment_tpu_torch import bench, cli, evaluate  # noqa: F401
    from text_alignment_tpu_torch.align import nw_kernel  # noqa: F401
    from text_alignment_tpu_torch.align import align_grid, perform_alignment
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.lstm import (
        init_params_np, params_from_np)
    from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
    from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
    from text_alignment_tpu_torch.parallel import process_batch
    from text_alignment_tpu_torch.pipeline import process, to_JSON_dict
    from text_alignment_tpu_torch.synth import make_page
    from text_alignment_tpu_torch.models import lineest as tle

    full_calls = []
    _center_full = tle.center_full

    def _counted(*args):
        full_calls.append(1)
        return _center_full(*args)

    tle.center_full = _counted
    page = make_page(np.random.default_rng(3), n_lines=2, words_per_line=2,
                     H=300, W=400, char_h=30, char_w=18, gap=4, space_w=24,
                     line_spacing=110, speckles=5)
    d = init_params_np(np.random.default_rng(0), 48, 16, len(Codec()))
    d["W2"] *= 20.0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.pyrnn.gz")
        save_pyrnn(path, d, Codec())
        rec_out = process(page.image, page.transcript, ocropus_model=path,
                          backend="hybrid", verbose=False, device="cpu")
    rec = SeqRecognizer(params_from_np(d), Codec(),
                        normalize_on_device=True, device="cpu")
    dev_out = process(page.image, page.transcript, ocropus_model=rec,
                      backend="hybrid", verbose=False, device="cpu")
    batch = process_batch([(page.image, page.transcript)] * 2, rec,
                          backend="device", device="cpu")
    if dev_out is None:
        assert batch == [None, None]
    else:
        want = json.dumps(to_JSON_dict(dev_out[0], dev_out[2]),
                          sort_keys=True)
        for r in batch:
            assert json.dumps(r.json_dict, sort_keys=True) == want
    injected = process(page.image, page.transcript,
                       existing_ocr=page.char_boxes, backend="hybrid",
                       verbose=False, device="cpu")
    js = to_JSON_dict(injected[0], injected[2])
    assert js["syl_boxes"], js
    on_device = process(page.image, page.transcript,
                        existing_ocr=page.char_boxes, backend="device",
                        verbose=False, device="cpu")
    assert to_JSON_dict(on_device[0], on_device[2]) == js

    from text_alignment_tpu_torch.evaluate import diagnose_alignment
    from text_alignment_tpu_torch.examples import end_to_end_synthetic as e2e

    diag = diagnose_alignment(page.transcript, injected[3],
                              e2e.gt_syllable_boxes(page))
    assert diag["counts"]["ok"] >= 1, diag
    held, held_gt = e2e.heldout_page()
    assert e2e.ceiling_rung(held, held_gt, "hybrid", "cpu")[0] == len(held_gt)
    t, o = list(page.transcript), list(page.transcript[::-1])
    assert (perform_alignment(t, o, backend="device", device="cpu")
            == perform_alignment(t, o, backend="host"))
    assert full_calls

    import pickle
    import xml.etree.ElementTree as ET
    from PIL import Image
    from text_alignment_tpu_torch import mei, rodan_job, verify_reference
    from text_alignment_tpu_torch.serve import serve

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.pyrnn.gz")
        save_pyrnn(path, d, Codec())
        for sub in ("spool", "png", "csv", "pik"):
            os.makedirs(os.path.join(tmp, sub))
        png = os.path.join(tmp, "png", "einsiedeln_001r_text.png")
        Image.fromarray(page.image).save(png)
        pik = os.path.join(tmp, "pik", "einsiedeln_001r_boxes.pickle")
        with open(pik, "wb") as f:
            pickle.dump(page.char_boxes, f, -1)
        spool = os.path.join(tmp, "spool")
        jobs = {"a": {"existing_ocr_pickle": pik}, "b": {}}
        for name, extra in jobs.items():
            with open(os.path.join(spool, name + ".job.json"), "w") as f:
                json.dump({"image": png, "transcript": page.transcript,
                           **extra}, f)
        stats = serve(spool, path, once=True, batch=2, device="cpu")
        assert (stats.processed + stats.failed) == 2, stats
        assert os.path.exists(os.path.join(spool, "a.job.done")), stats

        txt = os.path.join(tmp, "t.txt")
        with open(txt, "w") as f:
            f.write(page.transcript)
        rodan_job.run_task(
            {"Transcript": [{"resource_path": txt}],
             "Text Layer": [{"resource_path": png}]},
            {"OCR Model": path},
            {"JSON": [{"resource_path": os.path.join(tmp, "r.json")}]},
            device="cpu")

        with open(os.path.join(tmp, "csv", "einsiedeln.csv"), "w") as f:
            f.write(",".join(["h"] * 15) + "\\n")
            row = [""] * 15
            row[2], row[3], row[10], row[14] = ("001r", "1", "1",
                                                page.transcript)
            f.write(",".join(row) + "\\n")
        rep = verify_reference.verify(tmp, backend="hybrid", verbose=False,
                                      device="cpu")
        assert rep.n_no_reference == 1 and rep.n_error == 0, rep.to_dict()

        cache = os.environ["JAX_WRITTEN_CACHE"]
        before = set(os.listdir(cache))
        process(page.image, page.transcript,
                ocropus_model=os.environ["JAX_CACHE_MODEL"], backend="host",
                verbose=False, device="cpu", stage_cache=cache)
        after = set(os.listdir(cache))
        assert before < after and len(after) == len(before) + 2

    from text_alignment_tpu_torch.models.train import Trainer, batch_lines

    tr = Trainer(Codec(["", "~", " ", "a", "b"]), ni=8, ns=6,
                 device="cpu")
    frames = [np.random.default_rng(k).random((12, 8)).astype(np.float32)
              for k in range(2)]
    loss = tr.step(*batch_lines(frames, ["ab", "b a"], tr.codec, 12, 4))
    assert np.isfinite(loss), loss

    import torch.distributed as dist
    from text_alignment_tpu_torch.parallel import (
        data_model_mesh, make_mesh, sharded_train_demo_step)
    from text_alignment_tpu_torch.parallel import infer_dp  # noqa: F401
    from text_alignment_tpu_torch.parallel.multihost import (
        init_rank, leave_rank)

    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, 1, os.path.join(tmp, "store"), "cpu")
        try:
            assert np.isfinite(sharded_train_demo_step(data_model_mesh(1)))
            grid = [[8, -4, -7, -7, -3, 0], [5, -4, -2, -2, 0, 0]]
            assert (align_grid(t, o, grid, mesh=make_mesh(1))
                    == align_grid(t, o, grid, device="cpu"))
        finally:
            leave_rank()
    assert not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "folio.png")
        Image.fromarray(page.image).save(png)
        lines = os.path.join(tmp, "lines")
        assert cli.main(["lines", png, "--out-dir", lines, "--filter-size",
                         "8", "--device", "cpu"]) == 0
        crops = sorted(f[:-4] for f in os.listdir(lines))
        with open(os.path.join(tmp, "c.tsv"), "w") as f:
            f.writelines(f"{c}\\tdeus in\\n" for c in crops)
        assert cli.main(["gtedit", "extract", os.path.join(tmp, "c.tsv"),
                         "--out-dir", lines, "--device", "cpu"]) == 0
        prefix = os.path.join(tmp, "m")
        train = ["train", "--lines-dir", lines, "--output-prefix", prefix,
                 "--hidden", "6", "--iterations", "1", "--device", "cpu"]
        assert cli.main(train) == 0
        assert cli.main(train + ["--resume", prefix + ".state"]) == 0
        assert os.path.exists(prefix + "-00000002.pyrnn.gz")

    NSM = "http://www.music-encoding.org/ns/mei"
    raw = ('<mei xmlns="%s" meiversion="4.0.0"><surface>'
           '<zone xml:id="z0" ulx="10" uly="10" lrx="40" lry="30"/>'
           '</surface><layer><syllable xml:id="s0"><neume>'
           '<nc facs="z0"/></neume></syllable></layer></mei>' % NSM)
    tree, boxes, _ = mei.add_text_to_mei_file(
        mei.parse_mei(raw), [("al", (10, 50), (40, 70))], 40)
    assert boxes == [[10, 10, 40, 30]]
    assert tree.getroot().find(".//syl").text == "al"
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(text_alignment_tpu_torch.__file__)))
    jax_pkg = os.path.join(root, "text_alignment_tpu") + os.sep
    loaded = [m for m, mod in list(sys.modules.items())
              if (getattr(mod, "__file__", None) or "").startswith(jax_pkg)]
    assert not loaded, loaded
    print("NOJAX_OK", rec_out is None or len(rec_out[0]),
          dev_out is None or len(dev_out[0]), len(js["syl_boxes"]))
""")


def _jax_written_cache(tmp_path):
    """A stage-cache directory written by the JAX package's process() (a
    preprocess and an OCR entry; the OCR entry pickles the JAX package's
    CharBox), for the page the script aligns, and the model it used."""
    import numpy as np

    from text_alignment_tpu.pipeline import process as jax_process
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.lstm import init_params_np
    from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
    from text_alignment_tpu_torch.synth import make_page

    page = make_page(np.random.default_rng(3), n_lines=2, words_per_line=2,
                     H=300, W=400, char_h=30, char_w=18, gap=4, space_w=24,
                     line_spacing=110, speckles=5)
    d = init_params_np(np.random.default_rng(0), 48, 16, len(Codec()))
    d["W2"] *= 20.0
    model = str(tmp_path / "jax_cache_model.pyrnn.gz")
    save_pyrnn(model, d, Codec())
    cache = str(tmp_path / "jax_cache")
    jax_process(page.image, page.transcript, ocropus_model=model,
                backend="host", verbose=False, stage_cache=cache)
    assert len(os.listdir(cache)) == 2
    return cache, model


def test_port_runs_without_jax(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_WRITTEN_CACHE"], env["JAX_CACHE_MODEL"] = _jax_written_cache(
        tmp_path)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK" in proc.stdout
