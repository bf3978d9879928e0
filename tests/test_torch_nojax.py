"""The port needs no JAX and no file of the JAX package: in a fresh
interpreter whose import system refuses ``jax`` and ``jaxlib``,
text_alignment_tpu_torch imports, process() runs a small synthetic page end
to end on the CPU, from a .pyrnn.gz model and through the device
normalizer's plain versions, process_batch runs it with the device raster
(the CC kernels' plain versions), the NW device path's plain versions align
a pair as the host fill does, and no loaded module's file lies under
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
    os.environ["TEXT_ALIGNMENT_TPU_RASTER"] = "device"

    import text_alignment_tpu_torch
    from text_alignment_tpu_torch import cli, evaluate  # noqa: F401
    from text_alignment_tpu_torch.align import nw_kernel  # noqa: F401
    from text_alignment_tpu_torch.align import perform_alignment
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.lstm import (
        init_params_np, params_from_np)
    from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
    from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
    from text_alignment_tpu_torch.parallel import process_batch
    from text_alignment_tpu_torch.pipeline import device_raster
    from text_alignment_tpu_torch.pipeline import process, to_JSON_dict
    from text_alignment_tpu_torch.synth import make_page

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
                          backend="hybrid", device="cpu")
    assert device_raster.fallbacks == 0
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
    t, o = list(page.transcript), list(page.transcript[::-1])
    assert (perform_alignment(t, o, backend="device", device="cpu")
            == perform_alignment(t, o, backend="host"))
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


def test_port_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK" in proc.stdout
