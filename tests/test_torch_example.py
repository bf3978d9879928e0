"""The port's end-to-end example
(``text_alignment_tpu_torch/examples/end_to_end_synthetic.py``) against the
JAX package's (``examples/end_to_end_synthetic.py``, loaded from its path)
on the CPU: the helpers on the example's own pages (``line_texts`` and
``gt_syllable_boxes`` on the training seeds 100-107 and the held-out 999,
``llocs_ceiling_chars`` and ``ceiling_rung`` on 999 with both backends),
``evaluate_checkpoint`` on the same ``.pyrnn.gz`` files (a Trainer(seed=1)
after two steps on the example's first minibatch, and peaky seeded
weights that decode every line to several regions), and one cut run of
the port's ``main``. Everything but the recognizer is integer host work,
so the bar is equality; the recognizer's float roundoff is held to
decode equality, which the equal IoUs and diagnosis show."""

import importlib.util
import os

import numpy as np
import pytest

from text_alignment_tpu_torch.examples import end_to_end_synthetic as port
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lineest_host import normalize_strip
from text_alignment_tpu_torch.models.lstm import init_params_np
from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
from text_alignment_tpu_torch.models.train import Trainer, batch_lines
from text_alignment_tpu_torch.pipeline.preprocess import (
    identify_text_lines, preprocess_images)
from text_alignment_tpu_torch.synth import make_page

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "end_to_end_synthetic.py")
# the example's page specs: (seed, speckles, angle) of the fast recipe's
# training pool, then the held-out page
SPECS = [(100, 0, 0.0), (101, 0, 0.0), (102, 0, 0.0), (103, 0, 0.0),
         (104, 40, 0.6), (105, 40, -0.5), (106, 30, 0.3), (107, 50, 0.8),
         (999, 40, 0.6)]


@pytest.fixture(scope="module")
def jax_example():
    """The JAX example as a module. Loading it may set an environment
    variable of the JAX package's compile cache; the environment is put
    back as it was."""
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location("jax_end_to_end", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


def both_pages(jax_example, seed, speckles, angle):
    kw = dict(speckles=speckles, angle=angle, **port.PAGE_KW)
    return (make_page(np.random.default_rng(seed), **kw),
            jax_example.make_page(np.random.default_rng(seed), **kw))


def boxes(chars):
    return [(c.char, c.ul, c.lr) for c in chars]


@pytest.mark.parametrize("seed,speckles,angle", SPECS)
def test_line_texts_and_gt_boxes_match_jax(jax_example, seed, speckles,
                                           angle):
    page, page_j = both_pages(jax_example, seed, speckles, angle)
    assert np.array_equal(page.image, page_j.image)
    texts = port.line_texts(page)
    assert texts == jax_example.line_texts(page_j)
    assert len(texts) == port.PAGE_KW["n_lines"]
    assert " ".join(texts) == page.transcript
    gt = port.gt_syllable_boxes(page)
    assert gt == jax_example.gt_syllable_boxes(page_j)
    assert "".join(g["syl"] for g in gt) == page.transcript.replace(" ", "")


@pytest.mark.parametrize("backend", ["host", "hybrid"])
def test_ceiling_matches_jax(jax_example, backend):
    page, page_j = both_pages(jax_example, *SPECS[-1])
    image, _, angle = preprocess_images(page.image, backend=backend)
    image_j, _, angle_j = jax_example.preprocess_images(page_j.image,
                                                        backend=backend)
    assert angle == angle_j and angle != 0.0
    chars = port.llocs_ceiling_chars(page, angle, page.image.shape[:2],
                                     image.shape)
    want = jax_example.llocs_ceiling_chars(page_j, angle_j,
                                           page_j.image.shape[:2],
                                           image_j.shape)
    assert boxes(chars) == boxes(want)
    gt = port.gt_syllable_boxes(page)
    got = port.ceiling_rung(page, gt, backend, device="cpu")
    assert got == jax_example.ceiling_rung(page_j, gt, backend)
    assert got[0] == len(gt) and got[2] > 0.5


def test_ceiling_on_the_device_backend():
    """--backend device: the ceiling rung on the device raster (its plain
    versions on the CPU) scores as the hybrid one."""
    page, gt = port.heldout_page()
    got = port.ceiling_rung(page, gt, "device", device="cpu")
    assert got == port.ceiling_rung(page, gt, "hybrid", device="cpu")
    assert got[0] == len(gt)


def first_minibatch():
    """The fast recipe's pool and its first minibatch, as the example
    draws them."""
    frames, texts = [], []
    specs = [(100 + s, 0, 0.0) for s in range(4)] + list(SPECS[4:8])
    for seed, speckles, angle in specs:
        page = make_page(np.random.default_rng(seed), speckles=speckles,
                         angle=angle, **port.PAGE_KW)
        image, eroded, _ = preprocess_images(page.image, backend="hybrid")
        strips, _, _ = identify_text_lines(image, eroded, backend="hybrid")
        for s, t in zip(strips, port.line_texts(page)):
            n = normalize_strip(s.img)
            if n is not None:
                frames.append(n[0])
                texts.append(t)
    T = ((max(f.shape[0] for f in frames) + 127) // 128) * 128
    S = max(len(t) for t in texts) + 8
    b = np.random.default_rng(0).choice(np.arange(len(frames)), size=32,
                                        replace=False)
    codec = Codec()
    return codec, batch_lines([frames[i] for i in b], [texts[i] for i in b],
                              codec, T, S)


def peaky_params(seed=0, ni=48, ns=100, nout=29):
    """Input weights in +-2, recurrent in +-0.3, W2 in +-1 and a blank
    bias of 2: every line decodes to several regions, and no argmax is a
    float tie (tests/test_torch_slice.py's recipe)."""
    rng = np.random.default_rng(seed)
    d = init_params_np(rng, ni, ns, nout, initial_range=0.3)
    for direction in ("fwd", "bwd"):
        for k in ("WGI", "WGF", "WGO", "WCI"):
            d[direction][k][:, 1:1 + ni] *= 2.0 / 0.3
    d["W2"] = rng.uniform(-1, 1, d["W2"].shape).astype(np.float32)
    d["W2"][0, 0] += 2.0
    return d


@pytest.mark.parametrize("model", ["trained", "peaky"])
def test_evaluate_checkpoint_matches_jax(jax_example, tmp_path, model):
    if model == "trained":
        codec, batch = first_minibatch()
        assert batch[0].shape == (32, 512, 48)
        tr = Trainer(codec=codec, lr=3e-3, seed=1, clip_norm=1.0,
                     device="cpu")
        losses = [tr.step(*batch) for _ in range(2)]
        jtr = jax_example.Trainer(codec=jax_example.Codec(), lr=3e-3,
                                  seed=1, clip_norm=1.0)
        want = [jtr.step(*batch) for _ in range(2)]
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert losses[1] < losses[0]
        path = tr.save(str(tmp_path / "synthetic"))
    else:
        path = str(tmp_path / "peaky.pyrnn.gz")
        save_pyrnn(path, peaky_params(), Codec())
    page, page_j = both_pages(jax_example, *SPECS[-1])
    gt = port.gt_syllable_boxes(page)
    got = port.evaluate_checkpoint(path, page, gt, "hybrid", "region",
                                   device="cpu")
    want = jax_example.evaluate_checkpoint(path, page_j, gt, "hybrid",
                                           "region")
    assert got == want
    if model == "peaky":
        n_pred, _, _, diag = got
        assert n_pred > 0 and sum(diag["counts"].values()) == len(gt)


def test_main_cut_run(monkeypatch, capsys):
    """The port's main on the CPU at a cut size: one clean page, two
    full-batch steps, no ladder. The structure of run()'s result and
    main's exit code, not the PASS gate."""
    results = []
    run = port.run
    monkeypatch.setattr(port, "run",
                        lambda args: results.append(run(args)) or results[0])
    rc = port.main(["--recipe", "gradual", "--train-pages", "1", "--iters",
                    "2", "--no-ladder", "--device", "cpu"])
    out, = results
    assert rc == (0 if out["ok"] else 1)
    assert ("PASS" if out["ok"] else "FAIL") in capsys.readouterr().out
    assert out["device"] == "cpu"
    assert out["lines"] == out["B"] == 8 and out["T"] == 512
    assert out["steps"] == 2 and len(out["step_ms"]) == 2
    assert np.isfinite(out["final_loss"]) and out["train_s"] > 0
    assert out["n_gt"] == len(port.gt_syllable_boxes(port.heldout_page()[0]))
    assert out["ceiling"] is None and len(out["rows"]) == 1
    row = out["rows"][0]
    assert set(row) == {"save_loss", "path", "n_pred", "iou", "ink_iou",
                        "diag"}
    assert row["path"].endswith("-00000002.pyrnn.gz")
    assert row["save_loss"] == out["final_loss"]
    assert out["ok"] == (row["n_pred"] >= 0.8 * out["n_gt"]
                         and row["ink_iou"] > 0.50)
