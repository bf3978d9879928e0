"""kraken's default network under training on the port (``models/vgsl.py``
``VGSLModel``, ``models/train.py`` ``VGSLTrainer``, ``train --network
kraken``) on the CPU at reduced widths (height 24, convolutions of 4-8
channels, 12 units): the loss and every gradient of a padded batch against
the benchmark's plain reference (``benchmark/reference/vgsl_train.py``,
each line alone with its slice of the step's masks), the dropout sites and
their semantics, one Adam step by hand, exact resume, the trained weights
through ``SeqRecognizer``, the spans and counters, and the CLI.

Tolerances against the reference: 1e-5 of the summed loss, 2e-4 of a
tensor's largest gradient. The two sum in other orders (cuDNN's or the
CPU's LSTM and ``F.ctc_loss`` against a per-frame cell loop and the CTC
alpha recursion; PyTorch's CTC gradient adds exp(log p), which the
log-softmax's backward takes out again) and float32 order differences of
~1e-7 grow through the recurrences' backward; a mask, a gate or a length
out of place moves a gradient by more than 1e-2 of its largest."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import vgsl_train as ref
from text_alignment_tpu_torch.models import vgsl
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch.models.train import (
    Trainer, VGSLTrainer, batch_lines, ctc_infeasible)

torch.set_num_threads(1)
LOSS_TOL, GRAD_TOL = 1e-5, 2e-4
SMALL = dict(height=24, convs=((3, 5, 4), (3, 5, 4), (3, 3, 8), (3, 3, 8)),
             hidden=12)
CODEC = Codec()
TEXTS = ["deus in", "ave", "gloria maria", "aa"]


def small_params(seed):
    return vgsl.params_from_np(vgsl.init_params_np(
        np.random.default_rng(seed), len(CODEC), **SMALL))


def trainer(seed=3, **kw):
    return VGSLTrainer(CODEC, small_params(seed), seed=5, device="cpu",
                       height=24, **kw)


def batch(seed=1, widths=(130, 77, 40, 64), texts=TEXTS, T=136):
    """A padded batch of lines of the given widths: ink-like 0/1 frames."""
    g = np.random.default_rng(seed)
    frames = [(g.random((w, 24)) < 0.3).astype(np.float32) for w in widths]
    return batch_lines(frames, list(texts), CODEC, T=T, S=14)


class Tap:
    """Every mask ``vgsl.dropout_mask`` draws while installed, or the
    masks ``replace`` returns in their place."""

    def __init__(self, monkeypatch, replace=None):
        self.masks = []
        orig = vgsl.dropout_mask

        def tapped(shape, p, generator, device):
            m = orig(shape, p, generator, device)
            if replace is not None:
                m = replace(len(self.masks), m)
            self.masks.append(m.clone())
            return m

        monkeypatch.setattr(vgsl, "dropout_mask", tapped)


def as_dict(p):
    """``VGSLParams`` in the reference's dict layout."""
    return {"conv": list(p.conv),
            "lstm": [{d: {k: getattr(getattr(layer, d), k) for k in ref.KEYS}
                      for d in ("fwd", "bwd")} for layer in p.lstm],
            "W": p.W, "b": p.b}


def ref_lines(xs, xl, lb, ll, masks):
    out = []
    for b in range(len(xl)):
        n = int(xl[b]) // 8
        out.append({"x": xs[b, :xl[b]], "labels": lb[b, :ll[b]],
                    "masks": [m[b, :, 0, 0] for m in masks[:4]]
                    + [masks[4][b, 0], masks[5][b, 0], masks[6][b, :n]]})
    return out


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_step_loss_and_gradients_equal_the_reference_line_by_line(
        monkeypatch, seed):
    tap = Tap(monkeypatch)
    tr = trainer(seed)
    w0 = tr.params
    xs, xl, lb, ll = batch(seed)
    loss = tr.step(xs, xl, lb, ll)
    want, grads, zeroed = ref.step(as_dict(w0),
                                   ref_lines(xs, xl, lb, ll, tap.masks))
    assert zeroed == 1 == tr.counters["ctc_zeroed"]   # "gloria maria"
    assert abs(loss - want) <= LOSS_TOL * max(1.0, abs(want))
    got = vgsl.leaves(tr.grads)
    assert len(got) == 34
    for a, b in zip(got, ref.leaves(grads)):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(
            b.abs().max())
    # a mask out of place is seen: the reference without the last site's
    masks = tap.masks[:6] + [torch.ones_like(tap.masks[6])]
    _, off, _ = ref.step(as_dict(w0), ref_lines(xs, xl, lb, ll, masks))
    assert max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, ref.leaves(off))) > 1e-2


def test_dropout_sites_and_their_semantics(monkeypatch):
    """Seven sites in the spec's order: a whole channel of a line after
    each convolution (B, C, 1, 1) and after LSTM layers 1 and 2 (B, 1,
    2 ns), each value after layer 3 (B, T // 8, 2 ns); values 0 or
    1 / (1 - p); masks of ones are the eval forward; and a line's masks
    reach that line alone."""
    tap = Tap(monkeypatch)
    tr = trainer()
    xs, xl, lb, ll = batch()
    tr.step(xs, xl, lb, ll)
    B, T, F = 4, 136, 24
    assert [tuple(m.shape) for m in tap.masks] == (
        [(B, 4, 1, 1), (B, 4, 1, 1), (B, 8, 1, 1), (B, 8, 1, 1),
         (B, 1, F), (B, 1, F), (B, T // 8, F)])
    for m, (p, _) in zip(tap.masks, vgsl.DROPOUT):
        keep = torch.tensor(1.0 / (1.0 - p))      # in float32
        assert bool(((m == 0) | (m == keep)).all())
        assert 0 < int((m == 0).sum()) < m.numel() or m.numel() < 40
    assert vgsl.DROPOUT == ((0.1, 2),) * 6 + ((0.5, 1),)
    g = torch.Generator().manual_seed(0)
    m = vgsl.dropout_mask((200_000,), 0.1, g, "cpu")
    assert float((m == 0).float().mean()) == pytest.approx(0.1, abs=0.003)
    assert float(m.mean()) == pytest.approx(1.0, abs=0.005)

    model = tr.model
    frames = torch.from_numpy(xs)
    widths = torch.from_numpy(xl.astype(np.int64))
    counts = widths // 8
    with torch.no_grad():
        evald = model(frames, widths, counts)
        monkeypatch.setattr(vgsl, "dropout_mask",
                            lambda shape, p, g, d: torch.ones(shape))
        ones = model(frames, widths, counts, torch.Generator())

        def one_channel(shape, p, g, d):
            m = torch.ones(shape)
            if len(shape) == 4:
                m[0, 1] = 0.0          # line 0's channel 1 at each conv
            return m

        monkeypatch.setattr(vgsl, "dropout_mask", one_channel)
        cut = model(frames, widths, counts, torch.Generator())
    for b, n in enumerate(counts.tolist()):
        assert torch.equal(ones[b, :n], evald[b, :n])
        assert torch.equal(cut[b, :n], evald[b, :n]) == (b != 0)


def test_one_adam_step_by_hand():
    """Adam's first step, bias-corrected: w - lr g / (|g| + eps)."""
    tr = trainer(lr=1e-3)
    w0 = vgsl.leaves(tr.params)
    tr.step(*batch())
    g = vgsl.leaves(tr.grads)
    for a, w, d in zip(vgsl.leaves(tr.params), w0, g):
        m, v = 0.1 * d, 0.001 * d * d
        want = w - 1e-3 * (m / 0.1) / ((v / 0.001).sqrt() + 1e-8)
        torch.testing.assert_close(a, want, atol=1e-7, rtol=1e-6)
    assert tr.optimizer.defaults["weight_decay"] == 0.0
    assert tr.optimizer.defaults["betas"] == (0.9, 0.999)


def test_save_state_then_load_state_resumes_bit_exactly(tmp_path):
    steps = [batch(s) for s in (1, 2, 3)]
    a = trainer()
    for b in steps:
        a.step(*b)
    c = trainer()
    for b in steps[:2]:
        c.step(*b)
    path = c.save_state(str(tmp_path / "m.state"), extra={"k": 1})
    with np.load(path, allow_pickle=False) as z:
        assert sum(k.startswith("arr_") for k in z.files) == 1 + 3 * 34
        assert "O1c29" in str(z["config"]) and "Lbx12" in str(z["config"])
    d = VGSLTrainer.load_state(path, device="cpu")
    assert d.iteration == 2 and d.loaded_extra == {"k": 1}
    d.step(*steps[2])
    for x, y in zip(vgsl.leaves(a.params), vgsl.leaves(d.params)):
        assert torch.equal(x, y)
    assert d.counters == a.counters == {"steps": 3, "lines": 12,
                                        "frames": 3 * (16 + 9 + 5 + 8),
                                        "ctc_zeroed": 3}
    with pytest.raises(ValueError):
        Trainer.load_state(path, device="cpu")
    ocropy = Trainer(CODEC, ns=8, device="cpu").save_state(
        str(tmp_path / "o.state"))
    with pytest.raises((ValueError, KeyError)):
        VGSLTrainer.load_state(ocropy, device="cpu")


def test_trained_weights_run_through_the_recognizer(tmp_path):
    from text_alignment_tpu_torch.models import recognizer
    from text_alignment_tpu_torch.pipeline.process import (
        _resolve_recognizer)

    tr = trainer()
    tr.step(*batch())
    path = tr.save(str(tmp_path / "m"))
    assert path.endswith("-00000001.vgsl.npz")
    rec = SeqRecognizer.from_vgsl(path, device="cpu")
    assert rec.target_height == 24 and rec.decode == "bestpath"
    assert rec.codec.charset == CODEC.charset
    xs, xl, _, _ = batch(4)
    frames = torch.from_numpy(xs)
    widths = torch.from_numpy(xl.astype(np.int64))
    post, n = recognizer.vgsl_forward_batched(rec.params, frames, widths)
    with torch.no_grad():
        logp = tr.model(frames, widths, widths // 8)
    for b, k in enumerate(n.tolist()):
        torch.testing.assert_close(post[b, :k], logp[b, :k].exp(),
                                   atol=2e-5, rtol=0)
    loaded = _resolve_recognizer(path, "hybrid", torch.device("cpu"))
    assert isinstance(loaded.params, vgsl.VGSLNet)


def test_leaves_spec_and_the_counters():
    p = vgsl.params_from_np(vgsl.init_params_np(np.random.default_rng(0),
                                                29))
    assert vgsl.spec_of(p, 120) == vgsl.SPEC + " O1c29"
    back = vgsl.from_leaves(vgsl.leaves(p))
    assert all(torch.equal(a, b) for a, b in zip(vgsl.leaves(back),
                                                 vgsl.leaves(p)))
    # frames against the label and its repeats: "aa" needs 3
    labels = np.array([[3, 3, 0], [3, 4, 0], [3, 3, 3]])
    assert ctc_infeasible([3, 2, 4], labels, [2, 2, 3]) == 1
    assert ctc_infeasible([2, 2, 5], labels, [2, 2, 3]) == 1
    with pytest.raises(ValueError):
        trainer().step(*batch(widths=(130, 7), texts=("a", "b")))


def test_step_spans_in_their_order(monkeypatch):
    tr = trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(*batch())
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith("ta.train."))
    assert [n for _, n in spans] == ["ta.train.forward", "ta.train.loss",
                                     "ta.train.backward", "ta.train.update"]


@pytest.fixture(scope="module")
def lines_dir(tmp_path_factory):
    """Two line crops with ground truth, as ``lines`` and ``gtedit
    extract`` leave them (the page's third crop has none, so ``train``
    takes two pairs)."""
    from text_alignment_tpu_torch import gtedit
    from text_alignment_tpu_torch.pipeline.preprocess import PreprocParams
    from text_alignment_tpu_torch.synth import make_page

    d = tmp_path_factory.mktemp("kraken_lines")
    page = make_page(np.random.default_rng(5), n_lines=3, words_per_line=2,
                     H=420, W=420, char_h=30, char_w=18, gap=4, space_w=24,
                     line_spacing=110)
    paths = gtedit.extract_lines(page.image, str(d), "p", backend="host",
                                 preproc_params=PreprocParams(filter_size=8))
    assert len(paths) == 3
    for i, text in enumerate(["deus in", "ave"]):
        (d / f"p_{i:04d}.gt.txt").write_text(text + "\n")
    return d


def test_cli_trains_kraken_and_resumes(lines_dir, tmp_path):
    from text_alignment_tpu_torch.cli import main

    def argv(prefix, n, *extra):
        return ["train", "--network", "kraken", "--lines-dir",
                str(lines_dir), "--output-prefix", str(prefix),
                "--iterations", str(n), "--batch-size", "2", "--log-every",
                "1", "--save-every", "0", "--device", "cpu", *extra]

    assert main(argv(tmp_path / "a" / "m", 2)) == 0
    rec = SeqRecognizer.from_vgsl(str(tmp_path / "a" / "m-00000002.vgsl.npz"),
                                  device="cpu")
    assert rec.target_height == vgsl.HEIGHT
    assert [tuple(w.shape[1:]) for w, _ in rec.params.conv] == [
        (1, 3, 13), (32, 3, 13), (32, 3, 9), (64, 3, 9)]
    assert set("deus inave") <= set(rec.codec.charset)
    assert main(argv(tmp_path / "a" / "m", 1, "--resume",
                     str(tmp_path / "a" / "m.state"))) == 0
    assert (tmp_path / "a" / "m-00000003.vgsl.npz").exists()
