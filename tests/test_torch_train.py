"""Training on the port (``models/train.py``, ``models/ctc.ctc_loss``,
``models/lstm.bilstm_logits``, the CLI's ``train``) against the JAX
package's trainer on the CPU, on the same inputs made from numpy seeds.

Tolerances: ``ctc_loss`` and its logit gradients agree with
``optax.ctc_loss`` to 1e-5 relative (of the loss; of the largest gradient
element), including an empty label and an infeasible line; the training
logits agree with ``train.bilstm_logits`` to 1e-5 absolute and every
weight's gradient with ``jax.grad``'s to 1e-4 times the global norm; one
``Trainer.step`` gives the loss to 1e-5 relative and the weights to 1e-5
absolute wherever the gradient's magnitude exceeds 1e-6 (Adam's first
step is lr times the gradient's sign, which is noise where the gradient
is near 0); a JAX ``.state`` continued in both packages gives losses to
1e-4 relative. The port's own resume is bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_alignment_tpu.models import train as jax_train
from text_alignment_tpu.models.codec import Codec as JaxCodec
from text_alignment_tpu.models.ctc import ctc_loss as jax_ctc_loss
from text_alignment_tpu.models.lstm_jax import init_bilstm
from text_alignment_tpu.models.lstm_jax import params_to_np as jax_to_np
from text_alignment_tpu.models.pyrnn import load_pyrnn as jax_load_pyrnn
from text_alignment_tpu_torch.models import lstm as tl
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.ctc import ctc_loss
from text_alignment_tpu_torch.models.lstm_np import bilstm_forward_np
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
from text_alignment_tpu_torch.models.train import Trainer, batch_lines

torch.set_num_threads(1)

CHARSET = ["", "~", " ", "a", "b", "c"]


def _ctc_case():
    """B = 4, T = 32, C = 8: a repeated label, an empty label, an
    infeasible line (5 frames for 9 labels) and a full one."""
    rng = np.random.default_rng(0)
    B, T, C, S = 4, 32, 8, 12
    logits = rng.normal(0, 2, (B, T, C)).astype(np.float32)
    xl = np.array([32, 20, 5, 30], np.int32)
    labels = rng.integers(1, C, (B, S)).astype(np.int32)
    labels[0, 3] = labels[0, 2]
    ll = np.array([6, 0, 9, 12], np.int32)
    for b in range(B):
        labels[b, ll[b]:] = 0
    return logits, xl, labels, ll


def test_ctc_loss_matches_optax():
    logits, xl, labels, ll = _ctc_case()
    want, want_g = jax.value_and_grad(
        lambda x: jax_ctc_loss(x, jnp.asarray(xl), jnp.asarray(labels),
                               jnp.asarray(ll)))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = ctc_loss(x, torch.tensor(xl), torch.tensor(labels),
                   torch.tensor(ll))
    got.backward()
    assert np.isfinite(got.item()) and got.item() > 1e4  # the infeasible
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    want_g = np.asarray(want_g)
    assert np.abs(x.grad.numpy() - want_g).max() <= \
        1e-5 * np.abs(want_g).max()


def test_logits_and_gradients_match_jax():
    ni, ns, B, T, nout = 8, 6, 3, 17, len(CHARSET)
    rng = np.random.default_rng(1)
    d = jax_to_np(init_bilstm(jax.random.PRNGKey(1), ni, ns, nout))
    xs = rng.random((B, T, ni)).astype(np.float32)
    lens = np.array([17, 11, 5], np.int32)
    proj = rng.normal(0, 1, (B, T, nout)).astype(np.float32)

    jp = jax.tree_util.tree_map(jnp.asarray, init_bilstm(
        jax.random.PRNGKey(1), ni, ns, nout))

    def jax_fn(p):
        logits = jax_train.bilstm_logits(p, jnp.asarray(xs),
                                         jnp.asarray(lens))
        return jnp.sum(logits * proj), logits

    (_, want), want_g = jax.value_and_grad(jax_fn, has_aux=True)(jp)
    want_g = tl.params_leaves(tl.params_from_np(jax_to_np(want_g)))

    model = tl.BiLSTM(tl.params_from_jax(d))
    got = model(torch.from_numpy(xs), torch.from_numpy(lens))
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    norm = float(torch.sqrt(sum((g * g).sum() for g in want_g)))
    for p, g in zip(model.parameters(), want_g):
        assert (p.grad - g).abs().max().item() <= 1e-4 * norm


def test_logits_match_numpy_oracle():
    """The training forward, softmaxed, is the ocropy recognizer
    (lstm_np) line by line, padding excluded."""
    ni, ns, B, T, nout = 8, 6, 3, 17, len(CHARSET)
    rng = np.random.default_rng(2)
    d = tl.init_params_np(rng, ni, ns, nout, initial_range=0.5)
    xs = rng.random((B, T, ni)).astype(np.float32)
    lens = np.array([17, 9, 4], np.int32)
    post = torch.softmax(tl.bilstm_logits(
        tl.params_from_np(d), torch.from_numpy(xs), torch.from_numpy(lens)),
        dim=-1).detach().numpy()
    for b in range(B):
        want = bilstm_forward_np(d, xs[b, :lens[b]])
        np.testing.assert_allclose(post[b, :lens[b]], want, atol=1e-5)


def _step_batch(ni):
    rng = np.random.default_rng(3)
    B, T = 3, 17
    xs = rng.random((B, T, ni)).astype(np.float32)
    xs[:, 5:7] = 0.0  # empty frames for the grounding term
    xl = np.array([17, 12, 9], np.int32)
    lb = rng.integers(1, len(CHARSET), (B, 5)).astype(np.int32)
    ll = np.array([5, 3, 0], np.int32)
    for b in range(B):
        lb[b, ll[b]:] = 0
    return xs, xl, lb, ll


def _leaves(params):
    return [t.numpy() for t in tl.params_leaves(params)]


@pytest.mark.parametrize("seed,ni,ns,nout", [
    (0, 48, 100, 29), (1, 48, 100, 29), (7, 8, 6, 6), (2**31 - 1, 48, 256, 40)])
def test_seeded_weights_are_the_jax_trainers(seed, ni, ns, nout):
    """init_params_seeded (numpy's Threefry) draws init_bilstm's weights
    for PRNGKey(seed) bit for bit: both trainers start from the same
    weights for a seed."""
    want = tl.params_leaves(tl.params_from_jax(jax_to_np(
        init_bilstm(jax.random.PRNGKey(seed), ni, ns, nout))))
    got = tl.params_leaves(tl.params_from_np(
        tl.init_params_seeded(seed, ni, ns, nout)))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _twins(ni, ns, **kw):
    """A JAX trainer and a port trainer of the same fields, hence the same
    weights."""
    jt = jax_train.Trainer(JaxCodec(CHARSET), ni=ni, ns=ns, **kw)
    tt = Trainer(Codec(CHARSET), ni=ni, ns=ns, device="cpu", **kw)
    for a, b in zip(_leaves(tt.params),
                    _leaves(tl.params_from_jax(jax_to_np(jt.params)))):
        np.testing.assert_array_equal(a, b)
    return jt, tt


@pytest.mark.parametrize("clip_norm,gw", [(1.0, 0.0), (None, 0.0),
                                          (1.0, 0.5)])
def test_trainer_step_matches_jax(clip_norm, gw):
    ni, ns = 8, 6
    jt, tt = _twins(ni, ns, lr=1e-3, clip_norm=clip_norm, ground_weight=gw)
    batch = _step_batch(ni)
    # the unclipped gradient, for the mask of elements whose sign is not
    # noise
    probe = Trainer(Codec(CHARSET), ni=ni, ns=ns, device="cpu")
    probe.model.load_state_dict(tt.model.state_dict())
    args = probe.tensors(*batch)
    probe.loss(*args, gw).backward()
    grads = [p.grad.numpy() for p in probe.model.parameters()]

    want = jt.step(*batch)
    got = tt.step(*batch)
    assert abs(got - want) <= 1e-5 * abs(want)
    for a, b, g in zip(_leaves(tt.params),
                       _leaves(tl.params_from_jax(jax_to_np(jt.params))),
                       grads):
        sure = np.abs(g) > 1e-6
        assert sure.any() or a.size < 8
        np.testing.assert_allclose(a[sure], b[sure], rtol=0, atol=1e-5)


def test_jax_state_continues_in_the_port(tmp_path):
    """A JAX .state after 3 steps continues in the port as in JAX (losses
    to 1e-4 relative over 3 more steps), and the port's .state continues
    in JAX the same way."""
    ni, ns = 8, 6
    batch = _step_batch(ni)
    jt = jax_train.Trainer(JaxCodec(CHARSET), ni=ni, ns=ns, lr=3e-3, seed=4)
    for _ in range(3):
        jt.step(*batch)
    path = jt.save_state(str(tmp_path / "jax.state"))
    with np.load(path, allow_pickle=False) as z:
        assert len([k for k in z.files if k.startswith("arr_")]) == 46
        assert int(z["arr_000"]) == 3
    tt = Trainer.from_jax_state(path, device="cpu")
    assert tt.iteration == 3 and tt.codec.charset == CHARSET
    for a, b in zip(_leaves(tt.params),
                    _leaves(tl.params_from_jax(jax_to_np(jt.params)))):
        np.testing.assert_array_equal(a, b)

    port_path = tt.save_state(str(tmp_path / "port.state"))
    want = [jt.step(*batch) for _ in range(3)]
    got = [tt.step(*batch) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    back = jax_train.Trainer.load_state(port_path)
    assert back.iteration == 3
    np.testing.assert_allclose([back.step(*batch) for _ in range(3)], want,
                               rtol=1e-4)


def test_trainer_full_state_resume_exact(tmp_path):
    """save_state/load_state resume the trajectory bit-exactly (params and
    Adam's moments survive, unlike the weights-only .pyrnn)."""
    rng = np.random.default_rng(7)
    codec = Codec()
    xs = rng.random((4, 64, 48)).astype(np.float32)
    xlens = np.full(4, 50, np.int32)
    labels = rng.integers(1, len(codec), (4, 10)).astype(np.int32)
    llens = np.full(4, 8, np.int32)

    tr = Trainer(codec=codec, ns=20, lr=3e-3, seed=5, device="cpu")
    for _ in range(3):
        tr.step(xs, xlens, labels, llens)
    path = tr.save_state(str(tmp_path / "t.state"),
                         extra={"batch_size": 16})
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"  # a pickle-free npz

    gen = np.random.default_rng(9)
    gen.integers(0, 10, 5)
    path_rng = tr.save_state(str(tmp_path / "r.state"),
                             extra={"rng_state": gen.bit_generator.state})
    gen2 = np.random.default_rng(0)
    gen2.bit_generator.state = Trainer.load_state(
        path_rng, device="cpu").loaded_extra["rng_state"]
    assert np.array_equal(gen.integers(0, 99, 8), gen2.integers(0, 99, 8))

    loss_direct = [tr.step(xs, xlens, labels, llens) for _ in range(2)]
    tr2 = Trainer.load_state(path, device="cpu")
    assert tr2.iteration == 3
    assert tr2.codec.charset == codec.charset
    assert tr2.loaded_extra == {"batch_size": 16}
    loss_resumed = [tr2.step(xs, xlens, labels, llens) for _ in range(2)]
    assert loss_direct == loss_resumed
    for a, b in zip(_leaves(tr.params), _leaves(tr2.params)):
        np.testing.assert_array_equal(a, b)


def test_trainer_checkpoint_roundtrip(tmp_path):
    """The iteration-stamped .pyrnn.gz loads in the port's recognizer and
    in the JAX package's load_pyrnn to the trained arrays."""
    codec = Codec(["", "~", " ", "a"])
    tr = Trainer(codec, ni=8, ns=6, seed=3, device="cpu")
    tr.iteration = 777
    path = tr.save(str(tmp_path / "synth"))
    assert path.endswith("-00000777.pyrnn.gz")
    rec = SeqRecognizer.from_pyrnn(path, device="cpu")
    assert rec.codec == codec
    want = tl.params_to_np(tr.params)
    got = tl.params_to_np(rec.params)
    jax_d, jax_codec, _ = jax_load_pyrnn(path)
    assert list(jax_codec.charset) == codec.charset
    for part in ("fwd", "bwd"):
        for k in want[part]:
            np.testing.assert_array_equal(want[part][k], got[part][k])
            np.testing.assert_array_equal(want[part][k], jax_d[part][k])
    np.testing.assert_array_equal(want["W2"], jax_d["W2"])


def test_training_loss_decreases():
    rng = np.random.default_rng(7)
    codec = Codec(CHARSET)
    tr = Trainer(codec, ni=16, ns=16, lr=5e-3, seed=1, device="cpu")
    frames, texts = [], []
    for _ in range(8):
        f = np.zeros((30, 16), np.float32)
        f[2:8, 2:6] = 1.0
        f[12:18, 6:10] = 1.0
        f[22:28, 10:14] = 1.0
        f += rng.normal(0, 0.05, f.shape).astype(np.float32)
        frames.append(f)
        texts.append("abc")
    xs, xl, lb, ll = batch_lines(frames, texts, codec, T=32, S=8)
    losses = [tr.step(xs, xl, lb, ll) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5
    assert np.isfinite(losses).all()


def test_trainer_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(Codec(CHARSET), ni=8, ns=6)
    assert Trainer(Codec(CHARSET), ni=8, ns=6, device="cpu").device.type \
        == "cpu"


@pytest.fixture(scope="module")
def lines_dir(tmp_path_factory):
    """Three line crops with ground truth, as ``lines`` and ``gtedit
    extract`` leave them."""
    from text_alignment_tpu_torch import gtedit
    from text_alignment_tpu_torch.pipeline.preprocess import PreprocParams
    from text_alignment_tpu_torch.synth import make_page

    d = tmp_path_factory.mktemp("train_lines")
    page = make_page(np.random.default_rng(5), n_lines=3, words_per_line=2,
                     H=420, W=420, char_h=30, char_w=18, gap=4, space_w=24,
                     line_spacing=110)
    paths = gtedit.extract_lines(page.image, str(d), "p", backend="host",
                                 preproc_params=PreprocParams(filter_size=8))
    assert len(paths) == 3
    for i, text in enumerate(["deus in", "ave", "in deus"]):
        (d / f"p_{i:04d}.gt.txt").write_text(text + "\n")
    return d


def _train_argv(lines, prefix, *extra):
    return ["train", "--lines-dir", str(lines), "--output-prefix",
            str(prefix), "--hidden", "8", "--batch-size", "2",
            "--log-every", "1", "--save-every", "0", *extra]


def test_cli_train_checkpoint_loads_and_resume_is_exact(lines_dir,
                                                        tmp_path):
    from text_alignment_tpu_torch.cli import main

    assert main(_train_argv(lines_dir, tmp_path / "a" / "m", "--iterations",
                            "3", "--device", "cpu")) == 0
    rec = SeqRecognizer.from_pyrnn(str(tmp_path / "a" / "m-00000003.pyrnn.gz"),
                                   device="cpu")
    assert rec.params.fwd.WGI.shape == (8, 1 + 48 + 8)
    assert set("deus inave") <= set(rec.codec.charset)
    jax_d, _, _ = jax_load_pyrnn(str(tmp_path / "a" / "m-00000003.pyrnn.gz"))
    np.testing.assert_array_equal(jax_d["W2"], rec.params.W2.numpy())

    # 2 iterations, then --resume for 1 more: the 3-iteration run's state
    assert main(_train_argv(lines_dir, tmp_path / "b" / "m", "--iterations",
                            "2", "--device", "cpu")) == 0
    assert main(_train_argv(lines_dir, tmp_path / "b" / "m", "--iterations",
                            "1", "--device", "cpu", "--resume",
                            str(tmp_path / "b" / "m.state"))) == 0
    with np.load(tmp_path / "a" / "m.state", allow_pickle=False) as za, \
            np.load(tmp_path / "b" / "m.state", allow_pickle=False) as zb:
        keys = sorted(k for k in za.files if k.startswith("arr_"))
        assert keys == sorted(k for k in zb.files if k.startswith("arr_"))
        assert len(keys) == 46 and int(za["arr_000"]) == 3
        for k in keys:
            np.testing.assert_array_equal(za[k], zb[k])


def test_cli_train_needs_a_card_unless_given_the_cpu(lines_dir, tmp_path,
                                                     monkeypatch):
    from text_alignment_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(_train_argv(lines_dir, tmp_path / "m", "--iterations", "1"))
