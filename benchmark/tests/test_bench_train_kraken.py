"""The kraken training cell on the CPU at reduced widths and a tiny page:
the pairing of line crops with the page's text, the training work
functions and the new readers, the spec with the cell, whole runs past
the harness's look for a card (a sound run comes out correct, one with a
dropout site left out not correct), and the check of steps with a dropout
site, its rate, the loss, the padding masks, the LSTMs' packing or the
update broken where the program makes them."""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import common, run, validate, work
from benchmark.kinds import train_kraken
from benchmark.work import vgsl_train as train_work

DATA = common.os.path.join(common.HERE, "tests", "data")
SEED = 2 ** 32 + 99
CELL = "kraken_train.train_kraken"
CPU = torch.device("cpu")


def tiny_spec():
    spec = copy.deepcopy(common.load_spec())
    spec["configs"].append({
        "name": "tiny_kraken_train", "source": "tests",
        "file": "benchmark/tests/data/tiny_kraken_train.json",
        "reduced": [], "why": "tests"})
    cell = "tiny_kraken_train.train_kraken"
    spec["workloads"].append({"name": cell, "config": "tiny_kraken_train",
                              "traffic": "train_kraken_tiny", "chips": 1,
                              "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "folios_per_s" or m["name"].endswith(
                ".train_kraken"):
            m["workloads"] = m.get("workloads", []) + [cell]
    return spec, cell


def run_tiny(seconds=0.5, trace=0):
    spec, cell = tiny_spec()
    args = run.parse_args(["--workload", cell, "--seed", str(SEED),
                           "--seconds", str(seconds), "--trace",
                           str(trace)])
    return run.run_cell(args, CPU, spec, t_process=time.perf_counter(),
                        data_dir=DATA)


def test_the_spec_holds_the_cell():
    spec = common.load_spec()
    assert validate.problems(spec) == []
    cell = common.find(spec["workloads"], CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "kraken_train", "train_kraken", 1)
    e2e, layers = common.cell_metrics(spec, CELL)
    assert {m["name"] for m in e2e} == {"folios_per_s", "setup_s"}
    assert {m["name"] for m in layers} == {
        "lstm_train_device_ms.train_kraken",
        "vgsl_conv_train_roofline.train_kraken",
        "train_host_ms.train_kraken", "device_idle_pct.train_kraken",
        "mfu.train_kraken"}
    config = common.load_json(common.os.path.join(
        common.ROOT, "benchmark/configs/kraken_train.json"))
    default = common.load_json(common.os.path.join(
        common.ROOT, "benchmark/configs/kraken_default.json"))
    assert config["reduced"] == []
    assert {k: v for k, v in config["model"].items()
            if k in default["model"]} == default["model"]
    assert [(s["p"], s["dims"]) for s in config["train"]["dropout"]] == (
        [(0.1, 2)] * 6 + [(0.5, 1)])


def test_sound_run_is_correct():
    res = run_tiny()
    assert res["correct"], res["limits"]
    assert set(res["metrics"]) == {"folios_per_s", "setup_s"}
    assert set(res["limits"]) == set(train_kraken.NUMBERS)
    assert res["limits"]["train_dropout_sites_missing"]["value"] == 0
    assert 0 < res["limits"]["train_grad_err"]["value"] < 5e-4
    assert 0 < res["limits"]["train_update_err"]["value"] < 5e-3


def test_dropout_rate_band():
    # 1,280 draws of p 0.1 (four steps of a conv site at 10 lines): 128
    # zeros expected, a standard deviation of 10.7
    assert train_kraken.rate_holds(128, 1280, 0.1)
    assert train_kraken.rate_holds(190, 1280, 0.1)
    assert not train_kraken.rate_holds(200, 1280, 0.1)
    assert not train_kraken.rate_holds(0, 1280, 0.1)
    assert not train_kraken.rate_holds(1152, 1280, 0.1)


def test_traced_run_reads_the_host_spans_and_the_work():
    res = run_tiny(trace=1)
    assert res["correct"], res["limits"]
    # no card: no device events, so only the span and the whole-step
    # readers find anything
    assert "train_host_ms.train_kraken" in res["metrics"]
    assert "mfu.train_kraken" in res["metrics"]


def no_last_site(monkeypatch):
    """The final ``Do`` left out: its mask drawn with p 0."""
    from text_alignment_tpu_torch.models import vgsl

    monkeypatch.setattr(vgsl, "DROPOUT", vgsl.DROPOUT[:6] + ((0.0, 1),))
    return "train_dropout_sites_missing"


def inverted_keep(monkeypatch):
    """Every site keeps a value with probability p where it should drop
    it, at the right scale."""
    from text_alignment_tpu_torch.models import vgsl

    def mask(shape, p, generator, device):
        keep = torch.rand(shape, generator=generator, device=device) < p
        return keep.to(torch.float32) / (1.0 - p)

    monkeypatch.setattr(vgsl, "dropout_mask", mask)
    return "train_dropout_sites_missing"


def nothing_dropped(monkeypatch):
    """Every value kept, yet scaled by 1 / (1 - p)."""
    from text_alignment_tpu_torch.models import vgsl

    def mask(shape, p, generator, device):
        return torch.full(shape, 1.0 / (1.0 - p), device=device)

    monkeypatch.setattr(vgsl, "dropout_mask", mask)
    return "train_dropout_sites_missing"


def no_update(monkeypatch):
    """Adam's step leaves the weights as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    return "train_update_err"


def tenth_lr(monkeypatch):
    """Adam at a tenth of the configuration's learning rate."""
    from text_alignment_tpu_torch.models import train

    orig = train.VGSLTrainer.__init__

    def init(self, *args, lr=1e-3, **kw):
        orig(self, *args, lr=lr / 10, **kw)

    monkeypatch.setattr(train.VGSLTrainer, "__init__", init)
    return "train_update_err"


def mean_loss(monkeypatch):
    """The loss averaged over the lines, kraken's sum's 1 / B."""
    from text_alignment_tpu_torch.models import train

    orig = train.F.ctc_loss

    def mean(logp, targets, n, ll, **kw):
        return orig(logp, targets, n, ll, **kw) / len(ll)

    monkeypatch.setattr(train, "F", SimpleNamespace(ctc_loss=mean))
    return "train_loss_err"


def unmasked_padding(monkeypatch):
    """No column past a line's width zeroed before the convolutions."""
    from text_alignment_tpu_torch.models import vgsl

    monkeypatch.setattr(vgsl, "_mask", lambda x, widths: x)
    return "train_grad_err"


def unpacked(monkeypatch):
    """The LSTMs run over the padded frames, every line at the bucket's
    length."""
    from text_alignment_tpu_torch.models import vgsl

    orig = vgsl.pack_padded_sequence

    def whole(xs, counts, **kw):
        return orig(xs, torch.full_like(counts, xs.shape[1]), **kw)

    monkeypatch.setattr(vgsl, "pack_padded_sequence", whole)
    return "train_grad_err"


def checked_steps(steps=3):
    """The tiny cell's check after ``steps`` steps: past the first, whose
    seeded convolution biases are 0, so that its padded columns stay 0
    after the first convolution."""
    import shutil
    import tempfile

    spec, cell = tiny_spec()
    _, config, traffic, limits = common.cell_parts(spec, cell, DATA)
    workdir = tempfile.mkdtemp()
    try:
        c = train_kraken.Cell(config, traffic, SEED, CPU, workdir, False)
        c.setup()
        recs = [dict(c.step(i), ok=True) for i in range(steps)]
        c.free()
        return c.check(recs), limits
    finally:
        shutil.rmtree(workdir)


@pytest.mark.parametrize("fault", [no_last_site, inverted_keep,
                                   nothing_dropped, mean_loss,
                                   unmasked_padding, unpacked, no_update,
                                   tenth_lr])
def test_a_broken_step_fails_the_check(monkeypatch, fault):
    number = fault(monkeypatch)
    numbers, limits = checked_steps()
    assert numbers[number] > limits[number]


def test_a_broken_step_fails_the_run(monkeypatch):
    no_last_site(monkeypatch)
    res = run_tiny()
    assert not res["correct"]
    assert res["limits"]["train_dropout_sites_missing"]["value"] == 1


def test_crops_pair_with_their_lines_by_position():
    lines = [85, 265, 445, 625, 805]
    # the last line cut twice; the fourth missed; the frame 40 rows down
    assert train_kraken.pair_lines([125, 305, 485, 665, 845, 845], lines) \
        == [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4)]
    assert train_kraken.pair_lines([125, 305, 485, 845], lines) == [
        (0, 0), (1, 1), (2, 2), (3, 4)]
    assert train_kraken.pair_lines([], lines) == []
    cfg = common.load_json(common.os.path.join(DATA,
                                               "tiny_kraken_train.json"))
    page = common.make_pages(cfg, SEED, 1, tag=30)[0]
    texts, centres = train_kraken.line_texts(page, cfg["page"]["gap"])
    assert " ".join(texts) == page.transcript
    assert len(texts) == cfg["page"]["n_lines"] and centres == sorted(
        centres)


def test_training_work_by_hand():
    nbytes, ops = train_work.conv_train([16], 8, ((3, 3, 2), (3, 3, 2),
                                                  (3, 3, 4), (3, 3, 4)))
    mac = [2 * 2 * 8 * 16 * 1 * 9, 2 * 2 * 4 * 8 * 2 * 9,
           2 * 4 * 2 * 4 * 2 * 9, 2 * 4 * 1 * 2 * 4 * 9]
    outs = [2 * 8 * 16, 2 * 4 * 8, 4 * 2 * 4, 4 * 1 * 2]
    assert ops == sum(2 * m + 2 * o for m, o in zip(mac, outs)) + sum(
        mac[1:])
    ins = [8 * 16, 2 * 4 * 8, 2 * 2 * 4, 4 * 1 * 2]
    wts = [2 * 9 + 2, 2 * 2 * 9 + 2, 4 * 2 * 9 + 4, 4 * 4 * 9 + 4]
    assert nbytes == 4 * sum(2 * (i + w + o) for i, w, o in
                             zip(ins, wts, outs)) + 4 * sum(
        i + w + o for i, w, o in list(zip(ins, wts, outs))[1:])
    convs = ((3, 13, 32), (3, 13, 32), (3, 9, 64), (3, 9, 64))
    (cb, co), (b, o) = train_work.step([1000], 120, convs, 200, 3, 29)
    # a 1000-column line: forward 3.95 GFLOP, its gradients twice that
    # but for the first convolution's input gradient (0.30 GFLOP)
    assert 11.4e9 < co < 11.7e9
    assert 3 * (3.95e9 + 125 * 7.5e6) < o < 3 * (3.96e9 + 125 * 7.7e6)


def test_readers_on_hand_built_traces():
    w = work.Work()
    w.add("vgsl_conv_train", 0, work.PEAK_FP32_FLOPS * 1e-6)   # 1 us
    w.add("vgsl_train", 0, work.PEAK_FP32_FLOPS * 1e-4)
    dev = [("void elemWiseRNNcell<float, float, float, (cudnnRNNMode_t)2>",
            0.0, 300.0),
           ("void gemmSN_NN_kernel<float, 256, 4, 2, 8, 5, 4, false>",
            300.0, 500.0),
           ("void LSTM_elementWise_bp1<float, float, float>(int, "
            "cudnnRNNClipMode_t)", 500.0, 600.0),
           ("sm80_xmma_fprop_implicit_gemm_f32f32", 600.0, 602.0),
           ("sm80_xmma_dgrad_implicit_gemm_f32f32", 602.0, 603.0),
           ("sm80_xmma_wgrad_implicit_gemm_f32f32", 603.0, 604.0),
           ("ampere_sgemm_128x64_tn", 700.0, 900.0)]
    host = [("ta.train.forward", 0.0, 100.0), ("ta.train.loss", 100.0,
                                                150.0),
            ("ta.train.backward", 150.0, 400.0),
            ("ta.train.update", 400.0, 500.0), ("aten::mm", 0.0, 50.0)]
    ctx = SimpleNamespace(dev=dev, host=host, traced=[{}, {}], work=w,
                          window_s=1e-3, busy_s=6e-4)
    read = run.load_reader
    assert read("lstm_train_device_ms.train_kraken")(ctx) == \
        pytest.approx(0.3)
    assert read("vgsl_conv_train_roofline.train_kraken")(ctx) == \
        pytest.approx(25)
    assert read("train_host_ms.train_kraken")(ctx) == pytest.approx(0.25)
    assert read("device_idle_pct.train_kraken")(ctx) == pytest.approx(40.0)
    assert read("mfu.train_kraken")(ctx) == pytest.approx(10.0)
    empty = SimpleNamespace(dev=[], host=[], traced=[{}], work=work.Work(),
                            window_s=1.0, busy_s=0.0)
    for name in ("lstm_train_device_ms", "vgsl_conv_train_roofline",
                 "train_host_ms", "device_idle_pct", "mfu"):
        assert read(name + ".train_kraken")(empty) is None
