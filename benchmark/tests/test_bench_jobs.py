"""The jobs cell on the CPU at a tiny size: its reference BiLSTM against the
program's plain path, its frozen normalizer and decode against the
program's, the frames rule and its bfloat16 control, the sample and the
taps, the seeded weights, the OCR work functions and readers, and whole
runs past the harness's look for a card: a sound run comes out correct,
and one with the frames, the posteriors, half of a batch, an OCR
character or a syllable box broken where the program makes them comes out
not correct."""

import copy
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import common, run, work
from benchmark.gen import weights as gen_weights
from benchmark.kinds import jobs
from benchmark.reference import assemble, bilstm, ctc, lineest
from benchmark.reference.charbox import CharBox
from benchmark.work import ocr as ocr_work

DATA = common.os.path.join(common.HERE, "tests", "data")
SEED = 2 ** 32 + 99
TINY = common.load_json(common.os.path.join(DATA, "tiny.json"))
TRAFFIC = common.load_json(common.os.path.join(DATA, "traffic",
                                               "jobs_tiny.json"))
CHARSET = TINY["model"]["charset"]


def small_weights(seed, ni=8, ns=12, nout=6):
    config = {"model": {"ni": ni, "ns": ns, "charset": ["x"] * nout},
              "weights": TINY["weights"]}
    return gen_weights.bilstm_weights(config, seed, torch.device("cpu"))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_reference_bilstm_equals_the_programs_plain_path(seed):
    from text_alignment_tpu_torch.models.lstm import (
        BiLSTMParams, LSTMParams, bilstm_forward_batched)

    w = small_weights(seed)
    w["W2"][0, 0] = 3.0
    g = torch.Generator().manual_seed(seed)
    frames = torch.rand((4, 40, 8), generator=g)
    lengths = torch.tensor([40, 33, 17, 1])
    params = BiLSTMParams(*(LSTMParams(*(w[d][k] for k in LSTMParams._fields))
                            for d in ("fwd", "bwd")), w["W2"])
    got = bilstm_forward_batched(params, frames, lengths)
    with bilstm.precision(tf32=False):
        want = bilstm.forward(w, frames, lengths)
    for b, n in enumerate(lengths.tolist()):
        assert torch.allclose(got[b, :n], want[b, :n], atol=2e-6, rtol=0)


def test_precision_restores_the_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    with bilstm.precision(tf32=not before):
        assert torch.backends.cuda.matmul.allow_tf32 == (not before)
    assert torch.backends.cuda.matmul.allow_tf32 == before


def peaky(rng, T, C):
    """(T, C) posteriors with runs below and above the blank threshold."""
    logits = rng.normal(0, 3, (T, C))
    logits[:, 0] += np.repeat(rng.choice([-4.0, 6.0], T // 4 + 1), 4)[:T]
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_frozen_decode_equals_the_programs(seed):
    from text_alignment_tpu_torch.models.ctc import (
        llocs_positions, translate_back_batched)

    rng = np.random.default_rng(seed)
    posts = [peaky(rng, T, 7) for T in (60, 45, 33)]
    T = max(len(p) for p in posts)
    batch = np.zeros((len(posts), T, 7), np.float32)
    for b, p in enumerate(posts):
        batch[b, :len(p)] = p
    fr, cl, cnt = translate_back_batched(
        torch.from_numpy(batch), torch.tensor([len(p) for p in posts]),
        max_regions=64)
    for b, p in enumerate(posts):
        mine = ctc.regions(p)
        n = int(cnt[b])
        assert n == len(mine) > 0
        assert [(f, c) for _, _, f, c in mine] == list(
            zip(fr[b, :n].tolist(), cl[b, :n].tolist()))
        xs = llocs_positions(fr[b, :n].tolist(), 301, len(p), 16)
        assert xs == [ctc.llocs_x(f, 301, len(p), 16) for _, _, f, _ in mine]


def test_charboxes_equal_the_programs():
    from text_alignment_tpu_torch.pipeline.assemble import llocs_to_charboxes
    from text_alignment_tpu_torch.pipeline.preprocess import LineStrip

    rows = [[("a", 10.2), ("", 14.0), ("~", 20.5), (" ", 22.5), ("b", 30.0)],
            [("c", 3.0)]]
    strips = [LineStrip(np.ones((20, 40), bool), 100, 7),
              LineStrip(np.ones((15, 40), bool), 90, 50)]
    want, _ = llocs_to_charboxes(strips, rows)
    got = ctc.charboxes([(s.offset_x, s.offset_y, s.height, r)
                         for s, r in zip(strips, rows)])
    assert [(c.char, c.ul, c.lr) for c in got] == [
        (c.char, c.ul, c.lr) for c in want]


def strips_of(seed=SEED):
    """The program's onebit strips of a tiny page (True = ink)."""
    from text_alignment_tpu_torch.pipeline.preprocess import (
        identify_text_lines, preprocess_images)

    page = common.make_pages(TINY, seed, 1)[0]
    image, eroded, _ = preprocess_images(page.image, backend="hybrid",
                                         device=torch.device("cpu"))
    strips, _, _ = identify_text_lines(image, eroded, backend="hybrid",
                                       verbose=False,
                                       device=torch.device("cpu"))
    assert len(strips) >= 3
    return strips


def test_frozen_normalizer_equals_the_programs_scipy_normalizer():
    from text_alignment_tpu_torch.models.lineest_host import normalize_strip

    strips = strips_of()
    for s in strips:
        want, width = normalize_strip(s.img)
        assert width == s.img.shape[1]
        np.testing.assert_array_equal(lineest.normalize(s.img), want)
    assert lineest.normalize(np.zeros((9, 30), bool)) is None


def device_frames(strips):
    from text_alignment_tpu_torch.models.lineest import normalize_batch_device

    B = len(strips)
    Hp = max(s.img.shape[0] for s in strips)
    Wp = max(s.img.shape[1] for s in strips)
    grey = np.ones((B, Hp, Wp), np.uint8)
    hs, ws = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for b, s in enumerate(strips):
        h, w = s.img.shape
        grey[b, :h, :w] = ~s.img
        hs[b], ws[b] = h, w
    frames, lengths, _ = normalize_batch_device(
        torch.from_numpy(grey), torch.from_numpy(hs), torch.from_numpy(ws),
        t_max=2048, onebit=True)
    return [frames[b, :lengths[b]].numpy() for b in range(B)]


def test_program_frames_stay_near_the_frozen_normalizer_and_bf16_does_not():
    strips = strips_of()
    prog = off = ctrl = total = 0
    for s, got in zip(strips, device_frames(strips)):
        want = lineest.normalize(s.img)
        o, t = jobs.frames_off(got, want)
        prog, total = prog + o, total + t
        off += jobs.frames_off(lineest.normalize(s.img, rnd=lineest.bf16),
                               want)[0]
    assert total > 1000
    assert prog <= 0.01 * total
    assert off >= 0.3 * total


def test_bf16_rounds_to_the_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -9,
                  -3.0e-5, 0.0], np.float32)
    np.testing.assert_array_equal(
        lineest.bf16(x),
        torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    assert lineest.bf16(x)[1] == 1.0 and lineest.bf16(x)[2] == 1 + 2 ** -6


def test_frames_off_counts_rows_past_the_tolerance_and_unequal_lengths():
    a = np.zeros((2 * jobs.PAD + 5, 3), np.float32)
    b = a.copy()
    assert jobs.frames_off(a, b) == (0, 5)
    b[jobs.PAD + 1, 2] = 2 * jobs.FRAME_TOL
    b[jobs.PAD + 3, 0] = 0.5 * jobs.FRAME_TOL
    b[0, 0] = 1.0  # a pad frame is not compared
    assert jobs.frames_off(a, b) == (1, 5)
    assert jobs.frames_off(a, b[:-1]) == (5, 5)
    assert jobs.frames_off(a, None) == (5, 5)
    assert jobs.frames_off(a[:0], None) == (0, 0)


def test_served_is_the_programs_decode_of_the_same_posteriors():
    """The frozen decode, placement and expansion of a page's posteriors
    against the recognizer's decode and ``llocs_to_charboxes``."""
    from text_alignment_tpu_torch.models.ctc import translate_back_batched
    from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
    from text_alignment_tpu_torch.pipeline.assemble import (
        expand_abbreviations, llocs_to_charboxes)

    strips = strips_of()
    rng = np.random.default_rng(3)
    C = len(CHARSET)
    posts = [peaky(rng, 2 * jobs.PAD + n, C) for n in (40, 0, 25, 61)]
    posts = (posts * 2)[:len(strips)]
    T = max(len(p) for p in posts)
    batch = np.zeros((len(posts), T, C), np.float32)
    for b, p in enumerate(posts):
        batch[b, :len(p)] = p
    lengths = torch.tensor([len(p) for p in posts])
    fr, cl, cnt = translate_back_batched(torch.from_numpy(batch), lengths,
                                         max_regions=64)
    wire = np.concatenate([cnt[:, None].numpy(), lengths[:, None].numpy(),
                           lengths[:, None].numpy(), fr.numpy(), cl.numpy()],
                          axis=1)
    rec = SeqRecognizer.__new__(SeqRecognizer)
    rec.pad, rec.codec = jobs.PAD, SimpleNamespace(charset=CHARSET)
    rows = rec._decode_packed([s.img for s in strips], wire)
    want, _ = llocs_to_charboxes(strips, rows)
    want = expand_abbreviations(want)
    lines = [{"strip": s, "ink": s.img, "post": p}
             for s, p in zip(strips, posts)]
    got = jobs.served(lines, CHARSET)
    assert len(got) > 20
    assert jobs.chars_diff(want, got) == 0
    lines[1]["strip"] = None
    assert jobs.served(lines, CHARSET) is None
    assert jobs.chars_diff(want, None) == len(want)


def test_chars_diff_counts_characters_corners_and_count():
    boxes = [CharBox(ch, (10 * i, 0), (10 * i + 10, 5))
             for i, ch in enumerate("abcd")]
    assert jobs.chars_diff(boxes, list(boxes)) == 0
    other = list(boxes)
    other[1] = CharBox("z", boxes[1].ul, boxes[1].lr)
    other[2] = CharBox("c", boxes[2].ul, (boxes[2].lrx + 1, 5))
    assert jobs.chars_diff(other, boxes) == 2
    assert jobs.chars_diff(boxes[:3], boxes) == 1
    assert jobs.chars_diff([], None) == 1


def test_the_sample_is_drawn_from_the_seed_as_items_come():
    def picks(seed, n=2000, k=8):
        c = jobs.Cell(TINY, dict(TRAFFIC, check_jobs=k), seed,
                      torch.device("cpu"), None, False)
        for i in range(n):
            c._capture(i)
        return sorted(m for m, _ in c._kept.values())

    a, b, c = picks(SEED), picks(SEED), picks(SEED + 1)
    assert a == b != c
    assert len(a) == 8 == len(set(a))
    assert max(a) > 1000  # not only the first items
    assert picks(SEED, n=3) == [0, 1, 2]
    counts = np.zeros(4)
    for s in range(200):
        for m in picks(s, n=400, k=2):
            counts[m // 100] += 1
    assert counts.min() > 60  # each quarter of the run, ~100 expected


def test_taps_keep_the_last_call_and_come_off():
    from text_alignment_tpu_torch.models import recognizer

    before = recognizer.bilstm_forward_batched
    c = jobs.Cell(TINY, TRAFFIC, SEED, torch.device("cpu"), None, False)
    c._tap()
    assert recognizer.bilstm_forward_batched is not before
    c._cur = {}
    out = recognizer.bilstm_forward_batched(*tiny_lstm_call())
    out2 = recognizer.bilstm_forward_batched(*tiny_lstm_call(2))
    assert c._cur[jobs.LSTM][1] is out2 and out2 is not out
    c._cur = None
    recognizer.bilstm_forward_batched(*tiny_lstm_call())
    c.free()
    assert recognizer.bilstm_forward_batched is before


def tiny_lstm_call(seed=1):
    from text_alignment_tpu_torch.models.lstm import BiLSTMParams, LSTMParams

    w = small_weights(seed)
    params = BiLSTMParams(*(LSTMParams(*(w[d][k] for k in LSTMParams._fields))
                            for d in ("fwd", "bwd")), w["W2"])
    return params, torch.rand((2, 10, 8)), torch.tensor([10, 4])


def test_weights_follow_the_seed():
    a = small_weights(2 ** 31 + 7)
    b = small_weights(2 ** 31 + 7)
    c = small_weights(2 ** 31 + 8)
    assert torch.equal(a["fwd"]["WGI"], b["fwd"]["WGI"])
    assert not torch.equal(a["fwd"]["WGI"], c["fwd"]["WGI"])
    assert float(a["fwd"]["WGI"][:, 1:9].abs().max()) > 1.0  # input, +-2
    assert float(a["fwd"]["WGI"][:, 9:].abs().max()) <= 0.3
    assert float(a["W2"][0].abs().max()) == 0.0


def test_blank_bias_puts_the_share_below_the_threshold():
    w = gen_weights.bilstm_weights(TINY, SEED, torch.device("cpu"))
    frames, lengths = gen_weights.calibration_frames(TINY, SEED,
                                                     torch.device("cpu"))
    assert frames.shape[0] == TINY["page"]["n_lines"]
    w["W2"][0, 0] = gen_weights.blank_bias(w, frames, lengths)
    post = bilstm.forward(w, frames, lengths)
    valid = torch.arange(frames.shape[1])[None, :] < lengths[:, None]
    share = float((post[..., 0][valid] < 0.7).float().mean())
    assert share == pytest.approx(gen_weights.BLANK_SHARE, abs=0.01)


def test_work_functions_by_hand():
    nbytes, ops = ocr_work.bilstm([10, 5], ni=2, ns=3, nout=4)
    per_frame = 2 * (2 * 12 * 3 + 2 * 12 * 3 + 48) + 2 * 4 * 7 + 12
    assert ops == 15 * per_frame
    assert nbytes == 4 * (15 * 6 + 2 * (12 * 6 + 9) + 4 * 7)
    nbytes, ops = ocr_work.lineest_tail([10, 0], [20, 0], Hp=32, Wp=256)
    k2 = 2 * int(4 * 0.3 * 32 + 0.5) + 1
    assert ops == 4 * 200 + 256 * (3 * 12 + 1) + 256 * 1  # 25 taps at h 10
    assert nbytes == 5 * 200 + 8 * 2 * k2 + 16 + 4 * 2 * 256 + 16


def test_readers_on_hand_built_traces():
    w = work.Work()
    w.add("lineest_tail", work.PEAK_HBM_BYTES * 1e-6, 0)   # 1 us at best
    dev = [("void ta_lstm_scan_kernel<4>(float const*)", 0.0, 300.0),
           ("ta_lstm_scan_wide_kernel", 400.0, 500.0),
           ("ta_tail_row_mean", 600.0, 601.0),
           ("ta_tail_col_mean", 602.0, 603.0),
           ("ta_tail_center", 604.0, 606.0), ("other", 700.0, 900.0)]
    ctx = SimpleNamespace(dev=dev, host=[], traced=[{}, {}], work=w,
                          window_s=1e-3, busy_s=6e-4)
    assert run.load_reader("lstm_scan_device_ms.jobs_hybrid")(
        ctx) == pytest.approx(0.2)
    assert run.load_reader("lineest_tail_roofline.jobs_hybrid")(
        ctx) == pytest.approx(25.0)
    assert run.load_reader("device_idle_pct.jobs_hybrid")(
        ctx) == pytest.approx(40.0)
    empty = SimpleNamespace(dev=[], host=[], traced=[{}], work=work.Work(),
                            window_s=1.0, busy_s=0.0)
    for name in ("lstm_scan_device_ms", "lineest_tail_roofline",
                 "device_idle_pct", "mfu"):
        assert run.load_reader(name + ".jobs_hybrid")(empty) is None


def tiny_spec():
    spec = copy.deepcopy(common.load_spec())
    spec["configs"].append({"name": "tiny", "source": "tests",
                            "file": "benchmark/tests/data/tiny.json",
                            "reduced": [], "why": "tests"})
    cell = "tiny.jobs"
    spec["workloads"].append({"name": cell, "config": "tiny",
                              "traffic": "jobs_tiny", "chips": 1,
                              "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "folios_per_s" or m.get("moves") == "folios_per_s":
            m["workloads"] = m.get("workloads", []) + [cell]
    return spec, cell


def run_tiny(seconds=0.5):
    spec, cell = tiny_spec()
    args = run.parse_args(["--workload", cell, "--seed", str(SEED),
                           "--seconds", str(seconds), "--trace", "0"])
    return run.run_cell(args, torch.device("cpu"), spec,
                        t_process=time.perf_counter(), data_dir=DATA)


def test_sound_run_is_correct():
    res = run_tiny()
    assert res["correct"], res["limits"]
    assert set(res["metrics"]) == {"folios_per_s", "setup_s"}
    assert set(res["limits"]) == {"ocr_frames_off_pct", "ocr_posterior_err",
                                  "ocr_chars_diff", "syl_boxes_diff"}
    assert all(v["value"] == 0 for k, v in res["limits"].items()
               if k in ("ocr_chars_diff", "syl_boxes_diff"))
    assert list(res)[-1] == "limits"


def alter_char(orig):
    def broken(strips, rows):
        chars, other = orig(strips, rows)
        c = chars[len(chars) // 2]
        chars[len(chars) // 2] = type(c)("z" if c.char != "z" else "y",
                                         c.ul, c.lr)
        return chars, other
    return broken


def alter_syllable(orig):
    """A syllable box moved, or one added where a page has none (seeded
    weights read few characters that the transcript aligns to)."""
    def broken(*a, **k):
        from text_alignment_tpu_torch.charbox import CharBox as PortBox

        boxes = orig(*a, **k)
        if not boxes:
            return [PortBox("do", (5, 5), (20, 30))]
        b = boxes[len(boxes) // 2]
        boxes[len(boxes) // 2] = PortBox(b.char, b.ul, (b.lrx + 3, b.lry))
        return boxes
    return broken


def shift_frames(orig):
    """The normalizer's frames one frame late."""
    def broken(*a, **k):
        frames, lengths, t_raws = orig(*a, **k)
        return torch.roll(frames, 1, dims=1), lengths, t_raws
    return broken


def nudge_posteriors(orig):
    """A line's posteriors moved where the BiLSTM makes them."""
    def broken(params, frames, lengths):
        out = orig(params, frames, lengths).clone()
        out[0, jobs.PAD:jobs.PAD + 5] *= 0.999
        return out
    return broken


def half_the_batch(orig):
    """The BiLSTM run over the first half of the page's lines alone, the
    rest of the batch left blank."""
    def broken(params, frames, lengths):
        h = int((lengths > 0).sum()) // 2
        out = orig(params, frames[:h], lengths[:h])
        rest = torch.zeros((len(frames) - h,) + out.shape[1:])
        rest[..., 0] = 1.0
        return torch.cat([out, rest])
    return broken


@pytest.mark.parametrize("module, where, fault, number", [
    ("models.recognizer", "normalize_batch_device", shift_frames,
     "ocr_frames_off_pct"),
    ("models.recognizer", "bilstm_forward_batched", nudge_posteriors,
     "ocr_posterior_err"),
    ("models.recognizer", "bilstm_forward_batched", half_the_batch,
     "ocr_posterior_err"),
    ("pipeline.process", "llocs_to_charboxes", alter_char, "ocr_chars_diff"),
    ("pipeline.process", "group_syllables", alter_syllable,
     "syl_boxes_diff"),
])
def test_a_broken_answer_fails_the_run(monkeypatch, module, where, fault,
                                       number):
    """Frames, posteriors, half of a batch, an OCR character or a syllable
    box broken where the program makes them."""
    import importlib

    mod = importlib.import_module("text_alignment_tpu_torch." + module)
    monkeypatch.setattr(mod, where, fault(getattr(mod, where)))
    res = run_tiny()
    assert not res["correct"]
    assert res["limits"][number]["value"] > res["limits"][number]["limit"]


def test_cell_check_and_control_on_one_tiny_page():
    """Set-up, one traced step, the check and the control's path (on the
    CPU TF32 changes nothing: the control fails there by its frames)."""
    traffic = dict(TRAFFIC, folios=1)
    workdir = tempfile.mkdtemp()
    try:
        c = jobs.Cell(TINY, traffic, SEED, torch.device("cpu"), workdir,
                      True)
        c.setup()
        rec = dict(c.step(0), ok=True)
        c.free()
        numbers = c.check([rec])
        control = c.control()
        w = c.work([rec])
    finally:
        shutil.rmtree(workdir)
    assert numbers["ocr_chars_diff"] == numbers["syl_boxes_diff"] == 0
    assert 0 < numbers["ocr_posterior_err"] < 5e-5
    assert numbers["ocr_frames_off_pct"] < 1.0
    assert set(control) == set(numbers)
    assert control["ocr_chars_diff"] == 0
    assert control["ocr_frames_off_pct"] > 30.0
    assert set(w.totals) == {"bilstm", "lineest_tail"}
    assert any("sampled items" in line for line in c.log)


WORDS = ("dominus", "deus", "alleluia", "sanctus", "gloria", "kyrie",
         "angelus", "maria", "in", "excelsis", "benedictus", "magnificat",
         "euouae", "cuius", "eius", "christe", "quoniam", "tu", "solus",
         "qui", "tollis", "peccata", "mundi", "xyz", "a", "")


def test_syllabification_equals_the_programs():
    from text_alignment_tpu_torch.lang.syllabify import syllabify_text

    rng = np.random.default_rng(5)
    words = list(WORDS) + ["".join(rng.choice(list("abcdeilmnopqrstuxy"),
                                              rng.integers(1, 12)))
                           for _ in range(300)]
    for w in words:
        assert assemble.syllabify_text(w) == syllabify_text(w), w
    text = " ".join(words[:40])
    assert assemble.syllabify_text(text) == syllabify_text(text)


def test_syl_boxes_equal_the_programs_assembly():
    """The reference's alignment, grouping and rotation against the
    program's on a page's injected OCR, with its abbreviations expanded."""
    from text_alignment_tpu_torch.align.api import perform_alignment
    from text_alignment_tpu_torch.charbox import CharBox as PortBox
    from text_alignment_tpu_torch.lang.syllabify import syllabify_text
    from text_alignment_tpu_torch.pipeline import assemble as port

    page = common.make_pages(TINY, SEED, 1)[0]
    for k in range(3):
        ocr = common.injected_ocr(page, common.rng(SEED, 5, k), 0.1, 0.05)
        chars = port.expand_abbreviations(
            [PortBox(c.char, c.ul, c.lr) for c in ocr])
        text = "".join(c.char for c in chars)
        tra, oa = perform_alignment(list(page.transcript), list(text),
                                    backend="host")
        grouped = port.group_syllables(syllabify_text(page.transcript),
                                       "".join(tra), "".join(oa), chars)
        want = port.rotate_bboxes(grouped, -0.8, (420, 720), (400, 700))
        got = assemble.syl_boxes(page.transcript, chars, 0.8, (420, 720),
                                 (400, 700))
        assert [(b.char, b.ul, b.lr) for b in got] == [
            (b.char, b.ul, b.lr) for b in want]
