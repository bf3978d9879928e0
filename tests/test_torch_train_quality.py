"""Hard quality floor on the port's trained recognizer: the recipe of
tests/test_train_quality.py on the port, on the CPU. Train the BiLSTM+CTC
recognizer (the port's models/train.py) on a handful of rendered pages,
then decode HELD-OUT lines through the port's SeqRecognizer (host
normalizer; "bestpath" decode, which reads the young, non-peaky model
exactly) and require at least 0.85 character accuracy and llocs positions
within 2.5 character widths of the glyphs' right edges.

The port's Trainer(seed=1) starts from the JAX trainer's seed-1 weights
(``lstm.init_params_seeded``, tests/test_torch_train.py), so both
packages train from the same inputs; chip_smoke.py phase 18 runs this
recipe on the card.
"""

from __future__ import annotations

import numpy as np

import torch

from text_alignment_tpu_torch.synth import make_page
from text_alignment_tpu_torch.pipeline.preprocess import (
    preprocess_images,
    identify_text_lines,
)
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.train import Trainer, batch_lines
from text_alignment_tpu_torch.models.lineest_host import normalize_strip
from text_alignment_tpu_torch.models.recognizer import SeqRecognizer

torch.set_num_threads(1)

# clean pages, compact glyph set: the floor being tested is the OCR
# stack's, not the synthesizer's
PAGE_KW = dict(
    n_lines=6, words_per_line=2, H=1100, W=640, char_h=60, char_w=34,
    gap=7, space_w=46, line_spacing=160, margin_x=30, glyphs="char",
    vocabulary=("deus", "in", "ave"),
)


def _strip_text(strip, page, with_positions=False):
    """Ground-truth text of a line strip from the page's char boxes (no
    assumption that strip count equals rendered line count). With
    ``with_positions``, also returns each char's right edge in strip-local
    x (the llocs position convention)."""
    y0, y1 = strip.offset_y, strip.offset_y + strip.img.shape[0]
    chs = [cb for cb in page.char_boxes
           if y0 <= (cb.ul[1] + cb.lr[1]) // 2 < y1]
    chs.sort(key=lambda b: b.ul[0])
    out = []
    rights = []
    for a, b in zip([None] + chs[:-1], chs):
        if a is not None and b.ul[0] - a.lr[0] > PAGE_KW["gap"] + 2:
            out.append(" ")
        out.append(b.char)
        rights.append(b.lr[0] - strip.offset_x)
    if with_positions:
        return "".join(out), rights
    return "".join(out)


def _page_strips(seed):
    page = make_page(np.random.default_rng(seed), speckles=0, angle=0.0,
                     **PAGE_KW)
    image, eroded, _ = preprocess_images(page.image, backend="host")
    strips, _, _ = identify_text_lines(image, eroded, backend="host",
                                       verbose=False)
    return [(s, _strip_text(s, page)) for s in strips]


def _char_accuracy(pred: str, truth: str) -> float:
    """1 - edit_distance/len(truth) (clamped at 0)."""
    n, m = len(pred), len(truth)
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (pred[i - 1] != truth[j - 1]))
        prev = cur
    return max(0.0, 1.0 - prev[m] / max(1, m))


def test_trained_recognizer_heldout_char_accuracy():
    codec = Codec()

    frames_list, texts = [], []
    for seed in (200, 201):
        for s, t in _page_strips(seed):
            if not t:
                continue
            norm = normalize_strip(s.img)
            if norm is None:
                continue
            frames_list.append(norm[0])
            texts.append(t)
    assert len(frames_list) >= 10

    T = ((max(f.shape[0] for f in frames_list) + 127) // 128) * 128
    S = max(len(t) for t in texts) + 8
    xs, xlens, labels, llens = batch_lines(frames_list, texts, codec, T, S)
    tr = Trainer(codec=codec, lr=5e-3, seed=1, device="cpu")
    loss = float("inf")
    for _ in range(700):
        loss = tr.step(xs, xlens, labels, llens)
        if loss < 0.08:
            break
    assert loss < 1.0, f"training failed to converge (loss {loss:.2f})"

    # held-out page, decoded through the production recognizer path
    rec = SeqRecognizer(tr.params, codec, normalize_on_device=False,
                        decode="bestpath", device="cpu")
    pairs = [(s, t) for s, t in _page_strips(990) if t]
    rows = rec.recognize_batch([s.img for s, _ in pairs])
    accs = [
        _char_accuracy("".join(c for c, _ in r), t)
        for r, (_, t) in zip(rows, pairs)
    ]
    mean_acc = float(np.mean(accs))
    # the reference's bar on real pages is ~80% (README.md:24); clean
    # held-out synthetic lines must clear it with margin
    assert mean_acc >= 0.85, f"held-out char accuracy {mean_acc:.3f} < 0.85"

    # position grounding (VERDICT r2 #4): llocs x positions must index the
    # glyphs, not arbitrary frames — the property the alignment layer's
    # boxes depend on (reference contract: alignToOCR.py:156-170). CTC
    # emits with a systematic LATE bias (measured: ~1.5 char widths on the
    # full synthetic corpus, ~2.1 on this test's tiny-vocabulary model;
    # the rightmost-edge box convention absorbs most of it), so the bound
    # is 2.5 char widths: an ungrounded ("bunched") model — positions at
    # frames unrelated to the glyphs — fails it by an order of magnitude.
    page = make_page(np.random.default_rng(990), speckles=0, angle=0.0,
                     **PAGE_KW)
    image, eroded, _ = preprocess_images(page.image, backend="host")
    strips, _, _ = identify_text_lines(image, eroded, backend="host",
                                       verbose=False)
    errs = []
    matched = 0
    rows2 = rec.recognize_batch([s.img for s in strips])
    for strip, r in zip(strips, rows2):
        truth, rights = _strip_text(strip, page, with_positions=True)
        dec = "".join(c for c, _ in r if c != " ")
        if dec != truth.replace(" ", ""):
            continue  # position parity is only defined on exact decodes
        matched += 1
        k = 0
        for c, x in r:
            if c == " ":
                continue
            errs.append(abs(x - rights[k]))
            k += 1
    assert matched >= 3, f"only {matched} exactly-decoded lines"
    mean_err = float(np.mean(errs))
    bound = 2.5 * PAGE_KW["char_w"]
    assert mean_err <= bound, (
        f"llocs positions ungrounded: mean |x - GT right edge| = "
        f"{mean_err:.1f}px > {bound}px"
    )
