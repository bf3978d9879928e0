"""Served folio jobs: ``pipeline.process(image, transcript, ocropus_model=
<the seeded SeqRecognizer>, backend=<backend>, verbose=False, device=<the
card>)`` and ``to_JSON_dict`` of its syllable boxes, one folio at a time
(a closed loop), over ``folios`` seeded pages in page order, cycling. The
recognizer is built once, in set-up, with the configuration's widths and
seeded weights (``gen/weights.py``) and the card's production normalizer
(``normalize_on_device``); no stage cache is passed, so every item does
all its work. Reading a job's PNG is not part of an item.

Traffic keys: ``folios`` (pages, each from its own seed), ``backend``,
``check_jobs`` (items whose OCR the check compares), ``trace_jobs``
(items the traced run profiles).

How ``correct`` is decided. Set-up taps the two stages of the OCR program
(``models.recognizer``'s ``normalize_batch_device`` and
``bilstm_forward_batched``): for ``check_jobs`` items of the run, drawn
from the seed as they come (a reservoir, so the run's length need not be
known), they keep what each stage took and gave in the timed call itself,
at its batch and frame bucket, on the card; for the rest a tap is one
test of a flag. After the window, against the plain reference
(``reference/lineest.py``, ``bilstm.py``, ``ctc.py``, ``abbreviations.py``
and ``assemble.py``), which follows the program stage by stage:

- ``ocr_frames_off_pct``: of the frames between the blank pads of every
  line of the sampled items, the share where the frames that the
  program's normalizer gave differ from the frozen scipy normalizer's on
  the same onebit strip by more than ``FRAME_TOL`` at some row; a line
  whose length differs counts all its frames. The program parts from
  scipy where a float32 sum moves an argmax (a knife edge), so this is a
  share, not 0.
- ``ocr_posterior_err``: the largest absolute difference, over every valid
  frame of every line, between the posteriors that the program's BiLSTM
  gave and the reference's float32 BiLSTM (TF32 off) on the frames that
  it took.
- ``ocr_chars_diff``: the item's own OCR output (the ``all_chars`` that
  ``process`` returns) against the frozen region decode of those same
  posteriors, the llocs x positions, the CharBox mapping with the
  strips' offsets and the abbreviation expansion: boxes that differ in
  character or corners, plus the difference in count. Exact, limit 0:
  the decode's thresholds and argmax act on the very numbers the program
  decoded. The strips' offsets come from the program's raster and line
  finder run again on the page after the window; a line whose strip is
  not the one the timed normalizer took counts every output character.
- ``syl_boxes_diff``, on every item of the run: syllable boxes where the
  item's JSON differs from what the reference makes of the transcript
  and the item's own OCR characters: the NW reference's alignment
  (default scoring), the frozen syllabification and grouping, and the
  boxes rotated back by the page's skew. Exact: limit 0.

The control puts the reference in the program's place one precision
down: the normalizer storing bfloat16, the BiLSTM with TF32 on, on the
same strips and frames. Its output is its own decode, and its assembly
the reference's own, so those two numbers read 0 for it.
"""

from __future__ import annotations

import numpy as np

from .. import common, stats, work
from ..gen import weights as gen_weights
from ..reference import assemble, bilstm, ctc, lineest
from ..reference.abbreviations import expand_abbreviations
from ..work import ocr as ocr_work

PAD = 16          # ocropy's blank frames at either end of a line
FRAME_TOL = 1e-4  # a frame row further than this from scipy's is off
NORM, LSTM = "normalize_batch_device", "bilstm_forward_batched"
OCR_NUMBERS = ("ocr_frames_off_pct", "ocr_posterior_err", "ocr_chars_diff")


class Cell:
    def __init__(self, config, traffic, seed, device, workdir, trace):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.trace = device, trace
        self.charset = config["model"]["charset"]
        self.log = []
        self._pages, self._syl = {}, {}
        self._n, self._cur = None, None
        self._kept, self._traced, self._warm = {}, {}, []
        self._pick = common.rng(seed, 11)
        self._untap = None

    def setup(self):
        from text_alignment_tpu_torch.models.codec import Codec
        from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
        from text_alignment_tpu_torch.pipeline.process import (
            process, to_JSON_dict)

        m = self.config["model"]
        self.weights = gen_weights.recognizer_weights(self.config,
                                                      self.seed, self.device)
        self.rec = SeqRecognizer(
            self._program_params(), Codec(self.charset),
            target_height=m["ni"], pad=PAD, normalize_on_device=True,
            decode=m["decode"], device=self.device)
        self.process, self.to_json = process, to_JSON_dict
        self.pages = common.make_pages(self.config, self.seed,
                                       self.traffic["folios"], tag=8)
        self._tap()
        # every page once, and the first again: the recognizer sizes a
        # batch's frame bucket from the batch before it, so the window's
        # first item follows the last page, as every cycle's does. Each
        # warm item's taps are held to the end, so that the card's memory
        # pool already holds a sample's worth when the run keeps one
        for i in range(len(self.pages) + 1):
            self.step(i)
        self._warm.clear()
        self._n = 0

    def _program_params(self):
        """The program's copy of the benchmark's weights."""
        from text_alignment_tpu_torch.models.lstm import (
            BiLSTMParams, LSTMParams)

        w = self.weights

        def one(d):
            return LSTMParams(*(w[d][k].clone() for k in LSTMParams._fields))

        return BiLSTMParams(one("fwd"), one("bwd"), w["W2"].clone())

    def _tap(self):
        """Wrap the recognizer's two stages: while ``self._cur`` is a dict,
        each call leaves (args, output) in it under the stage's name (an
        escalated re-run overwrites, as its output is the one decoded)."""
        from text_alignment_tpu_torch.models import recognizer

        def tapped(name, fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self._cur is not None:
                    self._cur[name] = (args, out)
                return out
            return call

        orig = {name: getattr(recognizer, name) for name in (NORM, LSTM)}
        for name, fn in orig.items():
            setattr(recognizer, name, tapped(name, fn))
        self._untap = lambda: [setattr(recognizer, k, v)
                               for k, v in orig.items()]

    def _capture(self, n):
        """The dict that item ``n`` of the run fills, or None: the traced
        items', and a reservoir of ``check_jobs`` drawn from the seed."""
        cap = {} if self.trace and n < self.traffic["trace_jobs"] else None
        if cap is not None:
            self._traced[n] = cap
        k = self.traffic["check_jobs"]
        slot = n if n < k else int(self._pick.integers(0, n + 1))
        if slot < k:
            cap = {} if cap is None else cap
            self._kept[slot] = (n, cap)
        return cap

    def step(self, i):
        p = i % len(self.pages)
        page = self.pages[p]
        n = self._n
        if n is None:
            self._cur = {}
            self._warm.append(self._cur)
        else:
            self._n += 1
            self._cur = self._capture(n)
        try:
            out = self.process(page.image, page.transcript,
                               ocropus_model=self.rec,
                               backend=self.traffic["backend"],
                               verbose=False, device=self.device)
        finally:
            self._cur = None
        if out is None:
            raise RuntimeError(f"page {p}: process() found no characters")
        syl_boxes, _, peaks, chars = out
        js = self.to_json(syl_boxes, peaks)
        return {"page": p, "units": 1, "chars": chars, "n": n,
                "syl_boxes": js["syl_boxes"]}

    def e2e(self, records, t_start, t_end):
        return {"folios_per_s": stats.rate(
            sum(r["units"] for r in records), t_start, t_end)}

    # -- the check ---------------------------------------------------------

    def _page(self, p):
        """The program's strips of page ``p``, its skew and its shapes,
        from its raster and line finder run again (integer and
        deterministic)."""
        if p not in self._pages:
            from text_alignment_tpu_torch.pipeline.preprocess import (
                identify_text_lines, preprocess_images)

            backend, dev, raw = (self.traffic["backend"], self.device,
                                 self.pages[p].image)
            image, eroded, angle = preprocess_images(raw, backend=backend,
                                                     device=dev)
            strips, _, _ = identify_text_lines(image, eroded, backend=backend,
                                               verbose=False, device=dev)
            self._pages[p] = {"strips": strips, "angle": angle,
                              "shapes": (image.shape, raw.shape)}
        return self._pages[p]

    def _sampled(self, records):
        """[(record, lines)] of the sampled items that the run finished;
        a line is {"ink", "frames", "x", "post", "strip"} with the strip's
        onebit image (True = ink), the frames that the normalizer gave,
        the valid frames and posteriors of the BiLSTM, and the re-run
        strip (None where it is not the timed one). None where a sampled
        item's taps hold nothing."""
        done = {r["n"]: r for r in records if r.get("n") is not None}
        out = []
        for n, cap in sorted(self._kept.values(), key=lambda v: v[0]):
            if n not in done:
                continue
            if NORM not in cap or LSTM not in cap:
                return None
            (grey, hs, ws), (frames, lengths, _) = (cap[NORM][0][:3],
                                                    cap[NORM][1])
            x, lens_x = cap[LSTM][0][1], cap[LSTM][0][2]
            grey, frames, x, post = (t.detach().cpu().numpy() for t in (
                grey, frames, x, cap[LSTM][1]))
            hs, ws, lengths, lens_x = (t.cpu().numpy() for t in (
                hs, ws, lengths, lens_x))
            strips = self._page(done[n]["page"])["strips"]
            lines = []
            for b in range(len(hs)):
                h, w = int(hs[b]), int(ws[b])
                if h == 0:
                    continue
                ink = grey[b, :h, :w] == 0
                s = strips[b] if b < len(strips) else None
                same = s is not None and np.array_equal(s.img, ink)
                L = int(lens_x[b])
                lines.append({"ink": ink, "frames": frames[b, :lengths[b]],
                              "x": x[b, :L], "post": post[b, :L],
                              "strip": s if same else None})
            out.append((done[n], lines))
        return out

    def check(self, records):
        items = self._sampled(records)
        numbers = dict.fromkeys(OCR_NUMBERS, float("inf"))
        if items:
            ni = self.config["model"]["ni"]
            off = total = 0
            for _, lines in items:
                for ln in lines:
                    ln["ref_frames"] = lineest.normalize(ln["ink"], ni, PAD)
                    o, t = frames_off(ln["frames"], ln["ref_frames"])
                    off, total = off + o, total + t
            numbers["ocr_frames_off_pct"] = 100.0 * off / max(total, 1)
            self._lines = [ln for _, lines in items for ln in lines]
            self._ref_post = self._posteriors(self._lines, tf32=False)
            numbers["ocr_posterior_err"] = max(
                (float(np.abs(ln["post"] - r).max(initial=0.0))
                 for ln, r in zip(self._lines, self._ref_post)), default=0.0)
            numbers["ocr_chars_diff"] = sum(
                chars_diff(rec["chars"], served(lines, self.charset))
                for rec, lines in items)
            self.log.append(
                f"OCR of {len(items)} sampled items: {len(self._lines)} "
                f"lines, {total} frames, {off} off; "
                f"{sum(len(r['chars']) for r, _ in items)} characters")
        elif items is None:
            self.log.append("a sampled item's taps caught no OCR call")
        n_syl = sum(len(r["syl_boxes"]) for r in records)
        self.log.append(f"syllable boxes compared {n_syl} in "
                        f"{len(records)} items")
        numbers["syl_boxes_diff"] = sum(self._syl_diff(r) for r in records)
        return numbers

    def _posteriors(self, lines, tf32):
        """The reference's posteriors of every line's frames, the lines in
        one batch: [(L, C) arrays]."""
        import torch

        lengths = torch.tensor([len(ln["x"]) for ln in lines],
                               device=self.device)
        frames = torch.zeros((len(lines), max(int(lengths.max()), 1),
                              self.config["model"]["ni"]), device=self.device)
        for i, ln in enumerate(lines):
            frames[i, :len(ln["x"])] = torch.from_numpy(ln["x"])
        with bilstm.precision(tf32=tf32):
            post = bilstm.forward(self.weights, frames, lengths).cpu().numpy()
        return [post[i, :len(ln["x"])] for i, ln in enumerate(lines)]

    def _syl_diff(self, rec):
        """Syllable boxes where the item's JSON differs from the
        reference's assembly of the item's own OCR characters."""
        key = (rec["page"],) + tuple((c.char, c.ul, c.lr)
                                      for c in rec["chars"])
        if key not in self._syl:
            x, page = self._page(rec["page"]), self.pages[rec["page"]]
            self._syl[key] = [
                (b.char, b.ul, b.lr) for b in assemble.syl_boxes(
                    page.transcript, rec["chars"], x["angle"], *x["shapes"])]
        got = [(b["syl"], tuple(b["ul"]), tuple(b["lr"]))
               for b in rec["syl_boxes"]]
        want = self._syl[key]
        return sum(a != b for a, b in zip(got, want)) + abs(
            len(got) - len(want))

    def control(self):
        """The control's numbers on the lines that ``check`` compared: the
        reference one precision down (the normalizer storing bfloat16, the
        BiLSTM with TF32 on) in the program's place."""
        ni = self.config["model"]["ni"]
        off = total = 0
        for ln in self._lines:
            o, t = frames_off(lineest.normalize(ln["ink"], ni, PAD,
                                                rnd=lineest.bf16),
                              ln["ref_frames"])
            off, total = off + o, total + t
        post = self._posteriors(self._lines, tf32=True)
        err = max((float(np.abs(a - b).max(initial=0.0))
                   for a, b in zip(post, self._ref_post)), default=0.0)
        # its characters are its own decode, its syllables the reference's
        # own assembly: both agree with themselves
        return {"ocr_frames_off_pct": 100.0 * off / max(total, 1),
                "ocr_posterior_err": err, "ocr_chars_diff": 0,
                "syl_boxes_diff": 0}

    # -- the traced run ------------------------------------------------------

    def work(self, traced):
        m = self.config["model"]
        w = work.Work()
        for rec in traced:
            cap = self._traced.get(rec.get("n"), {})
            if NORM not in cap:  # an item that failed
                continue
            (grey, hs, ws), lengths = cap[NORM][0][:3], cap[NORM][1][1]
            w.add("bilstm", *ocr_work.bilstm(
                [int(v) for v in lengths.cpu() if v > 0], m["ni"], m["ns"],
                len(m["charset"])))
            w.add("lineest_tail", *ocr_work.lineest_tail(
                hs.cpu().numpy(), ws.cpu().numpy(), *grey.shape[1:]))
        return w

    def spans(self):
        return {}

    def trace_items(self):
        return self.traffic["trace_jobs"]

    def notes(self):
        return [f"{len(self.pages)} folios, blank bias "
                f"{float(self.weights['W2'][0, 0]):.6f}"]

    def free(self):
        if self._untap is not None:
            self._untap()
            self._untap = None
        self.rec = None


def frames_off(got, want):
    """(frames off, frames compared) between the pads of one line: the
    program's (L, ni) frames against the reference's (None for a blank
    strip); every frame where the lengths differ."""
    a = got[PAD:len(got) - PAD] if len(got) > 2 * PAD else got[:0]
    b = (want[PAD:len(want) - PAD] if want is not None
         and len(want) > 2 * PAD else a[:0])
    if a.shape != b.shape:
        n = max(len(a), len(b))
        return n, n
    return int((np.abs(a - b).max(1, initial=0.0) > FRAME_TOL).sum()), len(a)


def decode(post, width, charset):
    """One line's llocs rows [(char, x)] from its (L, C) posteriors, as
    the recognizer returns them (none for a line of pads alone)."""
    if len(post) <= 2 * PAD:
        return []
    return [(charset[c], ctc.llocs_x(f, width, len(post), PAD))
            for _, _, f, c in ctc.regions(post)]


def served(lines, charset):
    """What ``process`` returns as OCR characters for one item: the frozen
    decode of each line's posteriors, placed by its strip and expanded;
    None where a line's strip is not the timed one."""
    if any(ln["strip"] is None for ln in lines):
        return None
    return expand_abbreviations(ctc.charboxes([
        (ln["strip"].offset_x, ln["strip"].offset_y, ln["strip"].height,
         decode(ln["post"], ln["ink"].shape[1], charset)) for ln in lines]))


def chars_diff(got, want):
    """Boxes where ``got`` and ``want`` differ in character or corners,
    plus the difference in count; all of ``got`` (at least 1) where
    ``want`` is None."""
    if want is None:
        return max(len(got), 1)
    return sum((a.char, a.ul, a.lr) != (b.char, b.ul, b.lr)
               for a, b in zip(got, want)) + abs(len(got) - len(want))
