"""Training steps of kraken's default network on a folio's lines of ground
truth: ``models.train.VGSLTrainer.step`` (the CLI's ``train --network
kraken``) over one folio's lines a step, cycling over ``folios`` seeded
pages, in a closed loop.

Set-up does what the CLI's training workflow does with each page: the
port's ``lines`` workflow (``gtedit.extract_lines``) cuts its line crops
into PNG files, each crop is paired with its line of the page's text by
position (:func:`pair_lines`) and normalized at the model's height as
``train`` normalizes it (``normalize_strip`` at 120 rows), and
``batch_lines`` packs a folio's
lines, padded to a frame bucket of a multiple of 128 columns, labels to
the longest line of all pages. The weights come from the seed
(:func:`start_weights`: ``gen/weights_vgsl.py``'s, without the inference
cells' blank bias, with torch's default draw of the convolutions' biases); a
throwaway trainer runs one step at every batch shape, then the timed
trainer is built from the seed.

Traffic keys: ``folios`` (pages, each from its own seed), ``backend`` (the
raster that cuts the crops), ``check_steps`` (steps the check recomputes),
``trace_steps`` (steps the traced run profiles).

How ``correct`` is decided. Set-up taps ``models.vgsl.dropout_mask``, the
one function that draws every dropout mask of the training forward. For
``check_steps`` steps of the run drawn from the seed as they come (a
reservoir), the step keeps, in the timed call: before it, a copy of the
weights and of Adam's count and moments; while it runs, every mask the
tap sees; after it, the loss it returned, every gradient and the weights.
After the window ``reference/vgsl_train.py`` recomputes each kept step,
each line alone at its own length, with the kept weights and each line's
slice of the kept masks, and Adam's update from the kept moments and its
own gradients:

- ``train_loss_err``: |program - reference| / max(1, |reference|) of the
  step's summed loss, the largest over the kept steps;
- ``train_grad_err``: over the kept steps and the weight tensors, the
  largest max |program - reference| / max |reference| of a tensor's
  gradient;
- ``train_update_err``: over the kept steps and the weight tensors, the
  largest ||program's change - reference's|| / ||reference's change|| of
  a tensor, the program's change being its weights after the step less
  those before: a step that leaves the weights as they were reads 1;
- ``train_dropout_sites_missing``: the configuration's dropout sites
  (``train.dropout``, in order) for which, in some kept step, the tap saw
  no mask of the site's shape with values 0 and 1 / (1 - p), or whose
  share of zeros, pooled over the kept steps, lies more than ``RATE_Z``
  binomial standard deviations from p; plus the most masks a kept step
  drew beyond the sites. The reference takes a mask of ones where one is
  missing.

The control puts the reference one precision down in the program's place:
TF32 on in its convolutions and products, against the same reference
with TF32 off, on the same steps.

The limits (``limits/kraken_train.train_kraken.json``, ``benchmark.
calibrate`` on 12 seeds and six runs on an H100; ``PERF.md`` §4):
``train_loss_err`` 5e-5, ~10x over the program's most (5.2e-6) and ~13x
under the control's least (6.5e-4): the summed loss is a sum of positive
terms and agrees to float32's rounding; ``train_grad_err`` 0.15, ~3x over
the program's most (0.045) and ~3x under the control's least (0.51): a
gradient is a sum of terms of both signs, and float32's order
differences, or a tie in a max-pool broken the other way, move a small
gradient tensor's largest entry by up to a few percent; TF32 moves
them by tens of percent (a second calibration, 12 seeds at 12 steps: the
program at most 6.9e-6 and 5.9e-3, the control at least 2.8e-4 and
0.32); ``train_update_err`` 0.3, set between the program's most (0.071)
and the 1 of a step that changes nothing, with more room above the
reading: Adam's first steps move each weight by about lr g / |g|, so a
gradient entry within rounding of 0 can take the other sign and move
its weight by 2 lr, which is 2 / sqrt(800) = 0.071 in an LSTM bias of
800; the control reads 0.15-0.70, and the program 4.2e-4-1.6e-3 in
runs of 51 s, whose kept steps come late; ``train_dropout_sites_missing``
0."""

from __future__ import annotations

import math
import os
import time

import numpy as np

from .. import common, stats, work
from ..gen import weights_vgsl
from ..reference import vgsl_train
from ..work import vgsl_train as train_work
from . import jobs_kraken

BUCKET = 128      # the frame bucket's step, in normalized columns
NUMBERS = ("train_loss_err", "train_grad_err", "train_update_err",
           "train_dropout_sites_missing")
# a dropout site's pooled share of zeros may lie this many binomial
# standard deviations from p (a sound site leaves it with odds ~2e-9)
RATE_Z = 6.0


class Cell:
    def __init__(self, config, traffic, seed, device, workdir, trace):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.trace = device, trace
        self.workdir = workdir
        self.log = []
        self._n, self._cur = 0, None
        self._kept = {}
        self._pick = common.rng(seed, 31)
        self._untap = None
        self.trainer = None
        self.dropped = 0
        self.setup_s = {}

    # -- set-up --------------------------------------------------------------

    def setup(self):
        from text_alignment_tpu_torch.models.codec import Codec
        from text_alignment_tpu_torch.models.train import VGSLTrainer

        m = self.config["model"]
        self.codec = Codec(m["charset"])
        t0 = time.perf_counter()
        pages = common.make_pages(self.config, self.seed,
                                  self.traffic["folios"], tag=30)
        self._phase("pages", t0)
        folios = [self._lines(i, p) for i, p in enumerate(pages)]
        S = max(len(t) for _, texts in folios for t in texts)
        self.batches = [self._batch(frames, texts, S)
                        for frames, texts in folios]
        t0 = time.perf_counter()
        self.weights = start_weights(self.config, self.seed, self.device)
        warm = VGSLTrainer(self.codec, self._program_params(), lr=self._lr(),
                           seed=0, device=self.device, height=m["height"])
        seen = set()
        for b in self.batches:
            if b[0].shape not in seen:
                seen.add(b[0].shape)
                warm.step(*b)
        del warm
        self.trainer = VGSLTrainer(
            self.codec, self._program_params(), lr=self._lr(),
            seed=common.sub_seed(self.seed, 32), device=self.device,
            height=m["height"])
        self._phase("weights and warm-up", t0)
        self._tap()

    def _phase(self, name, t0):
        self.setup_s[name] = self.setup_s.get(name, 0.0) + (
            time.perf_counter() - t0)

    def _lr(self):
        return float(self.config["train"]["lr"])

    def _lines(self, i, page):
        """(frames, texts) of one page's lines: the crops of the ``lines``
        workflow (``gtedit.extract_lines``' two steps: the line finder's
        strips, each written as a PNG file), read back and normalized as
        ``train`` does, each paired with its line of the page's text."""
        from PIL import Image

        from text_alignment_tpu_torch.gtedit import save_line_png
        from text_alignment_tpu_torch.models.lineest_host import (
            CenterNormalizer, normalize_strip)
        from text_alignment_tpu_torch.training_data import (
            union_line_strips)

        t0 = time.perf_counter()
        _, strips = union_line_strips(page.image,
                                      backend=self.traffic["backend"],
                                      device=self.device)
        self._phase("line finding", t0)
        t0 = time.perf_counter()
        texts, centres = line_texts(page, self.config["page"]["gap"])
        pairs = pair_lines([s.offset_y + s.img.shape[0] / 2 for s in strips],
                           centres)
        if not pairs:
            raise RuntimeError(f"page {i}: no line crop")
        frames, paired = [], []
        for k, (c, t) in enumerate(pairs):
            path = os.path.join(self.workdir, f"p{i:03d}_{k:04d}.png")
            save_line_png(strips[c].img, path)
            norm = normalize_strip(np.asarray(Image.open(path)),
                                   CenterNormalizer(
                                       self.config["model"]["height"]))
            if norm is not None:
                frames.append(norm[0])
                paired.append(texts[t])
        self.dropped += len(strips) + len(texts) - 2 * len(frames)
        self._phase("crops written, read and normalized", t0)
        return frames, paired

    def _batch(self, frames, texts, S):
        from text_alignment_tpu_torch.models.train import batch_lines

        T = BUCKET * math.ceil(max(len(f) for f in frames) / BUCKET)
        return batch_lines(frames, texts, self.codec, T=T, S=S)

    # the program's copy of the benchmark's weights, as the jobs cell
    # makes it
    _program_params = jobs_kraken.Cell._program_params

    def _tap(self):
        """While ``self._cur`` is a dict, every mask the training forward
        draws is appended to its ``masks``."""
        from text_alignment_tpu_torch.models import vgsl

        orig = vgsl.dropout_mask

        def tapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self._cur is not None:
                self._cur["masks"].append(out.detach().clone())
            return out

        vgsl.dropout_mask = tapped
        self._untap = lambda: setattr(vgsl, "dropout_mask", orig)

    # -- the window ----------------------------------------------------------

    def _capture(self, n):
        """The dict that step ``n`` of the run fills, or None: a reservoir
        of ``check_steps`` drawn from the seed."""
        k = self.traffic["check_steps"]
        slot = n if n < k else int(self._pick.integers(0, n + 1))
        if slot >= k:
            return None
        cap = {"n": n, "weights": self.trainer.params,
               "moments": adam_moments(self.trainer), "masks": []}
        self._kept[slot] = (n, cap)
        return cap

    def step(self, i):
        f = i % len(self.batches)
        n = self._n
        self._n += 1
        cap = self._capture(n)
        self._cur = cap
        try:
            loss = self.trainer.step(*self.batches[f])
        finally:
            self._cur = None
        if cap is not None:
            cap.update(folio=f, loss=loss, grads=self.trainer.grads,
                       after=self.trainer.params)
        return {"folio": f, "units": 1, "n": n, "loss": loss}

    def e2e(self, records, t_start, t_end):
        return {"folios_per_s": stats.rate(
            sum(r["units"] for r in records), t_start, t_end)}

    # -- the check -----------------------------------------------------------

    def _steps(self, records):
        """The kept steps that the run finished, in run order."""
        done = {r["n"] for r in records if r.get("n") is not None}
        return [cap for n, cap in sorted(self._kept.values(),
                                         key=lambda v: v[0])
                if n in done and "grads" in cap]

    def _site_shapes(self, batch):
        """The mask shape of each dropout site over a batch."""
        m = self.config["model"]
        B, T = batch[0].shape[:2]
        F = 2 * m["hidden"]
        shapes = [(B, c, 1, 1) for _, _, c in m["convs"]]
        for s in self.config["train"]["dropout"][len(shapes):]:
            shapes.append((B, 1, F) if s["dims"] == 2 else (B, T // 8, F))
        return shapes

    def _masks(self, cap):
        """(the kept step's masks, site by site, a mask of ones where the
        site's is missing; the missing sites' indices; the masks drawn
        beyond the sites)."""
        import torch

        sites = self.config["train"]["dropout"]
        got = cap["masks"]
        masks, missing = [], set()
        for k, (s, shape) in enumerate(zip(
                sites, self._site_shapes(self.batches[cap["folio"]]))):
            m = got[k] if k < len(got) else None
            if m is None or tuple(m.shape) != shape or not is_mask(
                    m, s["p"]):
                missing.add(k)
                m = torch.ones(shape, device=self.device)
            masks.append(m)
        return masks, missing, max(0, len(got) - len(sites))

    def _sites_missing(self, caps):
        """``train_dropout_sites_missing`` over the kept steps (module
        doc)."""
        sites = self.config["train"]["dropout"]
        missing, beyond = set(), 0
        zeros, total = [0] * len(sites), [0] * len(sites)
        for cap in caps:
            masks, gone, extra = self._masks(cap)
            missing |= gone
            beyond = max(beyond, extra)
            for k, m in enumerate(masks):
                zeros[k] += int((m == 0).sum())
                total[k] += m.numel()
        for k, s in enumerate(sites):
            if not rate_holds(zeros[k], total[k], s["p"]):
                missing.add(k)
        return len(missing) + beyond

    def _lines_of(self, cap, masks):
        """The reference's lines of a kept step: frames, labels and each
        line's slice of the masks."""
        xs, xl, lb, ll = self.batches[cap["folio"]]
        n_conv = len(self.config["model"]["convs"])
        dims = [s["dims"] for s in self.config["train"]["dropout"]]
        lines = []
        for b in range(len(xl)):
            n = int(xl[b]) // 8
            lines.append({
                "x": xs[b, :xl[b]], "labels": lb[b, :ll[b]],
                "masks": ([m[b, :, 0, 0] for m in masks[:n_conv]]
                          + [m[b, 0] if d == 2 else m[b, :n] for m, d in
                             zip(masks[n_conv:], dims[n_conv:])])})
        return lines

    def _reference(self, caps, tf32):
        """[(loss, gradients, Adam's change to the weights)] of the
        reference on each kept step."""
        t = self.config["train"]
        out = []
        for cap in caps:
            masks = self._masks(cap)[0]
            loss, grads, _ = vgsl_train.step(
                reference_weights(cap["weights"]),
                self._lines_of(cap, masks), tf32=tf32)
            grads = vgsl_train.leaves(grads)
            count, mu, nu = cap["moments"]
            change = vgsl_train.adam_update(
                grads, flat(mu), flat(nu), count, float(t["lr"]),
                tuple(t["betas"]), float(t["eps"]))
            out.append((loss, grads, change))
        return out

    def check(self, records):
        numbers = dict.fromkeys(NUMBERS, float("inf"))
        caps = self._steps(records)
        self.log.append(f"trainer counters after the run: "
                        f"{self.trainer.counters}")
        if not caps:
            self.log.append("no kept step finished")
            return numbers
        self._caps = caps
        self._ref = self._reference(caps, tf32=False)
        got = [(cap["loss"], flat(cap["grads"]),
                [a - b for a, b in zip(flat(cap["after"]),
                                       flat(cap["weights"]))])
               for cap in caps]
        numbers.update(compare(got, self._ref))
        numbers["train_dropout_sites_missing"] = self._sites_missing(caps)
        self.log.append(
            f"recomputed run steps {[cap['n'] for cap in caps]}: losses "
            f"{[cap['loss'] for cap in caps]}, reference "
            f"{[r[0] for r in self._ref]}")
        return numbers

    def control(self):
        """The reference with TF32 on against the reference with it off,
        on the kept steps."""
        out = compare(self._reference(self._caps, tf32=True), self._ref)
        out["train_dropout_sites_missing"] = 0
        return out

    # -- the traced run ------------------------------------------------------

    def work(self, traced):
        m = self.config["model"]
        w = work.Work()
        for rec in traced:
            if not rec.get("ok", True) or "folio" not in rec:
                continue
            lengths = [int(v) for v in self.batches[rec["folio"]][1]]
            conv, whole = train_work.step(lengths, m["height"], m["convs"],
                                          m["hidden"], m["layers"],
                                          len(m["charset"]))
            w.add("vgsl_conv_train", *conv)
            w.add("vgsl_train", *whole)
        return w

    def spans(self):
        return {}

    def trace_items(self):
        return self.traffic["trace_steps"]

    def notes(self):
        lines = [len(b[1]) for b in self.batches]
        phases = ", ".join(f"{k} {v:.3f} s" for k, v in self.setup_s.items())
        return [f"{len(self.batches)} folios, {sum(lines)} lines "
                f"({min(lines)}-{max(lines)} a folio; {self.dropped} crops "
                f"or lines of text left unpaired), frame buckets "
                f"{sorted({b[0].shape[1] for b in self.batches})}, labels "
                f"{self.batches[0][2].shape[1]} wide",
                f"set-up by phase: {phases}"]

    def free(self):
        if self._untap is not None:
            self._untap()
            self._untap = None


def start_weights(config, seed, device):
    """The weights a step starts from: ``gen/weights_vgsl.py``'s draw, with
    each convolution's bias drawn as torch's default initialization draws
    it (uniform in +-1 / sqrt(fan_in)), which kraken's trainer starts from.
    With the draw's biases of 0 a blank region's preactivation is exactly
    0, on the ReLU's kink, where a float32 convolution's rounding (its FFT
    route's ~1e-7) decides the gradient of the bias."""
    import torch

    w = weights_vgsl.vgsl_weights(config, seed, device)
    g = torch.Generator(device=device)
    g.manual_seed(common.sub_seed(seed, 33))
    for i, (wt, _) in enumerate(w["conv"]):
        bound = 1.0 / math.sqrt(wt[0].numel())
        b = (torch.rand(wt.shape[0], generator=g, device=device) * 2 - 1)
        w["conv"][i] = (wt, b * bound)
    return w


def line_texts(page, gap):
    """(the page's lines of text, their vertical centres), top to bottom:
    each line's glyph boxes left to right, a space where two boxes stand
    further apart than the glyph ``gap`` (a word break)."""
    rows = {}
    for b in page.char_boxes:
        rows.setdefault(b.uly, []).append(b)
    texts, centres = [], []
    for y in sorted(rows):
        boxes = sorted(rows[y], key=lambda b: b.ulx)
        text = boxes[0].char
        for a, b in zip(boxes, boxes[1:]):
            text += (" " if b.ulx - a.lrx > gap else "") + b.char
        texts.append(text)
        centres.append((boxes[0].uly + boxes[0].lry) / 2)
    if " ".join(texts) != page.transcript:
        raise RuntimeError("the page's lines do not spell its transcript")
    return texts, centres


def pair_lines(crops, lines):
    """[(crop, line)] indices pairing crops and lines of text by their
    vertical centres: each crop goes to the line nearest to it once the
    crops' median offset from their nearest lines is taken off (the
    deskewed page's frame sits a fixed distance from the page's), and a
    line keeps its first crop. The line finder sometimes cuts a line
    twice or misses one; such crops and lines are left out, as a person
    correcting the ground truth would leave them."""
    lines = np.asarray(lines, float)

    def nearest(y):
        return int(np.argmin(np.abs(lines - y)))

    shift = float(np.median([y - lines[nearest(y)] for y in crops])) \
        if crops else 0.0
    out, taken = [], set()
    for c, y in enumerate(crops):
        t = nearest(y - shift)
        if t not in taken:
            taken.add(t)
            out.append((c, t))
    return out


def adam_moments(trainer):
    """(Adam's count, its first moments, its second moments) of a
    ``VGSLTrainer``, the moments copies in the weights' layout on their
    device; zeros before the first step."""
    import torch

    from text_alignment_tpu_torch.models import vgsl

    params = trainer.model.leaves()
    state = [trainer.optimizer.state.get(p) or {} for p in params]
    count = int(state[0]["step"]) if state[0] else 0

    def moments(key):
        return vgsl.from_leaves(
            [s[key].detach().clone() if s else torch.zeros_like(p)
             for s, p in zip(state, params)], len(trainer.model.conv))

    return count, moments("exp_avg"), moments("exp_avg_sq")


def is_mask(m, p):
    """Whether every value of ``m`` is 0 or 1 / (1 - p)."""
    keep = 1.0 / (1.0 - p)
    return bool(((m == 0) | ((m - keep).abs() <= 1e-6 * keep)).all())


def rate_holds(zeros, n, p):
    """Whether ``zeros`` of ``n`` Bernoulli(p) draws lie within ``RATE_Z``
    standard deviations of n p."""
    return abs(zeros - n * p) <= RATE_Z * math.sqrt(n * p * (1 - p))


def reference_weights(p):
    """The program's ``VGSLParams`` (weights or gradients) in the
    reference's dict layout, on their device."""
    keys = vgsl_train.KEYS
    return {"conv": [(w, b) for w, b in p.conv],
            "lstm": [{d: {k: getattr(getattr(layer, d), k) for k in keys}
                      for d in ("fwd", "bwd")} for layer in p.lstm],
            "W": p.W, "b": p.b}


def flat(p):
    """The tensors of ``VGSLParams`` ``p`` in the reference's order
    (``vgsl_train.leaves``)."""
    return vgsl_train.leaves(reference_weights(p))


def compare(got, want):
    """``train_loss_err``, ``train_grad_err`` and ``train_update_err`` of
    [(loss, [gradient tensors], [changes to the weight tensors])] against
    the same of the reference; inf where a number is not finite."""
    loss_err, grad_err, update_err = [0.0], [0.0], [0.0]
    for (lg, gg, cg), (lw, gw, cw) in zip(got, want):
        loss_err.append(abs(lg - lw) / max(1.0, abs(lw)))
        for a, b in zip(gg, gw):
            scale = max(float(b.abs().max()), 1e-30)
            grad_err.append(float((a - b).abs().max()) / scale)
        for a, b in zip(cg, cw):
            scale = max(float(b.norm()), 1e-30)
            update_err.append(float((a - b).norm()) / scale)
    return {"train_loss_err": _worst(loss_err),
            "train_grad_err": _worst(grad_err),
            "train_update_err": _worst(update_err)}


def _worst(xs):
    """The largest of ``xs``; inf where one is not finite (NaN included,
    which ``max`` would pass over)."""
    return max(x if math.isfinite(x) else float("inf") for x in xs)
