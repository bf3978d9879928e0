"""The recognizer's seeded weights, made on the device in one call of a
``torch.Generator`` there: ocropy's layout, float32, as the configuration's
``weights`` section states them. The gate matrices' input columns are
uniform in +-``input_range``, their bias and recurrent columns and the
peepholes in +-``recurrent_range``, the softmax layer in
+-``output_range``, but for its blank row, which is 0 but for a bias.

The bias puts the blank posterior below ocropy's 0.7 on ``BLANK_SHARE`` of
the frames of a calibration page drawn from the seed (the configuration's
geometry, unskewed), so that the region decode emits characters on every
seed. The calibration's frames are cut by the benchmark itself: each
line's glyph rows, 2 ``char_h`` high about the glyphs' centre as the
normalizer's dewarp window is, zoomed bilinearly to the model's height,
ink 1, with ocropy's 16 blank frames at either end. The forward pass is the
plain reference's."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import common
from ..reference import bilstm
from .synth import make_page

BLANK_SHARE = 0.2
PAD = 16


def _uniform(g, n, device):
    return torch.rand(n, generator=g, device=device) * 2 - 1


def bilstm_weights(config, seed, device):
    """{"fwd": {WGI, WGF, WGO, WCI, WIP, WFP, WOP}, "bwd": {...}, "W2"}
    on ``device``; W2's blank row is 0."""
    m, w = config["model"], config["weights"]
    ni, ns, nout = m["ni"], m["ns"], len(m["charset"])
    na = 1 + ni + ns
    g = torch.Generator(device=device)
    g.manual_seed(common.sub_seed(seed, 10))
    n_gates, n_peep = 2 * 4 * ns * na, 2 * 3 * ns
    u = _uniform(g, n_gates + n_peep + nout * (2 * ns + 1), device)
    cols = torch.full((na,), float(w["recurrent_range"]), device=device)
    cols[1:1 + ni] = float(w["input_range"])
    gates = u[:n_gates].view(2, 4, ns, na) * cols
    peep = u[n_gates:n_gates + n_peep].view(2, 3, ns) * w["recurrent_range"]
    W2 = u[n_gates + n_peep:].view(nout, 2 * ns + 1) * w["output_range"]
    W2[0] = 0.0
    out = {"W2": W2}
    for d, name in enumerate(("fwd", "bwd")):
        out[name] = {k: gates[d, i] for i, k in enumerate(bilstm.GATES)}
        out[name].update(WIP=peep[d, 0], WFP=peep[d, 1], WOP=peep[d, 2])
    return out


def calibration_frames(config, seed, device):
    """(frames (n_lines, T, height), lengths) of the calibration page."""
    p = dict(config["page"], angle=0.0)
    page = make_page(common.rng(seed, 9), **p)
    ink = torch.from_numpy(page.image[..., 0] == 0).to(device).float()
    height, ch = config["model"]["ni"], p["char_h"]
    lines = []
    for y0 in sorted({b.uly for b in page.char_boxes}):
        boxes = [b for b in page.char_boxes if b.uly == y0]
        x0, x1 = min(b.ulx for b in boxes), max(b.lrx for b in boxes)
        mid = y0 + ch // 2
        band = ink[max(mid - ch, 0):mid + ch, x0:x1]
        T = max(1, round((x1 - x0) * height / (2 * ch)))
        z = F.interpolate(band[None, None], size=(height, T),
                          mode="bilinear", align_corners=True)[0, 0]
        lines.append(F.pad(z.T, (0, 0, PAD, PAD)))
    lengths = torch.tensor([len(x) for x in lines], device=device)
    frames = torch.zeros((len(lines), int(lengths.max()), height),
                         device=device)
    for i, x in enumerate(lines):
        frames[i, :len(x)] = x
    return frames, lengths


def blank_bias(weights, frames, lengths, share=BLANK_SHARE):
    """The blank row's bias b under which the blank posterior, 1 / (1 +
    sum_k exp(l_k - b)) over the other classes' logits l_k, is below 0.7
    on ``share`` of the valid frames."""
    with bilstm.precision(tf32=False):
        y = bilstm.hidden(weights, frames, lengths)
        logits = (y @ weights["W2"][1:].T).clamp(-100, 100)
    valid = (torch.arange(frames.shape[1], device=frames.device)[None, :]
             < lengths[:, None])
    cut = math.log(0.7 / 0.3) + torch.logsumexp(logits, 2)[valid]
    return float(torch.quantile(cut.double(), 1.0 - share))


def recognizer_weights(config, seed, device):
    """The seeded weights with the blank bias set from the calibration
    page."""
    w = bilstm_weights(config, seed, device)
    w["W2"][0, 0] = blank_bias(w, *calibration_frames(config, seed, device))
    return w
