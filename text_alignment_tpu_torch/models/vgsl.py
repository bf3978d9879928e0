"""kraken's default line recognizer, inference and training, in PyTorch,
on the port's frames: the VGSL network of ``RECOGNITION_SPEC`` (``kraken/lib/
default_specs.py``, https://github.com/mittagessen/kraken) with its
output layer ``O1c<classes>``::

    [1,120,0,1 Cr3,13,32 Do0.1,2 Mp2,2 Cr3,13,32 Do0.1,2 Mp2,2
     Cr3,9,64 Do0.1,2 Mp2,2 Cr3,9,64 Do0.1,2 S1(1x0)1,3 Lbx200 Do0.1,2
     Lbx200 Do0.1,2 Lbx200 Do]

Dropout is the identity at inference. For one line of W columns of
``height`` rows: four convolutions (kernel kh x kw, zero padding (kh // 2,
kw // 2), bias, ReLU), a 2 x 2 max-pool of stride 2 (floor) after the
first three, the height folded into the features, three bidirectional
LSTM layers (``torch.nn.LSTM``'s cell: no peepholes, both biases, output
[forward; backward]), then the linear head and a softmax (no clip).
Posterior f covers normalized columns 8f .. 8f + 7.

:func:`vgsl_forward_batched` takes the device normalizer's (B, T, height)
frames (ink 1, the recognizer's blank pad frames at either end) with each
line's valid length, in a batch padded to a frame bucket. Before every
convolution it zeroes the columns at or past the line's width at that
stage (L, L // 2, L // 4, L // 8), where a line alone has the
convolution's zero padding, so that each line of a padded batch gets
what it gets alone, at its own width, as kraken recognizes one line at a
time. No valid column reads one past the width otherwise: a pooled
column reads two valid ones, and each LSTM direction reads only valid
frames for valid outputs. The convolutions and pools are ``torch.nn.
functional``'s (cuDNN on the card; float32, TF32 off under
:func:`.lstm.pin_float32`); each LSTM layer's recurrence is
:func:`.lstm_kernel.bidir_scan` (the CUDA kernel on the card, its plain
version on the CPU) with zero peepholes, which makes its cell
``torch.nn.LSTM``'s exactly.

The fold is channel-major: feature c * H3 + y of ``reshape(B, C * H3,
T3)`` of the (B, C, H3, T3) conv output. kraken's ``S1(1x0)1,3`` orders
the same 960 features another way, a fixed permutation of the columns of
the first layer's ``weight_ih``, which a loader of kraken's weights
applies once.

Weights (:class:`VGSLParams`) keep kraken's ``TorchVGSLModel`` layout,
``torch.nn.LSTM``'s per direction (gate rows i, f, g, o; ``bias_ih`` and
``bias_hh``). :func:`kernel_params` makes, once, the :class:`VGSLNet`
that :func:`vgsl_forward_batched` runs: each layer's two directions
stacked, the gate chunks in the kernel's [gi | gf | go | ci] order
(:func:`kernel_gates`) and the biases summed.

Training (:class:`VGSLModel`, driven by :class:`.train.VGSLTrainer`) runs
the same front end, :func:`conv_features` with its masks, with the spec's
seven dropout sites active (:data:`DROPOUT`: ``Do0.1,2`` after each
convolution and after LSTM layers 1 and 2 zeroes a whole channel of a
line, the final ``Do`` each value with p 0.5), every mask drawn from the
trainer's ``torch.Generator`` through :func:`dropout_mask`. Its recurrence
is ``torch.nn.LSTM`` (cuDNN on the card), one bidirectional layer at a
time in the weights' own layout, packed by each line's frame count, as
kraken trains; its head gives log-probabilities. The weights it trains
are :class:`VGSLParams`, which :class:`..recognizer.SeqRecognizer` runs
unchanged; :func:`save_vgsl` and :func:`load_vgsl` keep them in a
pickle-free ``.npz``.
"""

from __future__ import annotations

import io
import json
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..utils.timing import span
from .lstm import _reverse_by_length
from .lstm_kernel import bidir_scan

SPEC = ("[1,120,0,1 Cr3,13,32 Do0.1,2 Mp2,2 Cr3,13,32 Do0.1,2 Mp2,2 "
        "Cr3,9,64 Do0.1,2 Mp2,2 Cr3,9,64 Do0.1,2 S1(1x0)1,3 Lbx200 "
        "Do0.1,2 Lbx200 Do0.1,2 Lbx200 Do]")
HEIGHT = 120
CONVS = ((3, 13, 32), (3, 13, 32), (3, 9, 64), (3, 9, 64))  # kh, kw, out
POOLED = (True, True, True, False)  # an Mp2,2 after the conv
HIDDEN = 200
LAYERS = 3
STRIDE = 8  # normalized columns a posterior: 2 ** (the pools)


class LSTMDirection(NamedTuple):
    """One direction of a ``torch.nn.LSTM`` layer, in its own layout."""
    weight_ih: torch.Tensor  # (4 ns, nin), gate rows i, f, g, o
    weight_hh: torch.Tensor  # (4 ns, ns)
    bias_ih: torch.Tensor    # (4 ns,)
    bias_hh: torch.Tensor    # (4 ns,)


class BiLSTMLayer(NamedTuple):
    fwd: LSTMDirection
    bwd: LSTMDirection       # the ``_reverse`` weights


class VGSLParams(NamedTuple):
    conv: tuple   # ((weight (out, in, kh, kw), bias (out,)), ...), 4 of them
    lstm: tuple   # (BiLSTMLayer, ...), 3 of them
    W: torch.Tensor  # (classes, 2 ns)
    b: torch.Tensor  # (classes,)

    def to(self, device) -> "VGSLParams":
        return _map(self, lambda t: t.to(device))


class ScanLayer(NamedTuple):
    """One bidirectional layer in the recurrence kernel's layout: both
    directions stacked [forward, backward], gate chunks [gi | gf | go |
    ci]."""
    wx: torch.Tensor    # (2, 4 ns, nin)
    bias: torch.Tensor  # (2, 4 ns): bias_ih + bias_hh
    whT: torch.Tensor   # (2, ns, 4 ns)
    peep: torch.Tensor  # (2, 3, ns) zeros: torch.nn.LSTM has no peepholes


class VGSLNet(NamedTuple):
    """:class:`VGSLParams` as :func:`vgsl_forward_batched` runs it, made
    once by :func:`kernel_params`: the LSTM layers as :class:`ScanLayer`."""
    conv: tuple   # as VGSLParams.conv
    lstm: tuple   # (ScanLayer, ...)
    W: torch.Tensor
    b: torch.Tensor

    def leaves(self) -> list:
        """Every weight tensor, in a fixed order."""
        out = [t for wb in self.conv for t in wb]
        for layer in self.lstm:
            out += [layer.wx, layer.bias, layer.whT]
        return out + [self.W, self.b]


def _map(p: VGSLParams, fn) -> VGSLParams:
    return VGSLParams(
        tuple((fn(w), fn(b)) for w, b in p.conv),
        tuple(BiLSTMLayer(LSTMDirection(*map(fn, layer.fwd)),
                          LSTMDirection(*map(fn, layer.bwd)))
              for layer in p.lstm),
        fn(p.W), fn(p.b))


def init_params_np(rng, classes: int, height: int = HEIGHT,
                   convs=CONVS, hidden: int = HIDDEN, layers: int = LAYERS):
    """Random weights of the network at the given widths (the spec's by
    default), in a numpy-dict format, drawn from the numpy Generator
    ``rng`` with PyTorch's default initialization: uniform in +-1 /
    sqrt(fan_in) for the convolutions and the head, +-1 / sqrt(hidden)
    for the LSTMs. ``height`` must halve three times to a whole number."""
    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    conv, cin = [], 1
    for kh, kw, cout in convs:
        k = 1.0 / np.sqrt(cin * kh * kw)
        conv.append({"weight": u(k, cout, cin, kh, kw), "bias": u(k, cout)})
        cin = cout
    if height % 8:
        raise ValueError(f"height {height}: not a multiple of 8")
    nin, k = cin * height // 8, 1.0 / np.sqrt(hidden)
    lstm = []
    for _ in range(layers):
        lstm.append({d: {"weight_ih": u(k, 4 * hidden, nin),
                         "weight_hh": u(k, 4 * hidden, hidden),
                         "bias_ih": u(k, 4 * hidden),
                         "bias_hh": u(k, 4 * hidden)}
                     for d in ("fwd", "bwd")})
        nin = 2 * hidden
    k = 1.0 / np.sqrt(nin)
    return {"conv": conv, "lstm": lstm, "W": u(k, classes, nin),
            "b": u(k, classes)}


def params_from_np(d, device="cpu") -> VGSLParams:
    """VGSLParams from :func:`init_params_np`'s format."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def direction(x):
        return LSTMDirection(*(t(x[k]) for k in LSTMDirection._fields))

    return VGSLParams(
        tuple((t(c["weight"]), t(c["bias"])) for c in d["conv"]),
        tuple(BiLSTMLayer(direction(x["fwd"]), direction(x["bwd"]))
              for x in d["lstm"]),
        t(d["W"]), t(d["b"]))


def frame_columns(frames):
    """The normalized column of each posterior frame: the centre of its
    pooled window, 8f + 4. kraken places a character by the pooled
    window's own span instead; this centre keeps the recognizer's wire
    and llocs positions in normalized columns."""
    return frames * STRIDE + STRIDE // 2


def kernel_gates(d: LSTMDirection):
    """(Wx (4 ns, nin), Wh (4 ns, ns), bias (4 ns,)) of one direction with
    the gate chunks in the kernel's [gi | gf | go | ci] order, from
    ``torch.nn.LSTM``'s (i, f, g, o), and the two biases summed."""
    ns = d.weight_hh.shape[1]

    def order(t):
        return torch.cat([t[:2 * ns], t[3 * ns:], t[2 * ns:3 * ns]])

    return (order(d.weight_ih), order(d.weight_hh),
            order(d.bias_ih + d.bias_hh))


def _mask(x, widths):
    """x (B, C, H, T) with the columns at or past each line's width set
    to 0."""
    keep = (torch.arange(x.shape[3], device=x.device)[None, :]
            < widths.to(x.device)[:, None])
    return torch.where(keep[:, None, None, :], x, 0.0)


def conv_features(params: VGSLNet, frames, lengths, dropout=None):
    """The conv front end and the fold: (B, T3, C * H3) features and their
    lengths, from (B, T, height) frames of ``lengths`` valid columns.
    ``dropout``: None at inference; in training, the callable that applies
    each convolution's dropout site to its output after the ReLU."""
    widths = lengths.long()
    x = frames.transpose(1, 2)[:, None]
    for (w, b), pooled in zip(params.conv, POOLED):
        x = F.relu(F.conv2d(_mask(x, widths), w, b,
                            padding=(w.shape[2] // 2, w.shape[3] // 2)))
        if dropout is not None:
            x = dropout(x)
        if pooled:
            x = F.max_pool2d(x, 2)
            widths = widths // 2
    B, C, H3, T3 = x.shape
    return x.reshape(B, C * H3, T3).transpose(1, 2).contiguous(), widths


def scan_layer(layer: BiLSTMLayer) -> ScanLayer:
    """One ``torch.nn.LSTM`` layer in the kernel's layout."""
    (fx, fh, fb), (bx, bh, bb) = kernel_gates(layer.fwd), kernel_gates(
        layer.bwd)
    return ScanLayer(torch.stack([fx, bx]), torch.stack([fb, bb]),
                     torch.stack([fh.T, bh.T]).contiguous(),
                     fx.new_zeros((2, 3, fh.shape[1])))


def kernel_params(params: VGSLParams) -> VGSLNet:
    """The network in the layout :func:`vgsl_forward_batched` runs, on
    the weights' device."""
    return VGSLNet(params.conv, tuple(map(scan_layer, params.lstm)),
                   params.W, params.b)


def scan_inputs(layer: ScanLayer, xs, lengths):
    """The recurrence's inputs for one layer over (B, T, nin): (gx (2, T,
    B, 4 ns), whT, peep), the backward direction's frames reversed per
    line by ``lengths``."""
    xs2 = torch.stack([xs, _reverse_by_length(xs, lengths)])   # (2,B,T,nin)
    gx = (torch.einsum("dbti,dgi->dtbg", xs2, layer.wx)
          + layer.bias[:, None, None, :]).contiguous()
    return gx, layer.whT, layer.peep


def bilstm_layer(layer: ScanLayer, xs, lengths):
    """One bidirectional layer over (B, T, nin): (B, T, 2 ns), [forward;
    backward] a frame; frames past a line's length are meaningless."""
    hs = bidir_scan(*scan_inputs(layer, xs, lengths))          # (2,T,B,ns)
    f = hs[0].transpose(0, 1)
    b = _reverse_by_length(hs[1].transpose(0, 1), lengths)
    return torch.cat([f, b], dim=2)


def vgsl_forward_batched(params: VGSLNet, frames, lengths):
    """The network of :func:`kernel_params` on frames: (B, T, height)
    float32, ink 1; lengths: (B,) valid columns.
    Returns (posteriors (B, T // 8, classes), their lengths (B,) =
    lengths // 8); posteriors past a line's length are meaningless."""
    with span("ta.ocr.conv"):
        xs, n = conv_features(params, frames, lengths)
    for layer in params.lstm:
        with span("ta.ocr.lstm"):
            xs = bilstm_layer(layer, xs, n)
    with span("ta.ocr.head"):
        post = torch.softmax(torch.matmul(xs, params.W.T) + params.b, dim=2)
    return post, n


# -- training ---------------------------------------------------------------

# the spec's dropout sites in the order the training forward meets them:
# (p, dims); dims 2 zeroes a whole channel of a line (``Do0.1,2`` after
# each convolution and after LSTM layers 1 and 2), dims 1 each value (the
# final ``Do``, kraken's default p 0.5)
DROPOUT = ((0.1, 2),) * 6 + ((0.5, 1),)


def dropout_mask(shape, p: float, generator, device):
    """A dropout mask of ``shape``: each element 0 with probability ``p``,
    else 1 / (1 - p), from ``generator``. Every site of the training
    forward draws its mask through this one function, in site order."""
    keep = torch.rand(shape, generator=generator, device=device) >= p
    return keep.to(torch.float32) / (1.0 - p)


def mask_shape(x, dims: int) -> tuple:
    """The mask shape of a site over ``x``: (B, C, 1, 1) of a conv output
    or (B, 1, F) of an LSTM output for a channel of a line (dims 2), x's
    own shape for each value (dims 1)."""
    if dims == 1:
        return tuple(x.shape)
    return (x.shape[0], x.shape[1], 1, 1) if x.ndim == 4 else (
        x.shape[0], 1, x.shape[2])


def leaves(p: VGSLParams) -> list:
    """Every weight tensor of ``p`` in a fixed order: each convolution's
    weight and bias, each layer's forward then backward direction
    (weight_ih, weight_hh, bias_ih, bias_hh), W, b."""
    out = [t for wb in p.conv for t in wb]
    for layer in p.lstm:
        out += [*layer.fwd, *layer.bwd]
    return out + [p.W, p.b]


def from_leaves(ts, n_conv: int = len(CONVS)) -> VGSLParams:
    """The inverse of :func:`leaves` for a network of ``n_conv``
    convolutions."""
    ts = list(ts)
    rest = ts[2 * n_conv:-2]
    return VGSLParams(
        tuple((ts[2 * i], ts[2 * i + 1]) for i in range(n_conv)),
        tuple(BiLSTMLayer(LSTMDirection(*rest[i:i + 4]),
                          LSTMDirection(*rest[i + 4:i + 8]))
              for i in range(0, len(rest), 8)),
        ts[-2], ts[-1])


def spec_of(p: VGSLParams, height: int) -> str:
    """The VGSL spec string of a network of ``p``'s widths at input
    ``height``, with its output layer: :data:`SPEC` + ``" O1c29"`` at the
    published widths and the port's 29 classes."""
    ops = []
    for (w, _), pooled in zip(p.conv, POOLED):
        ops += [f"Cr{w.shape[2]},{w.shape[3]},{w.shape[0]}", "Do0.1,2"]
        if pooled:
            ops.append("Mp2,2")
    ops.append("S1(1x0)1,3")
    for i, layer in enumerate(p.lstm):
        ops += [f"Lbx{layer.fwd.weight_hh.shape[1]}",
                "Do" if i == len(p.lstm) - 1 else "Do0.1,2"]
    return f"[1,{height},0,1 {' '.join(ops)}] O1c{p.W.shape[0]}"


class VGSLModel(torch.nn.Module):
    """:class:`VGSLParams` as trainable parameters: the convolutions' and
    the head's tensors, and each layer a ``torch.nn.LSTM(bidirectional=
    True)`` holding its two directions in their own layout. Built on the
    weights' device; :meth:`leaves` is the parameters in
    :func:`leaves`' order."""

    def __init__(self, params: VGSLParams):
        super().__init__()
        P = torch.nn.Parameter
        self.convs = torch.nn.ParameterList(
            [P(t.detach().clone()) for wb in params.conv for t in wb])
        self.lstm = torch.nn.ModuleList()
        for layer in params.lstm:
            w = layer.fwd.weight_ih
            m = torch.nn.LSTM(w.shape[1], layer.fwd.weight_hh.shape[1],
                              bidirectional=True, batch_first=True,
                              device=w.device, dtype=torch.float32)
            with torch.no_grad():
                for d, suffix in ((layer.fwd, ""), (layer.bwd, "_reverse")):
                    for k in LSTMDirection._fields:
                        getattr(m, f"{k}_l0{suffix}").copy_(getattr(d, k))
            self.lstm.append(m)
        self.head = torch.nn.ParameterList([P(params.W.detach().clone()),
                                            P(params.b.detach().clone())])

    @property
    def conv(self) -> tuple:
        """((weight, bias), ...), as :func:`conv_features` reads them."""
        c = list(self.convs)
        return tuple(zip(c[0::2], c[1::2]))

    def leaves(self) -> list:
        # registration order: the convolutions, each LSTM's weight_ih,
        # weight_hh, bias_ih, bias_hh then their _reverse, the head
        return list(self.parameters())

    def params(self, grads: bool = False) -> VGSLParams:
        """A detached copy of the weights or, with ``grads``, of their
        gradients (zeros where none)."""
        ts = self.leaves()
        if grads:
            ts = [torch.zeros_like(t) if t.grad is None else t.grad
                  for t in ts]
        return from_leaves([t.detach().clone() for t in ts], len(self.convs)
                           // 2)

    def forward(self, frames, widths, frame_counts, generator=None):
        """Log-probabilities (B, T // 8, classes) of (B, T, height) frames
        of ``widths`` (B,) valid columns on the frames' device;
        ``frame_counts``: each line's ``widths // 8`` as a CPU int64
        tensor, which packs the LSTMs' input. With a ``generator`` every
        dropout site is active, each mask drawn through
        :func:`dropout_mask`; without one none is (eval). Values past a
        line's frame count are meaningless."""
        site = iter(DROPOUT)

        def drop(x):
            if generator is None:
                return x
            p, dims = next(site)
            return x * dropout_mask(mask_shape(x, dims), p, generator,
                                    x.device)

        xs, _ = conv_features(self, frames, widths, drop)
        T3 = xs.shape[1]
        for m in self.lstm:
            out, _ = m(pack_padded_sequence(xs, frame_counts,
                                            batch_first=True,
                                            enforce_sorted=False))
            xs = drop(pad_packed_sequence(out, batch_first=True,
                                          total_length=T3)[0])
        W, b = self.head
        return torch.log_softmax(torch.matmul(xs, W.T) + b, dim=2)


def save_vgsl(path: str, params: VGSLParams, charset, height: int) -> str:
    """Write the weights as a pickle-free ``.npz``: :func:`leaves` as
    arr_000 ..., and a JSON config with the spec, the height and the
    charset."""
    config = json.dumps({"spec": spec_of(params, height), "height": height,
                         "n_conv": len(params.conv),
                         "charset": list(charset)})
    buf = io.BytesIO()
    np.savez(buf, config=np.asarray(config), **{
        f"arr_{i:03d}": t.detach().cpu().numpy()
        for i, t in enumerate(leaves(params))})
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return path


def load_vgsl(path: str):
    """(VGSLParams on the CPU, charset, height) of a :func:`save_vgsl`
    file, read with ``allow_pickle=False``."""
    with np.load(path, allow_pickle=False) as z:
        cfg = json.loads(str(z["config"]))
        ts = [torch.from_numpy(z[k]) for k in sorted(z.files)
              if k.startswith("arr_")]
    return from_leaves(ts, cfg["n_conv"]), cfg["charset"], cfg["height"]
