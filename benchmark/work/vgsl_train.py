"""Bytes and operations of a training step of kraken's default network
(``kraken_train``), from the shapes of its inputs: each line's valid
positions only, as ``ocr_vgsl.py`` counts the forward."""

from __future__ import annotations

from .ocr_vgsl import POOLED, network

BACKWARD = 2   # the backward's operations over the forward's


def conv_train(lengths, height, convs):
    """The conv front end's training work over lines of ``lengths``
    columns: each convolution's forward (and its ReLU), its weight
    gradient (and its bias's) and, past the first, whose input needs none,
    its input gradient; 2 multiply-adds an output position and tap each.
    Bytes: each pass's tensors once, float32: forward input, weights,
    output; input gradient from the output's gradient and the weights;
    weight gradient from the input and the output's gradient."""
    ops = nbytes = 0
    for L in lengths:
        w, h, cin = int(L), int(height), 1
        for i, ((kh, kw, cout), pooled) in enumerate(zip(convs, POOLED)):
            mac = 2 * cout * h * w * cin * kh * kw
            act_in, act_out = cin * h * w, cout * h * w
            wts = cout * cin * kh * kw + cout
            ops += 2 * mac + 2 * act_out      # forward, weight gradient
            nbytes += 4 * (act_in + wts + act_out     # forward
                           + act_in + act_out + wts)  # weight gradient
            if i:
                ops += mac
                nbytes += 4 * (act_out + wts + act_in)
            cin = cout
            if pooled:
                w, h = w // 2, h // 2
    return nbytes, ops


def step(lengths, height, convs, ns, layers, classes):
    """(conv front end (bytes, ops), the whole step's (bytes, ops)): the
    network's forward (``ocr_vgsl.network``) and a backward of twice its
    operations, over lines of ``lengths`` normalized columns."""
    _, (nbytes, ops) = network(lengths, height, convs, ns, layers, classes)
    return (conv_train(lengths, height, convs),
            ((1 + BACKWARD) * nbytes, (1 + BACKWARD) * ops))
