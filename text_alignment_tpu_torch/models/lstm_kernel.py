"""The BiLSTM recurrence: the CUDA kernel ``csrc/lstm_scan.cu`` and its
plain PyTorch version.

Counterpart of ``text_alignment_tpu/models/lstm_pallas.py``
(``bidir_scan_pallas``). :func:`bidir_scan` launches the kernel for CUDA
tensors and runs :func:`bidir_scan_reference` for CPU tensors; there is no
shape gate that routes CUDA tensors elsewhere; a shape the kernel does not
take raises.

Layouts (float32): ``gx`` (2, T, B, 4ns) is the input projection plus bias
of both directions, T-major so that one step reads one contiguous
(B, 4ns) tile, direction 1 length-reversed; ``whT`` (2, ns, 4ns) the
recurrent weights (``gates = gx[t] + h @ whT``); ``peep`` (2, 3, ns) the
[WIP, WFP, WOP] peepholes. Gate chunks are [gi | gf | go | ci], the order
of ``lstm_jax._bidir_scan``. Returns h for every step, (2, T, B, ns).

The kernel's launch plan (:func:`launch_plan`) is a batch tile ``bt``: the
grid is 2 directions x ceil(B / bt) CTAs, each four lanes per hidden unit,
every lane holding one column of Wh in registers and what does not fit in
shared memory (:func:`kernel_attrs` reports how much). Past ns = 128 the
wide route takes over: a CTA of at most 1024 threads walks ceil(ns / 256)
unit groups a step, and the quads of a column past its registers and its
shared slot are read from global memory each step.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from .._kernels import SMEM_LIMIT

# The kernel's instantiations, as listed at its dispatch: NQ (ns / 4 rounded
# up to one of these, so ns <= 128) -> the batch tiles BT it is built for,
# those whose Wh quads past the registers fit a block's shared memory.
TILES = {25: (1, 2, 4, 8), 32: (1, 2, 4)}
# The wide route's batch tiles (ns > 128, NQ = ceil(ns / 4)); a tile needs
# its h and c buffers, 12 * BT * 4 * NQ bytes, in one block.
WIDE_TILES = (1, 2, 4)


def bidir_scan_reference(gx, whT, peep):
    """Plain PyTorch recurrence: a Python loop over T with the kernel's
    math (ocropy LSTM, peepholes, no WOP term at t = 0). h . Wh is summed
    over s in ascending order with each product rounded, the kernel's
    order: over thousands of steps another order (a matmul's) drifts from
    the kernel by more than the 1e-4 the two are held to."""
    _, T, B, G = gx.shape
    ns = G // 4
    wip, wfp, wop = (peep[:, k, None, :] for k in range(3))  # (2, 1, ns)
    h = gx.new_zeros((2, B, ns))
    c = gx.new_zeros((2, B, ns))
    out = gx.new_empty((2, T, B, ns))
    for t in range(T):
        acc = torch.zeros_like(gx[:, 0])
        for s in range(ns):
            acc = acc + h[:, :, s:s + 1] * whT[:, None, s, :]
        g = gx[:, t] + acc
        gi = torch.sigmoid(g[..., :ns] + wip * c)
        gf = torch.sigmoid(g[..., ns:2 * ns] + wfp * c)
        ci = torch.tanh(g[..., 3 * ns:])
        c = ci * gi + gf * c
        go_in = g[..., 2 * ns:3 * ns]
        go = torch.sigmoid(go_in + wop * c if t > 0 else go_in)
        h = torch.tanh(c) * go
        out[:, t] = h
    return out


def quads(ns: int) -> int:
    """NQ: the kernel instantiation for ns (its Wh column of 4 * NQ
    floats, zero padded past ns); past ns = 128 the wide route's
    ceil(ns / 4)."""
    for nq in TILES:
        if 4 * nq >= ns:
            return nq
    return -(-ns // 4)


def tiles(ns: int) -> tuple:
    """The batch tiles the kernel takes at ns. Raises past the widest ns
    whose h and c buffers fit a block (19,368 at bt = 1)."""
    nq = quads(ns)
    if nq in TILES:
        return TILES[nq]
    fit = tuple(bt for bt in WIDE_TILES if 48 * bt * nq <= SMEM_LIMIT)
    if not fit:
        raise ValueError(f"lstm_scan: ns={ns}: the h and c buffers of one "
                         f"batch row are over a block's shared memory")
    return fit


def launch_plan(B: int, ns: int, sms: int) -> int:
    """bt, the batch rows a CTA: the smallest tile of ns's instantiation
    whose grid of 2 * ceil(B / bt) CTAs fits one wave on ``sms`` SMs, or
    past the largest batch one wave holds, the largest tile (more waves).
    A smaller tile keeps more of each thread's Wh column in registers."""
    ts = tiles(ns)
    for bt in ts:
        if 2 * -(-B // bt) <= sms:
            return bt
    return ts[-1]


def kernel_attrs(ns: int, bt: int, device) -> dict:
    """What the compiler made of the (quads(ns), bt) instantiation (on the
    card): registers and spill bytes per thread, threads per CTA at ns and
    the instantiation's thread limit, Wh quads in registers, shared bytes
    per CTA, and the quads of a column read from global memory each step
    (the wide route's third tier; 0 at ns <= 128)."""
    vals = (ctypes.c_int * 7)()
    code = _kernels.lib().ta_lstm_scan_attrs(
        quads(ns), bt, ns, torch.device(device).index or 0, vals)
    _kernels.check(code, "lstm_scan attributes")
    return dict(zip(("regs", "local_bytes", "threads", "max_threads",
                     "quads_in_registers", "shared_bytes", "quads_in_global"),
                    vals))


def bidir_scan_cuda(gx, whT, peep, bt=None):
    """Launch ``csrc/lstm_scan.cu`` on PyTorch's current stream, with the
    batch tile of :func:`launch_plan` unless ``bt`` names one."""
    _, T, B, G = gx.shape
    ns = G // 4
    for name, t, shape in (("gx", gx, (2, T, B, G)),
                           ("whT", whT, (2, ns, G)),
                           ("peep", peep, (2, 3, ns))):
        if (t.device != gx.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"lstm_scan: {name} must be a contiguous float32 tensor of "
                f"shape {shape} on {gx.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if G % 4 or T == 0 or B == 0:
        raise ValueError(f"lstm_scan: bad shape gx {tuple(gx.shape)}")
    nq = quads(ns)
    if bt is None:
        bt = launch_plan(B, ns, torch.cuda.get_device_properties(
            gx.device).multi_processor_count)
    if bt not in tiles(ns):
        raise ValueError(f"lstm_scan: no instantiation of bt={bt} at "
                         f"ns={ns}: tiles {tiles(ns)}")
    out = torch.empty((2, T, B, ns), dtype=torch.float32, device=gx.device)
    L = _kernels.lib()
    code = L.ta_lstm_scan(gx.data_ptr(), whT.data_ptr(), peep.data_ptr(),
                          out.data_ptr(), T, B, ns, nq, bt,
                          gx.device.index,
                          _kernels.stream_handle(gx.device))
    _kernels.check(code, "lstm_scan launch")
    _kernels.launches["lstm_scan"] += 1
    return out


def bidir_scan(gx, whT, peep):
    """(2, T, B, ns) hidden states: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if gx.device.type == "cuda":
        return bidir_scan_cuda(gx, whT, peep)
    if gx.device.type == "cpu":
        return bidir_scan_reference(gx, whT, peep)
    raise ValueError(f"lstm_scan: no version for device {gx.device}")
