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
wide route takes over: a (direction, batch tile) is a thread-block cluster
of :func:`cluster_size` CTAs, each owning a range of units and holding
their columns on chip, h exchanged through distributed shared memory each
step; past what a cluster of 8 holds, the rest of a column is read from
global memory each step, and a CTA of over 256 units walks them in groups.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import _kernels
from .._kernels import SMEM_LIMIT
from ..utils.timing import span

# The kernel's instantiations, as listed at its dispatch: NQ (ns / 4 rounded
# up to one of these, so ns <= 128) -> the batch tiles BT it is built for,
# those whose Wh quads past the registers fit a block's shared memory.
TILES = {25: (1, 2, 4, 8), 32: (1, 2, 4)}
# The wide route's batch tiles (ns > 128, NQ = ceil(ns / 4)); a tile needs
# its h and c buffers, 12 * BT * 4 * NQ bytes, in one block.
WIDE_TILES = (1, 2, 4)
# The wide route's cluster sizes, up to the 8 CTAs a portable cluster has.
WIDE_CLUSTERS = (1, 2, 4, 8)
WIDE_THREADS = 1024  # the most threads a CTA of the wide route has


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


_NO_SPAN = contextlib.nullcontext()


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


def cta_threads(ns: int, cluster: int) -> int:
    """Threads a CTA at ns in a cluster of ``cluster``: four lanes for each
    of its ceil(ns / cluster) units, in whole warps, at most 1024 (past
    that a thread walks several unit groups)."""
    units = -(-ns // cluster)
    return min(-(-4 * units // 32) * 32, WIDE_THREADS)


def cluster_size(ns: int, bt: int) -> int:
    """C, the CTAs of a (direction, batch tile)'s cluster: 1 on the narrow
    route; on the wide route the fewest of ``WIDE_CLUSTERS`` whose CTAs
    hold their columns of Wh (a float4 a quad, every unit group) and the
    tile's h and c buffers in shared memory, else the widest (its
    registers take some quads too; the rest are read from global
    memory)."""
    nq = quads(ns)
    if nq in TILES:
        return 1
    for c in WIDE_CLUSTERS:
        threads, units = cta_threads(ns, c), -(-ns // c)
        groups = -(-units // (threads // 4))
        if 48 * bt * nq + 16 * nq * threads * groups <= SMEM_LIMIT:
            return c
    return WIDE_CLUSTERS[-1]


def launch_plan(B: int, ns: int, sms: int, active=None) -> int:
    """bt, the batch rows a CTA: the smallest tile of ns's instantiation
    whose 2 * ceil(B / bt) clusters the card holds at once, or past the
    largest batch one wave holds, the largest tile (more waves).
    ``active(bt)`` is how many clusters of ns's plan at tile bt the card
    holds at once (on the card, ``cudaOccupancyMaxActiveClusters``);
    without it, ``sms // cluster_size(ns, bt)``, a CTA an SM. On the
    narrow route a cluster is one CTA and the card holds ``sms``. A smaller
    tile keeps more of each thread's Wh column in registers."""
    if active is None:
        def active(bt):
            return sms // cluster_size(ns, bt)
    ts = tiles(ns)
    for bt in ts:
        if 2 * -(-B // bt) <= active(bt):
            return bt
    return ts[-1]


ATTRS = ("regs", "local_bytes", "threads", "max_threads",
         "quads_in_registers", "shared_bytes", "quads_in_global", "cluster",
         "active_clusters")


@functools.lru_cache(maxsize=256)
def _attrs(ns: int, bt: int, index: int) -> tuple:
    vals = (ctypes.c_int * len(ATTRS))()
    code = _kernels.lib().ta_lstm_scan_attrs(
        quads(ns), bt, ns, cluster_size(ns, bt), index, vals)
    _kernels.check(code, "lstm_scan attributes")
    return tuple(vals)


def kernel_attrs(ns: int, bt: int, device) -> dict:
    """What the compiler made of the (quads(ns), bt) instantiation (on the
    card): registers and spill bytes per thread, threads per CTA at ns and
    the instantiation's thread limit, Wh quads in registers, shared bytes
    per CTA, the quads of a column read from global memory each step
    (the wide route's leftover tier; 0 at ns <= 128), the CTAs of a
    cluster and the most clusters the card holds at once (the SM count on
    the narrow route)."""
    return dict(zip(ATTRS, _attrs(ns, bt, torch.device(device).index or 0)))


def card_plan(B: int, ns: int, device) -> int:
    """The batch tile :func:`bidir_scan_cuda` takes on the card: the plan
    with the card's SM count and the clusters it holds at once."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return launch_plan(B, ns, sms, lambda bt: kernel_attrs(
        ns, bt, device)["active_clusters"])


def bidir_scan_cuda(gx, whT, peep, bt=None):
    """Launch ``csrc/lstm_scan.cu`` on PyTorch's current stream, with the
    batch tile of :func:`launch_plan` unless ``bt`` names one, in clusters
    of :func:`cluster_size`; a launch in clusters of more than one CTA
    runs inside a ``ta.lstm.cluster`` span."""
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
    index = gx.device.index or 0
    if bt is None:
        bt = card_plan(B, ns, gx.device)
    if bt not in tiles(ns):
        raise ValueError(f"lstm_scan: no instantiation of bt={bt} at "
                         f"ns={ns}: tiles {tiles(ns)}")
    cluster = cluster_size(ns, bt)
    out = torch.empty((2, T, B, ns), dtype=torch.float32, device=gx.device)
    L = _kernels.lib()
    with span("ta.lstm.cluster") if cluster > 1 else _NO_SPAN:
        code = L.ta_lstm_scan(gx.data_ptr(), whT.data_ptr(), peep.data_ptr(),
                              out.data_ptr(), T, B, ns, nq, bt, cluster,
                              index, _kernels.stream_handle(gx.device))
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
