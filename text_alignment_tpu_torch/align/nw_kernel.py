"""The NW fill and traceback: the CUDA kernels ``csrc/nw_fill.cu`` and
``csrc/nw_traceback.cu`` and their plain PyTorch versions.

Counterparts of ``text_alignment_tpu/align/nw_pallas.py``: :func:`fill`
(``_fill_pallas``, one pair), :func:`fill_batched`
(``_fill_pallas_batched``) and :func:`traceback_batched`
(``traceback_ops_pallas_batched``). Each dispatcher launches the kernel on
CUDA tensors and runs the plain version on CPU tensors; a shape or type the
kernel does not take raises.

Layouts: ``t`` (B, L) ids, ``t[b, i]`` the id of transcript element i - 1
(lane 0 unused); ``o`` (1 or B, NoP) ids, ``o[b, j]`` the id of OCR element
j - 1 (one row is shared by every pair); ``params`` (1 or B, 8)
``[match, mismatch, gox, goy, gex, gey, bge_row0, bge_col0]`` (one row is
shared). The fill returns packed pointers (B, D = L + NoP - 1, L) uint8,
``packed[b, i + j, i] = mp | xp << 2 | yp << 4``. The traceback returns the
wire (B, 3 + L + NoP) int32 ``[k, xpt, ypt, ops...]``, of which ``ops[:k]``
are defined; the kernel puts its window and miss counts in the two last
slots (:func:`traceback_stats`).

The fill kernel has two routes (``csrc/nw_fill.cu``). The segmented route
runs each pair as P = ceil(L / S) segments of S lanes, one CTA a segment,
handing each segment's boundary to the next through global scratch;
:func:`fill_plan` picks S from the pair count and the card's SM count, and
any L has a plan. Where :func:`fill_plan` gives a pair one CTA, the group
route runs G pairs a CTA, filling only each pair's extent (i < Nt,
j < No, from the sizes the caller passes); :func:`group_plan` picks the
lanes a thread, G and the threads a CTA.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from .._kernels import SMEM_LIMIT

INT_NEG = -(2**30)
FLOAT_NEG = -1e30
MAX_THREADS = 1024  # TA_NW_MAX_THREADS in csrc/nw_fill.cu
EDGE_CHUNK = 32  # TA_NW_CHUNK: diagonals a segment publishes at a time
_RUNS = (1, 2, 4, 8, 16, 32)  # lanes per thread the fill kernel is built for
# The narrowest segment fill_plan gives a pair that shares the card with
# few others: of S = 64 to 1024 lanes at 1 to 4 lanes a thread, S = 128 at
# one lane a thread was the fastest at 8191^2 and 16383^2 (chip_smoke.py
# phase 7 times them; PERF.md).
SEG_FLOOR = 128
# The traceback kernel's window schedule (the TA_TB_* of
# csrc/nw_traceback.cu): window rows and lanes, steps a block, the
# prediction's margins above and right of the predicted exit, the lane
# origin's alignment. tests/nw_window_model.py models the kernel with these.
TB_SCHEDULE = dict(TH=256, TW=128, U=16, MD=48, MI=24, ALIGN=16)
# L must be a multiple of the window's lanes, which every bucket is.
TB_LANES = TB_SCHEDULE["TW"]
# The group route's instantiations (lanes a thread, pairs a CTA): the
# TA_NW_GROUPS of csrc/nw_fill.cu, each also built for one shared
# transcript and OCR row when G > 1.
GROUPS = ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4), (4, 1), (4, 2),
          (8, 1))
# An H100 SM: registers (allocated 256 a warp), threads and CTAs it holds.
SM_REGS, SM_THREADS, SM_CTAS = 65536, 2048, 32


def _first_max3(a, b, c):
    """(max, argmax) of three tensors, the first maximum winning ties."""
    v01 = torch.maximum(a, b)
    p01 = torch.where(a >= b, 0, 1)
    return torch.maximum(v01, c), torch.where(v01 >= c, p01, 2)


def fill_reference(t, o, params, S=None):
    """Plain anti-diagonal wavefront, the recurrence of
    ``nw_jax._fill_scan``: one Python step per diagonal, the pairs and the
    lanes vectorized, over the whole bucket (a one-row ``t``, ``o`` or
    ``params`` is shared by every pair). ``params`` int32 runs in int32 (NEG = -2^30), float32
    in float32 (NEG = -1e30). ``S`` (A, A) of ``params``' dtype, when given,
    scores ``S[t_id, o_id]`` (the substitution-matrix form) instead of
    match/mismatch."""
    B = max(t.shape[0], o.shape[0], params.shape[0])
    L = t.shape[1]
    NoP = o.shape[1]
    D = L + NoP - 1
    dt = params.dtype
    dev = t.device
    neg = torch.tensor(INT_NEG if dt == torch.int32 else FLOAT_NEG, dtype=dt,
                       device=dev)
    p = params.to(dev)[:, :, None]  # (1 or B, 8, 1): a column per pair
    match, mismatch = p[:, 0], p[:, 1]
    gox_gex, goy_gey = p[:, 2] + p[:, 4], p[:, 3] + p[:, 5]
    gex, gey = p[:, 4], p[:, 5]
    bge_r0, bge_c0 = p[:, 6], p[:, 7]
    lane = torch.arange(L, device=dev)
    lane_f = lane.to(dt)
    t = t.long()
    o = o.long()

    def shift(v):
        return torch.cat([neg.expand(B, 1), v[:, :-1]], dim=1)

    m2 = x2 = y2 = m1 = x1 = y1 = neg.expand(B, L)
    out = torch.empty((B, D, L), dtype=torch.uint8, device=dev)
    for d in range(D):
        j = d - lane
        oj = o[:, j.clamp(0, NoP - 1)]
        if S is None:
            s = torch.where(t == oj, match, mismatch)
        else:
            s = S[t, oj]
        m_int, mp = _first_max3(shift(m2), shift(x2), shift(y2))
        m_int = m_int + s
        y_int, yp = _first_max3(m1 + goy_gey, x1 + goy_gey, y1 + gey)
        m1s, x1s, y1s = shift(m1), shift(x1), shift(y1)
        x_int, xp = _first_max3(m1s + gox_gex, x1s + gex, y1s + gox_gex)

        row0 = lane == 0
        col0 = (j == 0) & (lane > 0)
        invalid = (j < 0) | (j >= NoP)
        jd = j.to(dt)
        m_v = torch.where(row0, bge_r0 * jd,
                          torch.where(col0, bge_c0 * lane_f, m_int))
        x_v = torch.where(row0, bge_r0 * jd, torch.where(col0, neg, x_int))
        y_v = torch.where(row0, neg, torch.where(col0, bge_c0 * lane_f,
                                                 y_int))
        m_v = torch.where(invalid, neg, m_v).expand(B, L)
        x_v = torch.where(invalid, neg, x_v).expand(B, L)
        y_v = torch.where(invalid, neg, y_v).expand(B, L)
        out[:, d] = (mp | (xp << 2) | (yp << 4)).to(torch.uint8)
        m2, x2, y2, m1, x1, y1 = m1, x1, y1, m_v, x_v, y_v
    return out


def _lanes_per_thread(S: int) -> int:
    """Contiguous lanes each thread of a segment of S lanes owns: the
    fewest that keep the CTA within 1024 threads."""
    for run in _RUNS:
        if S % run == 0 and S // run <= MAX_THREADS:
            return run
    raise ValueError(f"nw_fill: a segment of {S} lanes needs more than "
                     f"{MAX_THREADS} threads of at most {_RUNS[-1]} lanes")


def fill_smem_bytes(S: int, run: int | None = None) -> int:
    """Dynamic shared bytes of one CTA of S lanes, ``run`` a thread
    (default: the fewest that fit; ``ta_nw_fill_smem``): 9 bytes a lane
    (the argmax bytes padded to whole words), two warp edges of 24 bytes a
    warp, two staged chunks of the first lane's left neighbours and the
    ticket."""
    threads = S // (_lanes_per_thread(S) if run is None else run)
    return (8 * S + 2 * (-(-threads // 32)) * 24 + 2 * EDGE_CHUNK * 24
            + -(-S // 4) * 4 + 4)


def _segment(L: int, P: int):
    """S of ``P`` segments over L lanes: ceil(L / P) lanes, rounded up to
    whole warps when the pair is split and to whole runs of a thread; None
    when that is over 1024 threads of the longest run."""
    per = -(-L // P)
    if P > 1:
        per = -(-per // 32) * 32
    for run in _RUNS:
        if -(-per // run) <= MAX_THREADS:
            return -(-per // run) * run
    return None


def fill_plan(B: int, L: int, sms: int):
    """(S, run): the lanes of a segment and the lanes of a thread for B
    pairs of L lanes on a card of ``sms`` SMs. A pair takes
    P = ceil(L / S) CTAs, one a segment. A pair that one CTA runs at one
    lane a thread (L <= 1024), and with B >= sms any pair that fits a
    block (the grids), keeps one CTA: a boundary's hand-off lags about two
    chunks of diagonals, too much of a short pair's. Longer pairs, fewer
    than ``sms``, take the most segments that keep one CTA an SM and S at
    or above ``SEG_FLOOR``. A pair too long for one block takes as many
    segments as it needs to fit."""
    P = 1
    if L > MAX_THREADS:
        P = max(1, min(sms // B, L // SEG_FLOOR))
    while True:
        S = _segment(L, P)
        if S is not None and fill_smem_bytes(S) <= SMEM_LIMIT:
            return S, _lanes_per_thread(S)
        P += 1


def _check(name, tensor, dtype, shape, device):
    if (tensor.device != device or tensor.dtype != dtype
            or tuple(tensor.shape) != shape or not tensor.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {tensor.dtype} {tuple(tensor.shape)} on "
            f"{tensor.device}")


def _check_fill(what, t, o, params):
    if t.dim() != 2 or o.dim() != 2 or params.dim() != 2:
        raise ValueError(f"{what}: t, o and params must be 2-D")
    B = max(t.shape[0], o.shape[0], params.shape[0])
    L, NoP = t.shape[1], o.shape[1]
    _check(f"{what}: t", t, torch.int32, (t.shape[0], L), t.device)
    _check(f"{what}: o", o, torch.int32, (o.shape[0], NoP), t.device)
    _check(f"{what}: params", params, torch.int32, (params.shape[0], 8),
           t.device)
    if B == 0 or L == 0 or NoP == 0:
        raise ValueError(f"{what}: empty input t {tuple(t.shape)} o "
                         f"{tuple(o.shape)}")
    rows = (t.shape[0], o.shape[0], params.shape[0])
    if any(n not in (1, B) for n in rows):
        raise ValueError(f"{what}: t, o and params need 1 or {B} rows, got "
                         f"{rows}")
    return B, L, NoP


def _plan(what, t, B, L, seg, run):
    """(S, run) of a segmented launch: :func:`fill_plan` on the tensor's
    card unless ``seg`` (lanes a segment) or ``run`` (lanes a thread) is
    forced."""
    if seg is None:
        seg = fill_plan(B, L, _sms(t.device))[0]
    run = _lanes_per_thread(seg) if run is None else run
    if run not in _RUNS or seg % run or seg // run > MAX_THREADS:
        raise ValueError(f"{what}: no CTA of {seg} lanes at {run} a thread")
    need = fill_smem_bytes(seg, run)
    if need > SMEM_LIMIT:
        raise ValueError(f"{what}: a segment of {seg} lanes needs {need} "
                         f"bytes of shared memory, over the {SMEM_LIMIT} a "
                         f"block has")
    return seg, run


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def resident_ctas(threads: int, regs: int) -> int:
    """CTAs of ``threads`` threads (whole warps) at ``regs`` registers a
    thread that one SM holds at once."""
    warp_regs = -(-regs * 32 // 256) * 256
    return min(SM_CTAS, SM_THREADS // threads,
               SM_REGS // (warp_regs * (threads // 32)))


def group_plan(B: int, Nt: int, L: int, sms: int, attrs: dict,
               run: int | None = None, g: int | None = None):
    """(run, G, threads) of a group-route launch of B pairs whose largest
    transcript extent is Nt in a bucket of L lanes, on a card of ``sms``
    SMs, or None when no instantiation takes it. ``attrs`` maps each
    (run, G) of :data:`GROUPS` to the compiled kernel's (registers, spill
    bytes, most threads a CTA) (:func:`group_attrs`); one that spills, that
    would need more threads than it may have, or whose run does not divide
    L is refused. ``run`` or ``g`` forces that value.

    A CTA has ceil(Nt / (32 run)) whole warps; ceil(B / G) CTAs run in
    waves of ``sms`` x the CTAs an SM holds (:func:`resident_ctas`). The
    plan takes the fewest waves, one where it can, then the fewest cells a
    thread a diagonal (run x G), then the fewest lanes a thread: the kernel
    is bound by issue and latency, and at every shape
    ``chip_nw_ablation.py`` swept a launch took longer the more cells a
    thread held, unless they saved a wave (PERF.md)."""
    best = None
    for r, gg in GROUPS:
        if (run is not None and r != run) or (g is not None and gg != g):
            continue
        if L % r or (r, gg) not in attrs:
            continue
        regs, spill, max_threads = attrs[(r, gg)]
        threads = -(-Nt // (32 * r)) * 32
        if spill or threads > max_threads:
            continue
        per_wave = sms * resident_ctas(threads, regs)
        key = (-(-(-(-B // gg)) // per_wave), r * gg, r)
        if best is None or key < best[0]:
            best = (key, (r, gg, threads))
    return None if best is None else best[1]


_group_attrs: dict = {}


def group_attrs(device, shared: bool) -> dict:
    """{(run, G): (registers, spill bytes, most threads a CTA)} of the group
    route's instantiations for one shared transcript and OCR row or not,
    read from the compiled library (``ta_nw_group_attrs``) once a card."""
    key = (device.index, shared)
    if key not in _group_attrs:
        lib = _kernels.lib()
        out = (ctypes.c_int * 3)()
        table = {}
        for r, gg in GROUPS:
            _kernels.check(lib.ta_nw_group_attrs(r, gg, int(shared),
                                                 device.index or 0,
                                                 ctypes.addressof(out)),
                           "nw_fill group attributes")
            table[(r, gg)] = tuple(out)
        _group_attrs[key] = table
    return _group_attrs[key]


def _sizes(what, nts, nos, B, L, NoP) -> np.ndarray:
    """(2, 1 or B) int32 [Nt; No] of the pairs, within the bucket; the
    whole bucket when both are None."""
    if nts is None and nos is None:
        return np.array([[L], [NoP]], np.int32)
    if nts is None or nos is None:
        raise ValueError(f"{what}: give both nts and nos, or neither")
    a = torch.as_tensor(nts).cpu().numpy().astype(np.int64).ravel()
    b = torch.as_tensor(nos).cpu().numpy().astype(np.int64).ravel()
    if a.shape != b.shape or a.size not in (1, B):
        raise ValueError(f"{what}: nts and nos need 1 or {B} entries each, "
                         f"got {a.size} and {b.size}")
    if a.min() < 1 or a.max() > L or b.min() < 1 or b.max() > NoP:
        raise ValueError(f"{what}: sizes outside 1..{L} x 1..{NoP}")
    return np.stack([a, b]).astype(np.int32)


def _launch(what, t, o, params, nts, nos, seg, run, group):
    """Packed pointers of a fill launch on PyTorch's current stream: the
    group route where :func:`fill_plan` gives a pair one CTA (or ``group``
    is forced) and :func:`group_plan` has a plan, else the segmented
    route."""
    B, L, NoP = _check_fill(what, t, o, params)
    lib = _kernels.lib()
    dev = t.device
    out = torch.empty((B, L + NoP - 1, L), dtype=torch.uint8, device=dev)
    stream = _kernels.stream_handle(dev)
    if seg is None and (group is not None
                        or fill_plan(B, L, _sms(dev))[0] == L):
        sizes = _sizes(what, nts, nos, B, L, NoP)
        shared = t.shape[0] == 1 and o.shape[0] == 1
        plan = group_plan(B, int(sizes[0].max()), L, _sms(dev),
                          group_attrs(dev, shared), run, group)
        if plan is None and group is not None:
            raise ValueError(f"{what}: no CTA of G = {group} (run {run}) "
                             f"takes Nt = {int(sizes[0].max())} in L = {L}")
        if plan is not None:
            r, gg, threads = plan
            # pinned, so the copy does not wait for the stream; held
            # through the C call, as the scratch below
            dsz = torch.from_numpy(sizes).pin_memory().to(dev,
                                                          non_blocking=True)
            code = lib.ta_nw_fill_batched(
                t.data_ptr(), o.data_ptr(), params.data_ptr(),
                dsz[0].data_ptr(), dsz[1].data_ptr(), out.data_ptr(), B, L,
                NoP, t.shape[0], o.shape[0], params.shape[0], sizes.shape[1],
                r, gg, threads, dev.index, stream, 0, None)
            _kernels.check(code, f"{what} launch")
            return out
    seg, run = _plan(what, t, B, L, seg, run)
    t = t.expand(B, L).contiguous()
    # the hand-off scratch stays referenced until the C call has returned:
    # ctypes releases the GIL, and a freed block may go to another thread
    # issuing on the same stream
    scratch = torch.empty(lib.ta_nw_fill_scratch_bytes(B, L, NoP, seg),
                          dtype=torch.uint8, device=dev)
    if what == "nw_fill":
        code = lib.ta_nw_fill(
            t.data_ptr(), o.data_ptr(), params.data_ptr(), out.data_ptr(), L,
            NoP, run, dev.index, stream, seg, scratch.data_ptr())
    else:
        code = lib.ta_nw_fill_batched(
            t.data_ptr(), o.data_ptr(), params.data_ptr(), None, None,
            out.data_ptr(), B, L, NoP, B, o.shape[0], params.shape[0], 1, run,
            0, 0, dev.index, stream, seg, scratch.data_ptr())
    _kernels.check(code, f"{what} launch")
    return out


def fill_cuda(t, o, params, seg=None, run=None):
    """Launch the fill of one pair (B = 1) on PyTorch's current stream: a
    pair of at most 1024 lanes on the group route over its whole bucket, a
    longer one in segments of ``seg`` lanes, ``run`` lanes a thread
    (default: :func:`fill_plan`) through ``ta_nw_fill``."""
    B, L, NoP = _check_fill("nw_fill", t, o, params)
    if B != 1:
        raise ValueError("nw_fill takes one pair; use fill_batched for more")
    out = _launch("nw_fill", t, o, params, None, None, seg, run, None)
    _kernels.launches["nw_fill"] += 1
    return out


def fill_batched_cuda(t, o, params, nts=None, nos=None, seg=None, run=None,
                      group=None):
    """Launch ``ta_nw_fill_batched`` on PyTorch's current stream. ``t``,
    ``o`` and ``params`` have 1 or B rows; a one-row ``t`` or ``o`` is
    every pair's (``o``: ``shared_feed``; a one-row ``t`` and ``o`` are
    carried once a CTA on the group route), B rows of ``params`` are
    ``per_pair``. ``nts``, ``nos`` (1 or B sizes, host or card; default the
    whole bucket) bound the cells the group route fills: the bytes of cells
    with i >= Nt or j >= No are unspecified. Forced: ``seg`` (the
    segmented route, lanes a segment), ``run`` (lanes a thread) and
    ``group`` (the group route, pairs a CTA); default :func:`fill_plan` and
    :func:`group_plan`."""
    out = _launch("nw_fill_batched", t, o, params, nts, nos, seg, run, group)
    _kernels.launches["nw_fill_batched"] += 1
    return out


def _device_type(what, tensor) -> str:
    kind = tensor.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no version for device {tensor.device}")
    return kind


def fill(t, o, params):
    """Packed pointers of one pair: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _device_type("nw_fill", t) == "cuda":
        return fill_cuda(t, o, params)
    return fill_reference(t, o, params)


def fill_batched(t, o, params, nts=None, nos=None):
    """Packed pointers of B pairs of one bucket: the kernel on CUDA
    tensors (filling each pair's extent ``nts`` x ``nos`` when given), the
    plain version on CPU tensors (the whole bucket; the sizes are not
    read)."""
    if _device_type("nw_fill_batched", t) == "cuda":
        return fill_batched_cuda(t, o, params, nts, nos)
    return fill_reference(t, o, params)


def traceback_reference(packed, nts, nos):
    """Plain pointer walk, ``nw_jax._traceback_ops`` in lock step over the
    pairs: one Python step per path step, the pairs vectorized."""
    B, D, L = packed.shape
    P = D + 1
    flat = packed.reshape(B, D * L)
    xpt = nts.long() - 1
    ypt = nos.long() - 1

    def cell():
        return flat.gather(1, ((xpt + ypt) * L + xpt)[:, None])[:, 0].long()

    mpt = cell() & 3
    k = torch.zeros_like(xpt)
    ops = torch.zeros((B, P), dtype=torch.int32, device=packed.device)
    steps = int((xpt + ypt).max().item()) if B else 0
    for step in range(steps):
        if step % 256 == 0 and not bool(((xpt > 0) & (ypt > 0)).any()):
            break
        active = (xpt > 0) & (ypt > 0)
        kk = k[:, None]
        ops.scatter_(1, kk, torch.where(active[:, None], mpt[:, None].int(),
                                        ops.gather(1, kk)))
        nxt = (cell() >> (2 * mpt)) & 3
        xpt = xpt - ((mpt != 2) & active).long()
        ypt = ypt - ((mpt != 1) & active).long()
        mpt = torch.where(active, nxt, mpt)
        k = k + active.long()
    head = torch.stack([k, xpt, ypt], dim=1).int()
    return torch.cat([head, ops], dim=1)


def _check_traceback(packed, nts, nos):
    if packed.dim() != 3:
        raise ValueError("nw_traceback: packed must be (B, D, L)")
    B, D, L = packed.shape
    _check("nw_traceback: packed", packed, torch.uint8, (B, D, L),
           packed.device)
    _check("nw_traceback: nts", nts, torch.int32, (B,), packed.device)
    _check("nw_traceback: nos", nos, torch.int32, (B,), packed.device)
    if B == 0 or D < L:
        raise ValueError(f"nw_traceback: bad shape {tuple(packed.shape)}")
    NoP = D - L + 1
    if bool(((nts < 1) | (nts > L) | (nos < 1) | (nos > NoP)).any()):
        raise ValueError(f"nw_traceback: sizes outside 1..{L} x 1..{NoP}")
    return B, D, L


def traceback_cuda(packed, nts, nos):
    """Launch ``ta_nw_traceback_batched`` on PyTorch's current stream."""
    B, D, L = _check_traceback(packed, nts, nos)
    if L % TB_LANES or B * D >= 2**31:
        raise ValueError(f"nw_traceback: the kernel takes L a multiple of "
                         f"{TB_LANES} and B * D < 2^31, got {(B, D, L)}")
    wire = torch.empty((B, 3 + D + 1), dtype=torch.int32, device=packed.device)
    code = _kernels.lib().ta_nw_traceback_batched(
        packed.data_ptr(), nts.data_ptr(), nos.data_ptr(), wire.data_ptr(), B,
        D, L, packed.device.index, _kernels.stream_handle(packed.device))
    _kernels.check(code, "nw_traceback launch")
    _kernels.launches["nw_traceback"] += 1
    return wire


def traceback_stats(wire):
    """(windows, misses) per pair of a kernel's wire: the windows it
    staged and how many of them it staged on demand because the predicted
    window did not hold the cursor (``ops[P-2]``, ``ops[P-1]``, which the
    walk never reaches). The plain version leaves both 0."""
    return wire[:, -2], wire[:, -1]


def traceback_batched(packed, nts, nos):
    """The (B, 3 + P) wire ``[k, xpt, ypt, ops...]``: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if _device_type("nw_traceback", packed) == "cuda":
        return traceback_cuda(packed, nts, nos)
    _check_traceback(packed, nts, nos)
    return traceback_reference(packed, nts, nos)
