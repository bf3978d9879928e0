"""NW alignment on a torch device: one pair, a batch of pairs, and one pair
under many scoring systems.

Counterpart of ``text_alignment_tpu/align/nw_jax.py`` and the host side of
``nw_pallas.py``. Integer match/mismatch scoring (either boundary form)
runs on the kernels of :mod:`.nw_kernel`; callable or non-integer scoring
runs the plain wavefront :func:`.nw_kernel.fill_reference` on the same
device, where the JAX package also leaves its Pallas kernel for the XLA
scan. The route depends on the scoring form alone. Every path ends in the
pointer walk of :func:`.nw_kernel.traceback_batched`, one copy of the
(ops, k, xpt, ypt) wire to the host, and :func:`replay_ops`.

Under a running ``torch.profiler`` each entry point opens a span of its
name (``ta.nw.align_grid``, ``ta.nw.align_pairs``, ``ta.nw.align_ops``)
and, inside it, one span a stage: ``ta.nw.encode`` (ids, buckets, scoring
rows, lane layout, uploads), ``ta.nw.fill`` and ``ta.nw.walk`` (the host
side of each launch), ``ta.nw.wire`` (the host waiting for the card's
wire) and ``ta.nw.replay`` (every row's replay, one span a call), inside
it ``ta.nw.replay_one`` (one :func:`replay_ops` call).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import span
from . import nw_kernel
from .nw_host import fill_host
from .scoring import BOUNDARY_GAP_EXTEND
from .traceback import DensePtrView, traceback

# Packed pointers one batched fill may hold on the card at once (4 GiB of
# its 80 GB): at most 327 combinations of the 2400^2 grid (D * L = 5119 *
# 2560 B per combination) a launch, so its 729 rows run as three launches
# of 243; a chant-size grid runs all 729 in one.
PTR_BUDGET = 4 << 30


def _bucket(n: int) -> int:
    """Padding ladder of ``nw_jax._bucket``: powers of two from 128 up to
    2048, then multiples of 512 (every rung a multiple of 128)."""
    b = 128
    while b < n and b < 2048:
        b *= 2
    if n <= b:
        return b
    return -(-n // 512) * 512


def _token_ids(transcript, ocr):
    """int32 ids of two token sequences (``nw_pallas._token_ids``). Only id
    equality feeds the kernels, so any injective map is exact; all
    one-character strings use their code points."""
    if all(type(c) is str and len(c) == 1 for c in transcript) and all(
            type(c) is str and len(c) == 1 for c in ocr):
        return (
            np.frombuffer("".join(transcript).encode("utf-32-le"),
                          np.uint32).astype(np.int32),
            np.frombuffer("".join(ocr).encode("utf-32-le"),
                          np.uint32).astype(np.int32),
        )
    vocab = sorted(set(transcript) | set(ocr))
    ids = {v: k for k, v in enumerate(vocab)}
    return (np.array([ids[c] for c in transcript], np.int32),
            np.array([ids[c] for c in ocr], np.int32))


def _encode(transcript, ocr, sc):
    """Vocabulary ids and the scoring of the plain route
    (``nw_jax._encode``): (t_ids, o_ids, params row, S or None). int32
    when every score is an integer, float32 otherwise; S is the
    substitution matrix of a callable scoring."""
    vocab = sorted(set(transcript) | set(ocr))
    ids = {v: k for k, v in enumerate(vocab)}
    is_int = sc.is_integral
    S = None
    if sc.match_mismatch is not None:
        match, mismatch = sc.match_mismatch
    else:
        S = np.array([[sc.score(a, b) for b in vocab] for a in vocab],
                     np.float64)
        is_int = is_int and bool(np.all(S == np.round(S)))
        match = mismatch = 0
    dt = np.int32 if is_int else np.float32
    row = np.array([match, mismatch, sc.gap_open_x, sc.gap_open_y,
                    sc.gap_extend_x, sc.gap_extend_y, sc.bge_row0,
                    sc.bge_col0], np.float64)
    if S is not None:
        S = S.astype(dt)
    return (np.array([ids[c] for c in transcript], np.int32),
            np.array([ids[c] for c in ocr], np.int32), row.astype(dt), S)


def kernel_form(sc) -> bool:
    """True when the kernels take this scoring: integer match/mismatch."""
    return sc.match_mismatch is not None and sc.is_integral


def kernel_params(sc) -> np.ndarray:
    """The kernels' scoring row [match, mismatch, gox, goy, gex, gey,
    bge_row0, bge_col0], int32."""
    match, mismatch = sc.match_mismatch
    return np.array([match, mismatch, sc.gap_open_x, sc.gap_open_y,
                     sc.gap_extend_x, sc.gap_extend_y, sc.bge_row0,
                     sc.bge_col0], np.int64).astype(np.int32)


def _ext(ids, n_pad):
    """Lane layout of the kernels: ``ext[k]`` is the id of element k - 1."""
    ext = np.zeros(n_pad, np.int32)
    ext[1:len(ids)] = ids[:len(ids) - 1]
    return ext


def lane_batch(pairs):
    """Pairs (sentinels included) in the kernels' lane layout, padded to
    the bucket of the longest: t (B, L) and o (B, NoP) int32 ids, and the
    sizes Nt, No (B,) int32."""
    ids = [_token_ids(t, o) for t, o in pairs]
    L = _bucket(max(len(a) for a, _ in ids))
    NoP = _bucket(max(len(b) for _, b in ids))
    return (np.stack([_ext(a, L) for a, _ in ids]),
            np.stack([_ext(b, NoP) for _, b in ids]),
            np.array([len(a) for a, _ in ids], np.int32),
            np.array([len(b) for _, b in ids], np.int32))


def replay_ops(transcript, ocr, ops, count, xpt_tail, ypt_tail):
    """Host replay of the device op sequence into aligned element lists,
    byte-identical to the reference traceback (``nw_jax.replay_ops``):
    the forced sentinel pair, the leftover gap runs and the [-1:0:-1]
    reversal. Vectorized: the cursor before each step is an exclusive
    prefix sum of the op stream's decrements."""
    with span("ta.nw.replay_one"):
        xpt = len(transcript) - 1
        ypt = len(ocr) - 1
        if count > 0:
            o = np.asarray(ops[:count], np.int64)
            dx = o != 2  # op 0 (diag) and 1 (x-gap) consume a transcript char
            dy = o != 1  # op 0 (diag) and 2 (y-gap) consume an OCR char
            cx = np.cumsum(dx)
            cy = np.cumsum(dy)
            xpt_i = xpt - cx + dx
            ypt_i = ypt - cy + dy
            t_arr = np.array(transcript, dtype=object)
            o_arr = np.array(ocr, dtype=object)
            gap = np.array(["_"], dtype=object)[0]
            tra_mid = np.where(dx, t_arr[xpt_i - 1], gap)
            ocr_mid = np.where(dy, o_arr[ypt_i - 1], gap)
            tra_align = [transcript[xpt]] + list(tra_mid)
            ocr_align = [ocr[ypt]] + list(ocr_mid)
            xpt -= int(cx[-1])
            ypt -= int(cy[-1])
        else:
            tra_align = [transcript[xpt]]
            ocr_align = [ocr[ypt]]
        if (xpt, ypt) != (xpt_tail, ypt_tail):
            raise RuntimeError(
                f"NW op stream ends at ({xpt}, {ypt}), the walk at "
                f"({xpt_tail}, {ypt_tail})")

        if ypt > 0:
            tra_align.extend(["_"] * ypt)
            ocr_align.extend(ocr[ypt - 1::-1])
        if xpt > 0:
            ocr_align.extend(["_"] * xpt)
            tra_align.extend(transcript[xpt - 1::-1])
        return tra_align[-1:0:-1], ocr_align[-1:0:-1]


def unwire(wire):
    """(ops, k, xpt, ypt) of a host copy of the traceback wire."""
    return wire[..., 3:], wire[..., 0], wire[..., 1], wire[..., 2]


def replay_rows(transcript, ocr, wire):
    """:func:`replay_ops` of every row of a (B, 3 + P) host wire, in row
    order, one call per distinct live part ``[k, xpt, ypt, ops[:k]]``: a
    grid's rows hold few distinct alignments. The replay reads nothing
    else of a row, so the ops past k (padding, the walk's counts) never
    split two equal streams. The first row of a live part takes the
    replayed lists, every further row copies of them (callers may mutate
    a row's lists); a stream that ends off its walk's tail raises at its
    first row, as a replay of every row would."""
    ops, k, xpt, ypt = unwire(wire)
    done = {}
    out = []
    for b, kb in enumerate(k.tolist()):
        key = wire[b, :3 + max(kb, 0)].tobytes()
        hit = done.get(key)
        if hit is None:
            hit = done[key] = replay_ops(transcript, ocr, ops[b], kb,
                                         int(xpt[b]), int(ypt[b]))
            out.append(hit)
        else:
            out.append((list(hit[0]), list(hit[1])))
    return out


def _walk_wire(packed, nts, nos, device):
    """Traceback of B filled pairs: the (B, 3 + P) wire, on ``device``."""
    with span("ta.nw.walk"):
        nts = torch.as_tensor(np.asarray(nts, np.int32)).to(device)
        nos = torch.as_tensor(np.asarray(nos, np.int32)).to(device)
        return nw_kernel.traceback_batched(packed, nts, nos)


def _walk(packed, nts, nos, device):
    """Traceback of B filled pairs and one copy of the wire to the host."""
    wire = _walk_wire(packed, nts, nos, device)
    with span("ta.nw.wire"):
        return unwire(wire.cpu().numpy())


def _resolve(device, mesh):
    """The device of a call: this rank's under a mesh (``device``, if
    given, must be it), else :func:`.api.resolve_device`."""
    if mesh is not None:
        from ..parallel.mesh import mesh_device

        return mesh_device(mesh, device)
    from .api import resolve_device

    return resolve_device(device)


def _rank_rows(rows, mesh):
    """This rank's share of ``rows`` (all of them without a mesh), padded
    by copies of row 0 to a multiple of the ``data`` axis: the padded rows
    are valid work whose results are thrown away (``nw_jax``'s rule)."""
    if mesh is None:
        return rows
    from ..parallel.multihost import shard_rows

    return shard_rows(rows, mesh, pad="first")[0]


def _all_wires(wires, n_rows: int, mesh):
    """The host wires of every row on every rank: this rank's device wires
    joined and, under a mesh, all-gathered over its ``data`` axis (on the
    card under NCCL), padded rows dropped; one copy to the host."""
    with span("ta.nw.wire"):
        wire = torch.cat(wires)
        if mesh is None:
            return wire.cpu().numpy()
        from ..parallel.multihost import fetch

        return fetch(wire, mesh)[:n_rows]


def align_ops(transcript, ocr, sc, device):
    """One pair (sentinels included) through the fill kernel and the
    traceback kernel: (ops, k, xpt, ypt) on the host. Integer
    match/mismatch scoring only."""
    with span("ta.nw.align_ops"):
        with span("ta.nw.encode"):
            t, o, nts, nos = lane_batch([(transcript, ocr)])
            params = torch.from_numpy(kernel_params(sc)[None]).to(device)
            t = torch.from_numpy(t).to(device)
            o = torch.from_numpy(o).to(device)
        with span("ta.nw.fill"):
            packed = nw_kernel.fill(t, o, params)
        ops, k, xpt, ypt = _walk(packed, nts, nos, device)
    return ops[0], int(k[0]), int(xpt[0]), int(ypt[0])


def align_ops_plain(transcript, ocr, sc, device):
    """One pair through the plain torch wavefront on ``device`` (callable
    or non-integer scoring), then the traceback kernel."""
    with span("ta.nw.align_ops"):
        with span("ta.nw.encode"):
            t_ids, o_ids, row, S = _encode(transcript, ocr, sc)
            L, NoP = _bucket(len(t_ids)), _bucket(len(o_ids))
            t = torch.from_numpy(_ext(t_ids, L)[None]).to(device)
            o = torch.from_numpy(_ext(o_ids, NoP)[None]).to(device)
            params = torch.from_numpy(row[None]).to(device)
            S = None if S is None else torch.from_numpy(S).to(device)
        with span("ta.nw.fill"):
            packed = nw_kernel.fill_reference(t, o, params, S)
        ops, k, xpt, ypt = _walk(packed, [len(t_ids)], [len(o_ids)],
                                 device)
    return ops[0], int(k[0]), int(xpt[0]), int(ypt[0])


def _per_launch(L: int, NoP: int) -> int:
    return max(1, PTR_BUDGET // ((L + NoP - 1) * L))


def grid_step(n: int, L: int, NoP: int) -> int:
    """Rows a launch of an n-row grid in an (L, NoP) bucket: the fewest
    launches within ``PTR_BUDGET``, their rows as equal as can be (the last
    may be smaller), so each launch fills the card alike."""
    launches = max(1, -(-n // _per_launch(L, NoP)))
    return max(1, -(-n // launches))


def align_pairs(pairs, sc, min_device_cells: int | None = None,
                device=None, mesh=None):
    """Many (transcript, ocr) pairs under one integer match/mismatch
    scoring (``nw_jax.align_pairs_jax``). Pairs of fewer than
    ``min_device_cells`` cells (default: the host/device crossover,
    ``align.api.auto_device_min_cells``) run the host fill; the rest are
    grouped by padded (L, NoP) bucket and each group runs as one batched
    fill (its scoring row shared) and one traceback launch. Returns
    (tra_align, ocr_align) per pair in input order, or None per pair when
    the scoring is not integer match/mismatch (the caller aligns those one
    by one). Sentinels are appended here. ``device``: None means the card
    (:func:`.api.resolve_device`), or under a ``mesh`` this rank's device.
    ``mesh``: each bucket's pairs are sharded over the mesh's ``data``
    axis, every rank fills and walks its share and the wires are gathered,
    so every rank returns the whole list; the host/device split depends on
    the pairs alone, the same on every rank."""
    if not kernel_form(sc):
        return [None for _ in pairs]
    from .api import auto_device_min_cells

    device = _resolve(device, mesh)
    min_cells = (auto_device_min_cells() if min_device_cells is None
                 else min_device_cells)
    with span("ta.nw.align_pairs"):
        results = [None] * len(pairs)
        groups: dict[tuple[int, int], list[int]] = {}
        prepared = []
        for idx, (t, o) in enumerate(pairs):
            t, o = list(t) + [" "], list(o) + [" "]
            prepared.append((t, o))
            if len(t) * len(o) < min_cells:
                results[idx] = traceback(t, o,
                                         DensePtrView(*fill_host(t, o, sc)))
            else:
                groups.setdefault((_bucket(len(t)), _bucket(len(o))),
                                  []).append(idx)

        with span("ta.nw.encode"):
            params = torch.from_numpy(kernel_params(sc)[None]).to(device)
        wired = []
        for (L, NoP), members in sorted(groups.items()):
            step = _per_launch(L, NoP)
            mine = _rank_rows(np.asarray(members), mesh)
            wires = []
            for c0 in range(0, len(mine), step):
                with span("ta.nw.encode"):
                    t, o, nts, nos = lane_batch([prepared[i]
                                                 for i in mine[c0:c0 + step]])
                    t = torch.from_numpy(t).to(device)
                    o = torch.from_numpy(o).to(device)
                with span("ta.nw.fill"):
                    packed = nw_kernel.fill_batched(t, o, params, nts, nos)
                wires.append(_walk_wire(packed, nts, nos, device))
                del packed
            wired.append((members,
                          unwire(_all_wires(wires, len(members), mesh))))
        with span("ta.nw.replay"):
            for members, (ops, k, xpt, ypt) in wired:
                for bi, i in enumerate(members):
                    results[i] = replay_ops(*prepared[i], ops[bi],
                                            int(k[bi]), int(xpt[bi]),
                                            int(ypt[bi]))
    return results


def align_grid(transcript, ocr, params_list, device=None, mesh=None):
    """One (transcript, ocr) pair under many integer scoring rows
    [match, mismatch, gox, goy, gex, gey], the reference's boundary gap
    extend on both axes (``nw_jax.align_grid_jax``): the 729-combination
    grid search. Every combination of a launch reads the one transcript
    row and the one OCR row (``shared_feed``) and its own scoring row
    (``per_pair``); the combination axis is cut into equal launches whose
    packed pointers stay within ``PTR_BUDGET`` (:func:`grid_step`).
    Returns (tra_align, ocr_align) per row, each distinct wire replayed
    once (:func:`replay_rows`). Sentinels are appended here.
    ``device``: None means the card (:func:`.api.resolve_device`), or
    under a ``mesh`` this rank's device. ``mesh``: the rows are sharded
    over the mesh's ``data`` axis (padded with copies of row 0, their
    results thrown away), every rank fills and walks its share, and the
    wires are gathered, so every rank returns the whole list."""
    device = _resolve(device, mesh)
    with span("ta.nw.align_grid"):
        with span("ta.nw.encode"):
            transcript = list(transcript) + [" "]
            ocr = list(ocr) + [" "]
            t_ids, o_ids = _token_ids(transcript, ocr)
            Nt, No = len(t_ids), len(o_ids)
            L, NoP = _bucket(Nt), _bucket(No)
            p6 = np.asarray(params_list, np.int64)
            if p6.ndim != 2 or p6.shape[1] != 6:
                raise ValueError(f"params_list must be rows of 6 integers, "
                                 f"got shape {p6.shape}")
            rows = np.concatenate(
                [p6, np.full((len(p6), 2), BOUNDARY_GAP_EXTEND, np.int64)],
                axis=1).astype(np.int32)
            mine = _rank_rows(rows, mesh)
            step = grid_step(len(mine), L, NoP)
            t = torch.from_numpy(_ext(t_ids, L)[None]).to(device)
            o = torch.from_numpy(_ext(o_ids, NoP)[None]).to(device)
        wires = []
        for c0 in range(0, len(mine), step):
            with span("ta.nw.fill"):
                pr = torch.from_numpy(mine[c0:c0 + step]).to(device)
                packed = nw_kernel.fill_batched(t, o, pr, [Nt], [No])
            n = pr.shape[0]
            wires.append(_walk_wire(packed, [Nt] * n, [No] * n, device))
            del packed
        wire = _all_wires(wires, len(rows), mesh)
        with span("ta.nw.replay"):
            return replay_rows(transcript, ocr, wire)
