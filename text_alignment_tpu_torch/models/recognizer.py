"""Batched line recognizer: the in-process replacement for the
``ocropus-rpred`` subprocess, on one torch device.

Counterpart of ``text_alignment_tpu/models/recognizer.py``. Given a list of
onebit line strips it produces per-line llocs rows ``(char, x)`` with x in
line-local pixels rounded to one decimal. With ``normalize_on_device=True``
(the production path on the card) the strips are bit-packed into one
upload and one program on the device unpacks, normalizes
(:mod:`.lineest`), runs the BiLSTM (:mod:`.lstm`) and the CTC decode
(:mod:`.ctc`) and packs a small uint16 wire, the same wire as the
reference's, which makes it the parity surface. Otherwise strips are
normalized on the host by the reference's scipy normalizer.

The batched pipeline (``parallel/batch``) drives the asynchronous half:
``dispatch_async`` queues a batch of host strips and returns at once;
``collect_async`` brings any number of dispatches back in one copy. With
a ``mesh`` (a ``torch.distributed`` device mesh, :mod:`..parallel.mesh`)
the batch is sharded over the ranks of its ``data`` axis
(:mod:`..parallel.infer_dp`) and every rank decodes the whole batch; the
asynchronous half then runs synchronously. There is no kernel fallback: a
kernel that fails to build or launch raises.

The network is ocropy's BiLSTM (:class:`.lstm.BiLSTMParams`, one posterior
a normalized column) or kraken's default VGSL network
(:class:`.vgsl.VGSLParams`, one posterior each 8 columns), on the same
entry points: :func:`_decode_frames` runs either, and a decoded frame of the
second is placed at its pooled window's centre column (:func:`.vgsl.
frame_columns`), so that the wire, the llocs positions, the escalation
and the frame bucket's hint stay in normalized columns for both. The mesh
path takes the BiLSTM alone.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lineest_host as _host_lineest
from .codec import Codec
from .lineest_host import DEFAULT_PAD
from .pyrnn import load_pyrnn
from .ctc import llocs_positions, translate_back_batched
from .lineest import normalize_batch_device
from .lstm import BiLSTMParams, bilstm_forward_batched, params_from_np, \
    pin_float32
from .vgsl import VGSLNet, VGSLParams, frame_columns, kernel_params, \
    load_vgsl, vgsl_forward_batched

_MAX_REGIONS = 512
# the wire ships this many regions per line by default and escalates x4
# toward _MAX_REGIONS when a line hits the cap
_WIRE_REGIONS = 128
_MIN_BUCKET = 128
_MAX_BUCKET = 8192


def _bucket_T(t: int) -> int:
    b = _MIN_BUCKET
    while b < t and b < _MAX_BUCKET:
        b *= 2
    return b


def _unpack_bits(packed_meta):
    """(B, Hp + 1, Wq) int32 -> (grey (B, Hp, 32 Wq) u8 {0 ink, 1 bg},
    hs (B,), ws (B,)): rows [0, Hp) are little-endian strip bits, the last
    row carries each strip's raw (h, w) in its first two lanes."""
    hs = packed_meta[:, -1, 0].contiguous()
    ws = packed_meta[:, -1, 1].contiguous()
    bits = packed_meta[:, :-1]
    B, Hp, Wq = bits.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    ink = (bits[..., None] >> shifts) & 1          # bit k of each word
    grey = (1 - ink).to(torch.uint8).reshape(B, Hp, Wq * 32)
    return grey, hs, ws


def _decode_frames(params, frames, lengths, max_regions, decode):
    """The recognizer's network on (B, T, height) frames of ``lengths``
    valid columns, each network called by this module's name of it, and
    the CTC decode: (frames (B, R), classes (B, R), counts (B,)), frames
    in normalized columns."""
    vgsl = isinstance(params, VGSLNet)
    post, n = (vgsl_forward_batched(params, frames, lengths) if vgsl else
               (bilstm_forward_batched(params, frames, lengths), lengths))
    fr, cl, cnt = translate_back_batched(post, n, max_regions=max_regions,
                                         mode=decode)
    return (frame_columns(fr) if vgsl else fr), cl, cnt


def _recognize_device_wire(params, packed_meta, t_max, target_height, pad,
                           max_regions, decode="region"):
    """Device OCR for one bit-packed batch: unpack -> normalize -> BiLSTM
    -> CTC decode -> wire, left on the device. The wire is (B, 6 + 2 *
    max_regions) int32 rows of uint16 values: [count_lo, count_hi,
    length_lo, length_hi, t_raw_lo, t_raw_hi, frames[max_regions],
    classes[max_regions]]."""
    grey, hs, ws = _unpack_bits(packed_meta)
    B = grey.shape[0]
    frames, lengths, t_raws = normalize_batch_device(
        grey, hs, ws, target_height=target_height, pad=pad, t_max=t_max,
        onebit=True)
    fr, cl, cnt = _decode_frames(params, frames, lengths, max_regions,
                                 decode)
    hdr = torch.stack([cnt, lengths, t_raws], dim=1).to(torch.int32)
    hdr16 = torch.stack([hdr & 0xFFFF, (hdr >> 16) & 0xFFFF], dim=2)
    return torch.cat([hdr16.reshape(B, 6), fr, cl], dim=1).to(torch.int32)


def _recognize_device_impl(*args, **kwargs):
    """:func:`_recognize_device_wire` copied to the host as uint16 rows."""
    wire = _recognize_device_wire(*args, **kwargs)
    return wire.cpu().numpy().astype(np.uint16)


def _unpack_wire_rows(packed_u16: np.ndarray) -> np.ndarray:
    """uint16 wire rows -> (B, 3 + 2 * max_regions) int32
    [count, length, t_raw, frames, classes]."""
    p = np.asarray(packed_u16).astype(np.int32)
    hdr = p[:, 0:6:2] + (p[:, 1:6:2] << 16)
    return np.concatenate([hdr, p[:, 6:]], axis=1)


class SeqRecognizer:
    """BiLSTM+CTC line recognizer with ocropy-compatible input contract, or
    kraken's default VGSL network on the same entry points."""

    def __init__(self, params: BiLSTMParams | VGSLParams, codec: Codec,
                 target_height: int = 48, pad: int = DEFAULT_PAD,
                 normalize_on_device: bool = False, mesh=None,
                 decode: str = "region", device=None):
        """``device``: where the BiLSTM, the decode and (with
        ``normalize_on_device=True``) the line normalizer run; None means
        the card (:func:`..align.api.resolve_device`: it raises when there
        is none), or under a ``mesh`` this rank's device. On a CUDA device
        they run through the port's kernels; on the CPU (``device="cpu"``)
        through their plain versions. ``mesh``: shard every batch over the
        mesh's ``data`` axis (:mod:`..parallel.infer_dp`), the multi-device
        serving path. ``decode``: "region" (ocropy parity), "bestpath" or
        "region_end" (see :mod:`.ctc`). ``params``: ocropy's BiLSTM, or
        kraken's network (:class:`.vgsl.VGSLParams`, with
        ``target_height=120``, its input height, and kraken's greedy
        ``decode="bestpath"``), held as ``self.params`` in the kernel's
        layout (:class:`.vgsl.VGSLNet`)."""
        if decode not in ("region", "bestpath", "region_end"):
            raise ValueError(f"unknown decode mode {decode!r}")
        from ..align.api import resolve_device

        pin_float32()
        if mesh is not None:
            from ..parallel.mesh import mesh_device

            device = mesh_device(mesh, device)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = params.to(self.device)
        if isinstance(self.params, VGSLParams):
            # the LSTMs in the recurrence kernel's layout, made once
            self.params = kernel_params(self.params)
        self.codec = codec
        self.target_height = target_height
        self.pad = pad
        self.normalize_on_device = normalize_on_device
        self.decode = decode
        # observed frames per pixel of strip width of the last batch: sizes
        # the next batch's frame bucket (see _initial_t_max)
        self._fpp_hint: float | None = None

    @classmethod
    def from_pyrnn(cls, path: str, decode: str = "region", device=None):
        params_np, codec, target_height = load_pyrnn(path)
        return cls(params_from_np(params_np), codec, target_height,
                   decode=decode, device=device)

    @classmethod
    def from_vgsl(cls, path: str, decode: str = "bestpath", device=None):
        """kraken's network from a :func:`.vgsl.save_vgsl` file (the VGSL
        trainer's checkpoint), at its input height."""
        params, charset, height = load_vgsl(path)
        return cls(params, Codec(charset), height, decode=decode,
                   device=device)

    def normalize(self, strip: np.ndarray):
        lnorm = _host_lineest.CenterNormalizer(self.target_height)
        return _host_lineest.normalize_strip(strip, lnorm, self.pad)

    def recognize_batch(self, strips) -> list[list[tuple[str, float]]]:
        """strips: list of 2-D bool (True = ink) or grey arrays. Returns,
        per strip, the llocs rows [(char, x_one_decimal), ...]."""
        if self.normalize_on_device and all(
                np.asarray(s).dtype == bool for s in strips):
            # grey strips keep the host normalizer (the device path is
            # defined over onebit crops, the pipeline's production input)
            return self._recognize_batch_device(strips)
        prepared = []  # (orig_index, frames, raw_width)
        results: list = [[] for _ in strips]
        for i, s in enumerate(strips):
            norm = self.normalize(np.asarray(s))
            if norm is None:
                continue  # blank line -> no llocs rows
            frames, raw_w = norm
            prepared.append((i, frames, raw_w))

        buckets: dict[int, list[int]] = {}
        for k, (_, frames, _) in enumerate(prepared):
            buckets.setdefault(_bucket_T(frames.shape[0]), []).append(k)

        for Tb, members in sorted(buckets.items()):
            B = max(8, 1 << (len(members) - 1).bit_length())
            xs = np.zeros((B, Tb, self.target_height), np.float32)
            lengths = np.zeros(B, np.int32)
            for bi, k in enumerate(members):
                frames = prepared[k][1][:Tb]  # past the ladder top: clip
                xs[bi, :frames.shape[0]] = frames
                lengths[bi] = frames.shape[0]
            if self.mesh is not None:
                from ..parallel.infer_dp import decode_frames_sharded

                fr, cl, cnt = decode_frames_sharded(
                    self.params, xs, lengths, self.mesh,
                    max_regions=_MAX_REGIONS, decode=self.decode,
                    device=self.device)
            else:
                fr, cl, cnt = (t.cpu().numpy() for t in _decode_frames(
                    self.params, torch.from_numpy(xs).to(self.device),
                    torch.from_numpy(lengths).to(self.device), _MAX_REGIONS,
                    self.decode))
            for bi, k in enumerate(members):
                orig_i, _, raw_w = prepared[k]
                n = int(cnt[bi])
                xs_pos = llocs_positions(fr[bi, :n], raw_w, int(lengths[bi]),
                                         self.pad)
                results[orig_i] = [
                    (self.codec.charset[int(c)], x)
                    for c, x in zip(cl[bi, :n], xs_pos)
                ]
        return results

    def _to_device(self, packed_meta):
        return torch.from_numpy(np.ascontiguousarray(packed_meta)).to(
            self.device)

    def _dispatch_device(self, packed_meta, t_max, max_regions=_MAX_REGIONS):
        if self.mesh is not None:
            from ..parallel.infer_dp import recognize_sharded_meta

            return _unpack_wire_rows(recognize_sharded_meta(
                self.params, packed_meta, self.mesh, t_max=t_max,
                target_height=self.target_height, pad=self.pad,
                max_regions=max_regions, decode=self.decode,
                device=self.device))
        return _unpack_wire_rows(_recognize_device_impl(
            self.params, self._to_device(packed_meta), t_max=t_max,
            target_height=self.target_height, pad=self.pad,
            max_regions=max_regions, decode=self.decode))

    def _wire_async(self, pm_dev, t_max):
        return _recognize_device_wire(
            self.params, pm_dev, t_max=t_max,
            target_height=self.target_height, pad=self.pad,
            max_regions=_WIRE_REGIONS, decode=self.decode)

    def dispatch_async(self, strips):
        """Queue device OCR for onebit ``strips`` WITHOUT waiting for it:
        returns an opaque handle whose device work overlaps whatever the
        host does next (the next folio's raster). Redeem with
        ``collect_async``.
        Grey strips and a recognizer with a mesh run synchronously (the
        guard of recognize_batch; every rank's collectives in order); the
        handle then carries the finished rows."""
        if not strips:
            return ("rows", [], None)
        inks = [np.asarray(s) for s in strips]
        if self.mesh is not None or not all(g.dtype == bool for g in inks):
            return ("rows", self.recognize_batch(strips), None)
        packed_meta, hs, ws, Wp = self._pack_strips(inks)
        t_max = self._initial_t_max(Wp, ws[: len(inks)])
        out = self._wire_async(self._to_device(packed_meta), t_max)
        return (inks, out, (t_max, packed_meta, ws))

    @staticmethod
    def _materialize_live(live):
        """One copy to the host for the live handles' queued wires (no
        kernel fallback: a failure raises)."""
        cat = torch.cat([h[1] for h in live], dim=0)
        return cat.cpu().numpy().astype(np.uint16)

    def collect_async(self, handles):
        """Materialize a batch of dispatch_async handles (one combined
        device->host copy) and decode to llocs rows per handle."""
        live = [h for h in handles if h[0] != "rows" and h[1] is not None]
        if live:
            cat = _unpack_wire_rows(self._materialize_live(live))
            splits = np.cumsum([h[1].shape[0] for h in live])[:-1]
            parts = iter(np.split(cat, splits, axis=0))
        results = []
        for handle in handles:
            if handle[0] == "rows":
                results.append(handle[1])
                continue
            inks, _, (t_max, packed_meta, ws) = handle
            packed = self._escalate_if_clipped(inks, next(parts), t_max,
                                               packed_meta)
            self._update_fpp_hint(packed, ws, len(inks))
            results.append(self._decode_packed(inks, packed))
        return results

    def collect_async_bg(self, handles):
        """Start :meth:`collect_async` on a background thread, on the
        caller's current CUDA stream, and return a zero-arg join callable
        yielding its rows: the first folios' results come back while the
        host still rasters the rest."""
        import threading

        out: dict = {}
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def _run():
            try:
                if stream is None:
                    out["rows"] = self.collect_async(handles)
                else:
                    with torch.cuda.stream(stream):
                        out["rows"] = self.collect_async(handles)
            except BaseException as e:  # re-raised at join
                out["err"] = e

        th = threading.Thread(target=_run, daemon=True)
        th.start()

        def _join():
            th.join()
            if "err" in out:
                raise out["err"]
            return out["rows"]

        return _join

    @staticmethod
    def _plan_pack(shapes):
        """(B, Hp, Wp) ladders for a batch of (h, w) strip shapes: height
        on a multiple-of-32 ladder, width on a multiple-of-256 ladder,
        batch on multiples of 4 up to 16 and of 32 above (the reference's
        ladders, which bound the set of shapes a manuscript produces)."""
        max_h = max(h for h, _ in shapes)
        Hp = max(32, -(-max_h // 32) * 32)
        max_w = max(w for _, w in shapes)
        Wp = max(256, -(-max_w // 256) * 256)
        n = len(shapes)
        if n <= 16:
            B = max(8, -(-n // 4) * 4)
        else:
            B = -(-n // 32) * 32
        return B, Hp, Wp

    def _pack_strips(self, inks):
        B, Hp, Wp = self._plan_pack([g.shape for g in inks])
        # +1 metadata row: each strip's raw (h, w) ride in the last row's
        # first two int32 lanes, so the batch is ONE upload
        bits = np.zeros((B, Hp + 1, Wp // 8), np.uint8)
        hs = np.zeros(B, np.int32)
        ws = np.zeros(B, np.int32)
        for b, g in enumerate(inks):
            h, w = g.shape
            bits[b, :h, :(w + 7) // 8] = np.packbits(g, axis=1,
                                                     bitorder="little")
            hs[b], ws[b] = h, w
        meta = bits.view(np.int32).reshape(B, Hp + 1, Wp // 32)
        meta[:, Hp, 0] = hs
        meta[:, Hp, 1] = ws
        return meta, hs, ws, Wp

    def _initial_t_max(self, Wp: int, ws=None) -> int:
        """First frame bucket of a batch: Wp for the first batch of a
        recognizer, later sized from the observed frames-per-pixel ratio
        (_fpp_hint) on a multiple-of-128 ladder; the clip escalation below
        stays the correctness net. Capped at _MAX_BUCKET."""
        if self._fpp_hint is not None and ws is not None and len(ws):
            need = int(float(np.max(ws)) * self._fpp_hint) + 2 * self.pad + 2
            t = -(-need // _MIN_BUCKET) * _MIN_BUCKET
        else:
            t = Wp
        return min(_MAX_BUCKET, max(_MIN_BUCKET, t))

    def _escalate_if_clipped(self, inks, packed, t_max, packed_meta):
        """A thin-ink line zooms to more frames than the strip is wide; if
        any line hit the frame cap, double the bucket and rerun. Likewise a
        line whose decode filled the region block escalates the region
        cap toward _MAX_REGIONS."""
        R = (packed.shape[1] - 3) // 2
        n = len(inks)
        while True:
            t_clip = t_max < _MAX_BUCKET and np.any(
                packed[:n, 2] >= t_max - 2 * self.pad)
            r_clip = R < _MAX_REGIONS and np.any(packed[:n, 0] >= R)
            if not (t_clip or r_clip):
                return packed
            if t_clip:
                t_max = min(_MAX_BUCKET, t_max * 2)
            if r_clip:
                R = min(_MAX_REGIONS, R * 4)
            packed = self._dispatch_device(packed_meta, t_max, max_regions=R)

    def _update_fpp_hint(self, packed, ws, n):
        t_raw = packed[:n, 2].astype(np.float64)
        w = np.asarray(ws[:n], np.float64)
        ok = (w > 0) & (t_raw > 2 * self.pad)
        if np.any(ok):
            self._fpp_hint = float(np.max(t_raw[ok] / w[ok]))

    def _decode_packed(self, inks, packed):
        R = (packed.shape[1] - 3) // 2
        results: list = [[] for _ in inks]
        for i in range(len(inks)):
            cnt, length = int(packed[i, 0]), int(packed[i, 1])
            if cnt <= 0 or length <= 2 * self.pad:
                continue
            fr = packed[i, 3:3 + cnt]
            cl = packed[i, 3 + R:3 + R + cnt]
            xs_pos = llocs_positions(fr, inks[i].shape[1], length, self.pad)
            results[i] = [
                (self.codec.charset[int(c)], x) for c, x in zip(cl, xs_pos)
            ]
        return results

    def _recognize_batch_device(self, strips):
        """Device-normalized path: one bit-packed upload, one program on
        the device, one small wire download (plus a rerun when a line
        clips its frame or region cap)."""
        if not strips:
            return []
        inks = [np.asarray(s) for s in strips]
        packed_meta, hs, ws, Wp = self._pack_strips(inks)
        t_max = self._initial_t_max(Wp, ws[:len(inks)])
        packed = self._dispatch_device(packed_meta, t_max,
                                       max_regions=_WIRE_REGIONS)
        packed = self._escalate_if_clipped(inks, packed, t_max, packed_meta)
        self._update_fpp_hint(packed, ws, len(inks))
        return self._decode_packed(inks, packed)
