"""Smoke run of text_alignment_tpu_torch on one CUDA card.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --profile    # only the launch profiles (below)

Phases, each printing one line (any failure exits non-zero):
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build the CUDA kernels from text_alignment_tpu_torch/csrc/ with nvcc;
  3. the BiLSTM recurrence kernel against its plain version on the card, on
     the folio's own frames (B, T = t_max, ni = 48, ns = 100) and on seeded
     frames of the gate strips' shape (B = 96, T = 512); bar 1e-4; at each,
     the batch tile bt (one CTA a tile, K = 1), threads per CTA, the
     compiler's registers and spill bytes, kernel ms and cuDNN's
     torch.nn.LSTM ms on the same frames; at the gate strips, the ms of
     the other batch tiles; the wide route (ns = 256, seeded weights)
     against its plain version on the folio's first 48 frames, then its ms
     beside cuDNN's torch.nn.LSTM(48, 256) on the folio's frames;
  4. the normalizer tail kernel against its plain version on the card, bit
     for bit (center, dsum, dcnt), on the folio's own h-gauss output and
     on the gate strips of phase 14; at each, every launch's grid, threads
     and shared bytes, kernel ms (CUDA events), plain ms and bound;
  5. the slice: process() on a full-size synthetic folio (2000 x 1600 px,
     11 lines, packed at B = 12, Hp = 96, Wp = 1536) with a random-weight
     .pyrnn.gz (ni = 48, ns = 100): one warm-up call, then five measured
     calls; both kernels' launch counts over those must be >= 1; median
     milliseconds of each stage and of the whole call;
  6. the same recognizer and page on the CPU (the plain versions) against
     the card: every line's decoded characters identical;
  7. nw_fill: the kernel against its plain version on a seeded 4096^2 pair
     with the planned segments and with a forced S = 128 (pointer bytes
     identical on every valid cell); the plan (P segments of S lanes, run
     lanes a thread), ms and GCUPS at the bench's 8191^2 and 16383^2
     pairs, and there the ms at forced S = 64 to 1024 lanes and 1 to 4
     lanes a thread; the chain floor; perform_alignment(backend="device") against
     backend="host" at 16383^2 and at 26,000 x 2,000 (past the old
     one-block cap of 25,600 lanes; aligned lists equal), the
     device/host times of perform_alignment from 128^2 to 2048^2, and
     perform_alignment(backend="reference") (the literal fill, on the
     host) equal to "host" and "device" at 20 x 24, 64 x 60 and 150 x 140
     under the default scoring and a callable, with its ms;
  8. nw_traceback: one walk step in shared memory (ta_nw_tb_chase); the
     kernel against its plain version (ops[:k], k, xpt, ypt identical) on
     the phase-7 4096^2 pointers, the 8191^2 and 16383^2 pairs, one 2400^2
     grid launch (243 scoring rows) and a mixed-length batch, with kernel
     ms, the longest k, the chain floor (k x the step), windows and
     misses; perform_alignment(backend="device") at 16383^2 split into the
     fill, the walk, the wire's copy and the host replay;
  9. nw_fill_batched: align_pairs(min_device_cells=0) on six pairs of one
     bucket against the host; align_grid over the 729-row scoring grid on
     the folio's transcript against its corrupted OCR and on a seeded
     2400^2 pair, combos/s, 27 sampled rows against the host fill, and
     each grid's work summed over its launches: fill, walk, wire copy and
     host replay; the kernel against its plain version (pointer bytes
     identical on every valid cell) on the chant grid's one launch (729
     rows), one 2400^2 grid launch (243 rows) and its first 8 rows, and
     16 chant rows, with its plan (G, run, threads, registers, CTAs), ms
     and chain floor;
  10. NW inside process(): a 6000 x 4000 px page of 30 lines whose pair
     passes auto_device_min_cells(), OCR injected; process(backend="hybrid")
     on the card launches nw_fill and nw_traceback and its JSON equals the
     same call on the CPU device (the host fill);
  11. the CC kernels against their plain versions on the card, on the
     binarized 2000 x 1600 page of the first phase-13 folio (cc_filter:
     three modes at four thresholds; cc_clean: the whole chain) and on its
     rotated, eroded, separator-masked page (cc_table): packed pages
     byte-identical, tables, counts and ok equal, and all equal to the
     host oracle; kernel ms (CUDA events, median of 5) and plain ms; and
     on the phase-5 folio, whose ~49k black runs overflow the 45,056-run
     capacity, the same overflow flag and page as the plain version;
  12. the skew search on the card against the host oracle's angle on the
     folio and two rotated copies; ms per page;
  13. process_batch on 8 full-size folios (2000 x 1600 px, 11 lines of
     three words) with the phase-5 model on the card, with
     backend="device" and backend="hybrid" (both raster on the card
     through ops/device.py's chain): every folio's JSON byte-identical to
     the sequential process() on the card; cc_clean, cc_table and
     raster_rotate_erode launched >= 8 times in each; ms per folio of
     both and of the sequential calls, with the stage split and the time
     in Python's garbage collector; one more hybrid call under
     torch.profiler: its device-busy share and longest idle gaps;
  14. the full-chain normalizer kernel (lineest_full) against its plain
     version on the card, bit for bit (center, dsum, dcnt), on the phase-5
     folio's packed strips and on >= 64 strips of nine 1600 x 1300 pages
     (seeds 30-38, the JAX package's full-chain gate recipe); kernel ms
     (CUDA events, median of 5), the default chain's ms on the same inputs
     (the cuBLAS v-gauss and banded h-gauss products, then the lineest_tail
     kernel), plain ms and bound;
  15. the reference's own gate for the full chain, on those >= 64 strips
     through the recognizer with the phase-3 weights:
     TEXT_ALIGNMENT_TPU_TAIL=full against the default, decoded counts and
     classes identical on every strip, >= 95% of wire rows byte-identical;
  16. serving: 8 job files (the phase-13 folios and the phase-5 model)
     drained by serve(once=True, do_warmup=True) with
     TEXT_ALIGNMENT_TPU_TAIL=full, once one job at a time and once with
     batch=8: no job failed, the one-at-a-time drain called process_job 8
     times and process_batch never, the batch=8 drain called process_batch
     once and process_job never (no one-job retry), lineest_full launched
     >= 8 times in the one-at-a-time drain, all 16 outputs byte-identical
     to process()'s JSON under the same setting; the warm-up's ms, the
     drain's ms per job and its split by route;
  17. the launch profiles (--profile, below) in a child process: the
     device time of each launch of one CC pass, the chain, the table, the
     tail and the full chain, and at most 4 launches a CC pass and the
     table, 13 for the chain, 3 for the tail and 4 for the full chain;
  18. training on the card (models/train.py) on the corpus of
     tests/test_train_quality.py (two pages of seeds 200 and 201, every
     line, ni = 48, ns = 100): (a) one step from the same seeded weights
     and batch on the card and on the CPU, the loss to 1e-5 relative and
     the gradients to 1e-4 x their global norm; (b) the test's recipe (lr
     5e-3, at most 700 steps, stop at loss < 0.08) from Trainer(seed=1)'s
     weights (the JAX trainer's for seed 1), then the held-out page (seed 990) decoded by SeqRecognizer
     on the card with the device normalizer, process()'s setting for
     backend="hybrid": lstm_scan and lineest_tail launched, character
     accuracy >= 0.85, the CPU decode of the same weights identical; the
     mean position error beside the test's 2.5-char-width bound, as a
     report; (c) save_state at step 5, load_state, on to step 10: weights
     bit-identical to the uninterrupted run; (d) ms a step at B = 16
     (median of 20 after 3 warm-up steps) split into forward, backward and
     optimizer, the device-busy share of 5 steps under torch.profiler, and
     (b)'s wall time;
  19. the mesh on the card (parallel/: mesh, infer_dp, train_dp,
     multihost): (a) one NCCL rank in this process, make_mesh(1): phase
     13's 8 folios through process_batch(mesh=, min_align_device_cells=0)
     give phase 13's JSON byte for byte, the 729-row grids of phase 9
     (chant and 2400^2) through align_grid(mesh=) equal phase 9's, every
     collective through NCCL; (b) 2 gloo ranks spawned on cuda:0 with a
     deadline (NCCL refuses two ranks on one card): the same bytes in
     every rank, one equal OCR work share a rank, each rank's launches of
     lstm_scan, lineest_tail, nw_fill_batched and nw_traceback >= 1; in
     both, sharded_train_demo_step(data_model_mesh(world)) and a
     Trainer-recipe step on the phase-18 corpus match the one-process step
     to 1e-5 relative; ms a folio beside phase 13's, and each grid timed
     3 times sharded and unsharded in turn after a warm-up at its full
     729-row shape, with the sharded grid's split (fill, walk, the wires'
     gather and copy, the host replay). Two
     ranks on one card test the partition and the collectives, not
     scaling;
  20. the end-to-end example (text_alignment_tpu_torch/examples/
     end_to_end_synthetic.py) at its defaults on the card: eight rendered
     pages (seeds 100-107, 64 lines), the fast recipe from Trainer(seed=1)
     in minibatches of 32 lines at T = 512 (ni = 48, ns = 100) to the stop
     loss 0.15, a .pyrnn.gz saved at each rung of the ladder (6.0, 1.5,
     0.5) and at the end, each reloaded and run through
     process(backend="hybrid") on the held-out page (seed 999, skewed and
     speckled). Gates: the example's own PASS (>= 80% of the 70 GT
     syllables found and ink IoU > 0.50 at the final checkpoint,
     wrong-line 0 at all four rungs), lstm_scan and lineest_tail launched
     in that run, the final checkpoint reloaded on the CPU (the plain
     versions) giving the card's all_chars and syl_boxes JSON, and the
     perfect-OCR ceiling's JSON byte-identical on the card and the CPU.
     Reports only: steps to the stop loss, ms a step (median), the
     training wall, each rung's CER, syllables, bbox and ink IoU and
     diagnosis counts, the ceiling's IoUs, the final checkpoint once more
     under TEXT_ALIGNMENT_TPU_TAIL=full (lineest_full on a trained model)
     beside the default tail, and the phase's wall;
  21. backend="device" (ops/device.py): process() on the phase-5 folio
     (~49k black runs, no fallback) on the card, one warm-up and three
     measured calls, JSON byte-identical to backend="hybrid" on the card
     and to backend="device" on the CPU; cc_clean, cc_table, nw_fill,
     nw_traceback, lstm_scan and lineest_tail launched in the measured
     calls; ms of both backends with the stage split; backend="hybrid" on
     the card rasters there: one raster_rotate_erode, one cc_clean and one
     cc_table launch a folio, JSON byte-identical to backend="hybrid" on
     the CPU (the native engine); the card route's raster by step, host
     ms (each step ending in a sync) and device ms (torch.profiler); the
     rotate + erode + project kernel (csrc/raster.cu) on the folio's
     packed stage-1 page at its detected angle and seeded ones, bit for
     bit its plain version (on the CPU) and the native rotate + erode
     and projection, its ms beside its bound and the plain chain's ms on
     the card; rodan_job.run_task with its default backend on the folio
     gives process()'s JSON; the 499 x 40 px serpentine is one component
     on the card (the JAX device labeling counts 59).
  22. the port's bench, python -m text_alignment_tpu_torch.bench --out
     DIR, in a child process on the card (BENCH_ARGS): it exits 0, its last
     line is the folios/sec headline, DIR/bench_last.json holds the 13
     metrics, each finite and positive, with the card's line, its batch
     guard passed (the batched JSON equals the sequential JSON folio for
     folio), and the run launched lstm_scan, lineest_tail, nw_fill,
     nw_fill_batched, nw_traceback and cc_clean; the 13 metrics on one
     line beside the card's name and power limit, and the phase's wall.
  23. kraken's default network (models/vgsl.py) on the main path:
     process(backend="hybrid") on the phase-5 folio with a SeqRecognizer of
     seeded VGSLParams at the spec's widths (target height 120, best path,
     the card's normalizer), one warm-up call, then three measured calls:
     three lstm_scan launches each network call and one tail call each
     normalizer call, median ms of each stage and of the call; on the
     recognizer's own packed batch of the folio, the tail against its
     plain version bit for bit (its inputs are the strips, whatever the
     target height: the 120 rows enter after it, in the dewarp), the
     first layer's recurrence (ns = 200, the wide route, NQ = 50) on its
     own gx against its plain version over every frame (bar 1e-4), with
     the plan, the kernel's ms and cuDNN's torch.nn.LSTM(960, 200) on the
     same features, and the whole network's posteriors against the plain
     reference (models/vgsl_reference.py), one line at a time at its own
     width (bar 1e-4), with the ms of the network and its conv stack.
The phases run one at a time: 1-17, 21, 22, 23, then 18-20. Each group of
phases prints its wall and the script's so far ("wall:").
Then one JSON line with each kernel's launches (from its own path's run:
the folio for lstm_scan and lineest_tail, phase 10 for nw_fill and
nw_traceback, the 2400^2 grid for nw_fill_batched, phase 13's hybrid run
for the CC kernels, phase 16's one-at-a-time drain for lineest_full,
phase 21's backend="hybrid" calls for raster_rotate_erode, phase 23's
measured calls for lstm_scan.kraken and lineest_tail.kraken), error, times
and bound (nw_fill_batched's at one 2400^2 grid launch, the shape its
launches have, with its chain floor beside; lstm_scan.kraken's at the
first layer's recurrence, one of the three a network call), and last the
device JSON line. Weights and pages are made from fixed
seeds. Needs no network and no JAX.

With --profile it runs phases 1 and 2, then only the launch profiles of
the CC kernels (phase 11's pages), the default tail and the full chain
(the folio's strips of phases 4 and 14) and the device timeline of one
process_batch(backend="hybrid") call
(with its garbage-collector time), and prints last one JSON line of the
launch counts; it needs only the package's entry points, so it profiles
an older tree of the port from a copy placed in that tree.

bound_ms is the larger of the bytes a kernel must move (each input read
once, each output written once) over 3.35 TB/s and its operations over
67 T/s, the H100 SXM's published HBM rate and float32 rate outside the
tensor cores; the integer kernels' operations are counted against that
rate too (the published table has no int32 row), which makes their bound
a floor. The traceback's real floor is a latency chain, not bytes: phase 8
prints it as the longest walk's k times one step of the walk measured in
shared memory (ta_nw_tb_chase).
"""

from __future__ import annotations

import gc
import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from text_alignment_tpu_torch import _kernels
from text_alignment_tpu_torch.align import align_grid, perform_alignment
from text_alignment_tpu_torch.align import nw_kernel as nwk
from text_alignment_tpu_torch.align import nw_torch as nwt
from text_alignment_tpu_torch.align.api import auto_device_min_cells
from text_alignment_tpu_torch.align.scoring import resolve_scoring
from text_alignment_tpu_torch.evaluate import scoring_grid
from text_alignment_tpu_torch.models import lineest as tle
from text_alignment_tpu_torch.models import lstm as tl
from text_alignment_tpu_torch.models.codec import Codec
from text_alignment_tpu_torch.models.lineest_host import normalize_strip
from text_alignment_tpu_torch.models.lineest_kernel import (
    center_full_cuda, center_full_reference, tail_cuda, tail_plan,
    tail_reference)
from text_alignment_tpu_torch.models import lstm_kernel as lk
from text_alignment_tpu_torch.models import recognizer as rz
from text_alignment_tpu_torch.models import vgsl, vgsl_reference
from text_alignment_tpu_torch.models.lstm_kernel import (
    bidir_scan_cuda, bidir_scan_reference)
from text_alignment_tpu_torch.models.pyrnn import save_pyrnn
from text_alignment_tpu_torch.models.recognizer import (
    SeqRecognizer, _unpack_bits)
from text_alignment_tpu_torch.models.train import (
    Trainer, batch_lines, clip_by_global_norm)
from text_alignment_tpu_torch.ops import cc, host_native, oracle
from text_alignment_tpu_torch.ops import device as dv
from text_alignment_tpu_torch.ops import fixedpoint as fxp
from text_alignment_tpu_torch.ops import skew_device as sd
from text_alignment_tpu_torch.parallel import process_batch
from text_alignment_tpu_torch.pipeline import process, to_JSON_dict
from text_alignment_tpu_torch.pipeline.preprocess import (
    PackedPage, PreprocParams, _peaks_and_separators, identify_text_lines,
    preprocess_images)
from text_alignment_tpu_torch.pipeline.process import _resolve_recognizer
from text_alignment_tpu_torch.serve import serve
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)
from text_alignment_tpu_torch.utils.timing import stage_timer

NI, NS = 48, 100
WIDE_NS = 256  # phase 3's width on the recurrence's wide route
LSTM_BAR = 1e-4
# kraken's network on the card against its plain reference: the two sum in
# other orders (the recurrence's h . Wh, cuDNN's convolutions); a gate or
# weight out of place moves a posterior by more than 1e-2
VGSL_BAR = 1e-4
OCR_KERNELS = ("lstm_scan", "lineest_tail")
NW_ALPHABET = "abcdefgh "
DEFAULT_ROW = [8, -4, -7, -7, -3, 0, -1, -1]  # the reference's default
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM, published
ALU_OPS_PER_MS = 67e12 / 1e3      # float32 outside the tensor cores
N_FOLIOS = 8
CC_PASS_LAUNCHES = 4  # launches of one CC filter pass or table, at most
TAIL_LAUNCHES = 3     # launches of one default tail call
FULL_LAUNCHES = 4     # launches of one full-chain call


class PhaseError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def peaky_params(seed: int, nout: int):
    """Random weights whose posteriors are peaky but whose recurrence is
    not chaotic: input weights in +-2, recurrent in +-0.3, W2 in +-2 and a
    blank bias of 9 (the region decoder then splits each line into many
    regions)."""
    rng = np.random.default_rng(seed)
    d = tl.init_params_np(rng, NI, NS, nout, initial_range=0.3)
    for direction in ("fwd", "bwd"):
        for k in ("WGI", "WGF", "WGO", "WCI"):
            d[direction][k][:, 1:1 + NI] *= 2.0 / 0.3
    d["W2"] = rng.uniform(-2, 2, d["W2"].shape).astype(np.float32)
    d["W2"][0, 0] += 9.0
    return d


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the ALU rate, whichever is larger."""
    b, o = nbytes / HBM_BYTES_PER_MS, ops / ALU_OPS_PER_MS
    return {"bound_ms": max(b, o),
            "bound_by": "bytes" if b >= o else "operations"}


def median_ms(fn, n: int = 5) -> float:
    """Median milliseconds of ``n`` calls of ``fn`` on the card, each
    between its own pair of CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def make_folio(seed: int = 2024, words_per_line: int = 4):
    return make_page(
        np.random.default_rng(seed), n_lines=11,
        words_per_line=words_per_line, H=2000, W=1600, char_h=66, char_w=36,
        gap=6, space_w=44, line_spacing=170, speckles=200, margin_x=60)


def make_batch_folio(seed: int):
    """A folio of the batch: the phase-5 folio's geometry with three words
    a line, ~41k black and ~43k white runs, inside the CC kernels' default
    capacity of 45,056 (a real text page has ~39k and ~41k); the four-word
    folio has ~49k and ~51k."""
    return make_folio(seed, words_per_line=3)


def binarize_pack(image):
    """The page binarized on the host (greyscale, Otsu) and bit-packed:
    ((H, ceil(W/32)) int32 words, (H, W))."""
    binar = oracle.to_onebit(image)
    return cc.pack_page(binar), binar.shape


def phase_card():
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    t0 = time.perf_counter()
    _kernels.lib()
    built = ("nvcc" if _kernels.build_seconds is not None
             else "already built")
    print(f"build: {time.perf_counter() - t0:.2f} s ({built}) -> "
          f"{_kernels.library_path()}")


def folio_inputs(rec, inks, dev):
    """The main path's shapes and tensors for this folio: the packed batch
    as the recognizer plans it, its normalized frames and the tail's
    inputs, all on the card."""
    packed_meta, hs, ws, Wp = rec._pack_strips(inks)
    t_max = rec._initial_t_max(Wp, ws[:len(inks)])
    grey, hs_t, ws_t = _unpack_bits(torch.from_numpy(packed_meta).to(dev))
    _, _, _, sm, temp, k2 = tle.center_inputs(grey, hs_t, ws_t, onebit=True)
    frames, lengths, _ = tle.normalize_batch_device(
        grey, hs_t, ws_t, target_height=rec.target_height, pad=rec.pad,
        t_max=t_max, onebit=True)
    B, Hp, _ = grey.shape
    print(f"folio: {len(inks)} strips packed at B={B} Hp={Hp} Wp={Wp} "
          f"t_max={t_max}")
    return dict(packed_meta=packed_meta, t_max=t_max, sm=sm, temp=temp,
                k2=k2, hs=hs_t, ws=ws_t, frames=frames, lengths=lengths)


def lstm_work(gx, lengths):
    """Bytes and operations of one recurrence: gx, Wh, the peepholes and h
    once each; per valid step of a direction and row, the 4ns x ns product
    and ~16ns elementwise operations."""
    _, T, B, G = gx.shape
    ns = G // 4
    steps = int(lengths.sum().item())  # per direction
    nbytes = 4 * (gx.numel() + 2 * ns * G + 2 * 3 * ns + 2 * T * B * ns)
    return nbytes, 2 * steps * (8 * ns * ns + 16 * ns)


def lstm_plan_line(B, ns, dev, bt):
    """The batch tile, the clusters and what the compiler made of the
    instantiation: threads, registers, spills, Wh quads in registers and
    shared bytes. A narrow tile is one CTA (K = 1); a wide one a cluster of
    K CTAs, of which the card holds ``active`` at once."""
    a = lk.kernel_attrs(ns, bt, dev)
    check(a["threads"] <= a["max_threads"], f"lstm_scan: {a['threads']} "
          f"threads over the instantiation's {a['max_threads']}")
    return (f"plan bt={bt} K={a['cluster']}: {2 * -(-B // bt)} clusters "
            f"(the card holds {a['active_clusters']} at once) of "
            f"{a['cluster']} CTAs of {a['threads']} "
            f"threads, {a['regs']} registers a thread, {a['local_bytes']} "
            f"spill bytes, Wh quads in registers {a['quads_in_registers']} "
            f"and in global memory {a['quads_in_global']} of "
            f"{lk.quads(ns)}, shared bytes {a['shared_bytes']}")


def lstm_case(params, frames, lengths, dev, alt_tiles=()):
    """The kernel against its plain version and cuDNN on one batch of
    frames; ms of the other batch tiles given."""
    gx, whT, peep = tl.scan_inputs(params, frames, lengths)
    _, T, B, G = gx.shape
    bt = lk.card_plan(B, NS, dev)
    got = bidir_scan_cuda(gx, whT, peep)
    ref = bidir_scan_reference(gx, whT, peep)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max().item())
    ms = cuda_ms(lambda: bidir_scan_cuda(gx, whT, peep), 20)
    # the library yardstick: cuDNN's bidirectional LSTM on the same frames
    # (it also computes the input projection, which gx already holds)
    lstm = torch.nn.LSTM(NI, NS, bidirectional=True,
                         batch_first=True).to(dev)
    with torch.no_grad():
        library_ms = median_ms(lambda: lstm(frames))
    for other in alt_tiles:
        alt = cuda_ms(lambda: bidir_scan_cuda(gx, whT, peep, bt=other), 10)
        print(f"lstm_scan: B={B} T={T} other tile "
              f"{lstm_plan_line(B, NS, dev, other)}: {alt:.3f} ms")
    nbytes, ops = lstm_work(gx, lengths)
    b = bound(nbytes, ops)
    print(f"lstm_scan: B={B} T={T} ns={NS} {lstm_plan_line(B, NS, dev, bt)}"
          f"; max_abs_err={err:.3e} (bar {LSTM_BAR}) kernel {ms:.3f} ms "
          f"({ms * 1e3 / T:.3f} us a step) torch.nn.LSTM (cuDNN) "
          f"{library_ms:.3f} ms, bound {b['bound_ms']:.5f} ms by "
          f"{b['bound_by']}")
    check(err <= LSTM_BAR, f"lstm_scan disagrees at B={B} T={T}: {err} > "
          f"{LSTM_BAR}")
    return dict(gx=gx, whT=whT, peep=peep, err=err, ms=ms,
                library_ms=library_ms, bound=b)


def phase_lstm(rec, fi, dev):
    """Phase 3: the recurrence at the folio's shapes and at the gate
    strips' (B = 96, T = 512, seeded frames), each against its plain
    version and cuDNN, with the batch tile and the compiler's registers;
    at the folio, the plain version's ms; at the gate strips, the other
    batch tiles' ms."""
    folio = lstm_case(rec.params, fi["frames"], fi["lengths"], dev)
    plain_ms = cuda_ms(lambda: bidir_scan_reference(
        folio["gx"], folio["whT"], folio["peep"]), 3)
    rng = np.random.default_rng(96)
    frames = torch.from_numpy(
        rng.normal(0, 1, (96, 512, NI)).astype(np.float32)).to(dev)
    lengths = torch.from_numpy(
        rng.integers(256, 513, 96).astype(np.int32)).to(dev)
    lstm_case(rec.params, frames, lengths, dev, alt_tiles=(1, 4, 8))
    phase_lstm_wide(fi, dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"lstm_scan: plain {plain_ms:.3f} ms at the folio; SM clock now, "
          f"max: {smi.stdout.strip()}")
    return {"max_abs_err": folio["err"], "ms": folio["ms"],
            "plain_ms": plain_ms, **folio["bound"],
            "library_ms": folio["library_ms"]}


def phase_lstm_wide(fi, dev):
    """Phase 3, the wide route: ns = WIDE_NS on seeded weights against its
    plain version on the folio's first 48 frames (the plain version loops
    over ns in Python), then the kernel's ms beside cuDNN's
    torch.nn.LSTM(NI, WIDE_NS, bidirectional=True) on the folio's frames."""
    rng = np.random.default_rng(WIDE_NS)
    params = tl.params_from_np(
        tl.init_params_np(rng, NI, WIDE_NS, 29, initial_range=0.3), dev)
    frames, lengths = fi["frames"], fi["lengths"]
    short = frames[:, :48].contiguous()
    gx, whT, peep = tl.scan_inputs(params, short, lengths.clamp(max=48))
    got = bidir_scan_cuda(gx, whT, peep)
    ref = bidir_scan_reference(gx, whT, peep)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max().item())
    check(err <= LSTM_BAR, f"lstm_scan (ns = {WIDE_NS}) disagrees: {err} > "
          f"{LSTM_BAR}")
    gx, whT, peep = tl.scan_inputs(params, frames, lengths)
    _, T, B, _ = gx.shape
    bt = lk.card_plan(B, WIDE_NS, dev)
    ms = cuda_ms(lambda: bidir_scan_cuda(gx, whT, peep), 5)
    lstm = torch.nn.LSTM(NI, WIDE_NS, bidirectional=True,
                         batch_first=True).to(dev)
    with torch.no_grad():
        library_ms = median_ms(lambda: lstm(frames))
    b = bound(*lstm_work(gx, lengths))
    print(f"lstm_scan wide: ns={WIDE_NS} max_abs_err={err:.3e} at T=48 (bar "
          f"{LSTM_BAR}); B={B} T={T} {lstm_plan_line(B, WIDE_NS, dev, bt)}; "
          f"kernel {ms:.3f} ms ({ms * 1e3 / T:.3f} us a step) torch.nn.LSTM "
          f"(cuDNN) {library_ms:.3f} ms, bound {b['bound_ms']:.5f} ms by "
          f"{b['bound_by']}")


def tail_inputs(packed_meta, dev):
    """The default tail's inputs for a packed strip batch on the card, as
    normalize_batch_device builds them: sm, the ink mask, (h, w) and the
    smoothing taps."""
    grey, hs, ws = _unpack_bits(torch.from_numpy(packed_meta).to(dev))
    _, _, _, sm, temp, k2 = tle.center_inputs(grey, hs, ws, onebit=True)
    return sm, temp, hs, ws, k2


def tail_work(sm, temp, hs, ws, k2):
    """The bytes and operations the tail needs on these strips: sm and the
    ink mask inside each strip's (h, w) read once, the taps, (h, w) and the
    outputs; per strip, the two windowed means, v and the argmax over
    h x w, and per column of the batch the smoothing over the strip's
    nonzero taps (a pair: an add, a multiply and an add)."""
    B, _, Wp = sm.shape
    k2 = k2.cpu()
    ops = nbytes = 0
    for b, (h, w) in enumerate(zip(hs.tolist(), ws.tolist())):
        n_taps = int((k2[b] != 0).sum())
        ops += 4 * h * w + Wp * (3 * (n_taps // 2) + 1)
        nbytes += 5 * h * w
    nbytes += 8 * k2.numel() + 8 * B + 4 * B * Wp + 8 * B
    return nbytes, ops


def tail_check(name, args, sms):
    """The tail on one strip batch against its plain version, bit for bit
    (center, dsum, dcnt); each launch's plan, kernel and plain ms, bound."""
    got = tail_cuda(*args)
    ref = tail_reference(*args)
    torch.cuda.synchronize()
    same = [torch.equal(g, r) for g, r in zip(got, ref)]
    err = max(float((g.long() - r.long()).abs().max().item())
              for g, r in zip(got, ref))
    sm, k2 = args[0], args[4]
    B, Hp, Wp = sm.shape
    plan = "; ".join(
        f"{p['pass']} {p['grid'][0]}x{p['grid'][1]} = "
        f"{p['grid'][0] * p['grid'][1]} CTAs of {p['threads']} threads, "
        f"{p['regs']} registers, {p['smem']} shared bytes"
        for p in tail_plan(B, Hp, Wp, k2.shape[1], sm.device))
    ms = cuda_ms(lambda: tail_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: tail_reference(*args), 5)
    b = bound(*tail_work(*args))
    print(f"lineest_tail: {name} strips B={B} Hp={Hp} Wp={Wp} "
          f"K2={k2.shape[1]}: center, dsum, dcnt identical to the plain "
          f"version {same}; launches [{plan}] on {sms} SMs; kernel {ms:.4f} "
          f"ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.5f} ms by "
          f"{b['bound_by']}")
    check(all(same), f"lineest_tail differs from its plain version on the "
          f"{name} strips (max |d| {err})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def phase_tail(rec, fi, strips, dev):
    """Phase 4: the tail against its plain version on the folio's strips
    and on the gate strips; the folio's figures go into the kernels line."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    folio = tail_check("folio", (fi["sm"], fi["temp"], fi["hs"], fi["ws"],
                                 fi["k2"]), sms)
    tail_check("gate", tail_inputs(rec._pack_strips(strips)[0], dev), sms)
    return folio


def run_process(page, path, timer=None):
    out = process(page.image, page.transcript, ocropus_model=path,
                  backend="hybrid", verbose=False, device="cuda",
                  timer=timer)
    torch.cuda.synchronize()
    return out


def phase_slice(page, path, n_runs=5):
    """process() once to build and warm up, then ``n_runs`` measured calls:
    the median of each stage and of the whole call, and the launches."""
    t0 = time.perf_counter()
    run_process(page, path)
    first_ms = (time.perf_counter() - t0) * 1e3
    timers, totals = [], []
    _kernels.reset_launches()
    for _ in range(n_runs):
        timer = stage_timer(enabled=True)
        t0 = time.perf_counter()
        out = run_process(page, path, timer)
        totals.append((time.perf_counter() - t0) * 1e3)
        timers.append(timer)
    launches = dict(_kernels.launches)
    check(out is not None, "process() returned None (no OCR characters)")
    syl_boxes, _, peaks, chars = out
    js = to_JSON_dict(syl_boxes, peaks)
    check(json.loads(json.dumps(js)) == js, "JSON does not round-trip")
    stages = {k: round(float(np.median([t.totals[k] for t in timers])) * 1e3,
                       3) for k in timers[0].totals}
    print(f"slice: lines={len(peaks)} chars={len(chars)} "
          f"syl_boxes={len(js['syl_boxes'])} launches={launches} over "
          f"{n_runs} calls; first call {first_ms:.1f} ms, then median "
          f"{np.median(totals):.1f} ms (min {min(totals):.1f}, max "
          f"{max(totals):.1f}), median stages ms {stages}")
    for name in OCR_KERNELS:
        check(launches[name] >= 1,
              f"kernel {name} was not launched on the main path")
    return launches


def phase_kraken(page, inks, codec, dev, n_runs=3):
    """Phase 23: kraken's default network on the main path (see the
    module's docstring). Returns (stats of lstm_scan.kraken and
    lineest_tail.kraken, their launches over the measured calls)."""
    params = vgsl.params_from_np(vgsl.init_params_np(
        np.random.default_rng(vgsl.HEIGHT), len(codec)), dev)
    rec = SeqRecognizer(params, codec, target_height=vgsl.HEIGHT,
                        decode="bestpath", normalize_on_device=True,
                        device=dev)

    def run(timer=None):
        out = process(page.image, page.transcript, ocropus_model=rec,
                      backend="hybrid", verbose=False, device="cuda",
                      timer=timer)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    first_ms = (time.perf_counter() - t0) * 1e3
    calls = {"vgsl_forward_batched": 0, "normalize_batch_device": 0}
    orig = {name: getattr(rz, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return orig[name](*args, **kwargs)
        return call

    timers, totals = [], []
    try:
        for name in calls:
            setattr(rz, name, counted(name))
        _kernels.reset_launches()
        for _ in range(n_runs):
            timer = stage_timer(enabled=True)
            t0 = time.perf_counter()
            out = run(timer)
            totals.append((time.perf_counter() - t0) * 1e3)
            timers.append(timer)
        launches = {k: _kernels.launches[k] for k in OCR_KERNELS}
    finally:
        for name, fn in orig.items():
            setattr(rz, name, fn)
    check(out is not None, "process() with kraken's network returned None "
          "(no OCR characters)")
    syl_boxes, _, peaks, chars = out
    js = to_JSON_dict(syl_boxes, peaks)
    check(json.loads(json.dumps(js)) == js, "JSON does not round-trip")
    stages = {k: round(float(np.median([t.totals[k] for t in timers])) * 1e3,
                       3) for k in timers[0].totals}
    print(f"kraken: lines={len(peaks)} chars={len(chars)} "
          f"syl_boxes={len(js['syl_boxes'])} network calls "
          f"{calls['vgsl_forward_batched']}, normalizer calls "
          f"{calls['normalize_batch_device']}, launches={launches} over "
          f"{n_runs} calls; first call {first_ms:.1f} ms, then median "
          f"{np.median(totals):.1f} ms (min {min(totals):.1f}, max "
          f"{max(totals):.1f}), median stages ms {stages}")
    check(calls["vgsl_forward_batched"] >= n_runs
          and launches["lstm_scan"] == 3 * calls["vgsl_forward_batched"],
          f"lstm_scan launched {launches['lstm_scan']} times for "
          f"{calls['vgsl_forward_batched']} network calls (3 a call)")
    check(calls["normalize_batch_device"] >= n_runs
          and launches["lineest_tail"] == calls["normalize_batch_device"],
          f"lineest_tail called {launches['lineest_tail']} times for "
          f"{calls['normalize_batch_device']} normalizer calls")

    fi = folio_inputs(rec, inks, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tail = tail_check("kraken folio", (fi["sm"], fi["temp"], fi["hs"],
                                       fi["ws"], fi["k2"]), sms)
    net, frames, lengths = rec.params, fi["frames"], fi["lengths"]
    with torch.no_grad():
        xs, n = vgsl.conv_features(net, frames, lengths)
        gx, whT, peep = vgsl.scan_inputs(net.lstm[0], xs, n)
    _, T, B, G = gx.shape
    ns = G // 4
    got = bidir_scan_cuda(gx, whT, peep)
    ref = bidir_scan_reference(gx, whT, peep)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max().item())
    ms = cuda_ms(lambda: bidir_scan_cuda(gx, whT, peep), 10)
    plain_ms = cuda_ms(lambda: bidir_scan_reference(gx, whT, peep), 1)
    lstm = torch.nn.LSTM(xs.shape[2], ns, bidirectional=True,
                         batch_first=True).to(dev)
    with torch.no_grad():
        library_ms = median_ms(lambda: lstm(xs))
    b = bound(*lstm_work(gx, n))
    bt = lk.card_plan(B, ns, dev)
    print(f"lstm_scan kraken: layer 1 of 3, ns={ns} NQ={lk.quads(ns)} "
          f"nin={xs.shape[2]} B={B} T={T} valid frames {n.tolist()} "
          f"{lstm_plan_line(B, ns, dev, bt)}; max_abs_err={err:.3e} over "
          f"every frame (bar {LSTM_BAR}) kernel {ms:.3f} ms "
          f"({ms * 1e3 / T:.3f} us a step), plain {plain_ms:.3f} ms, "
          f"torch.nn.LSTM (cuDNN, with the input projection) "
          f"{library_ms:.3f} ms, bound {b['bound_ms']:.5f} ms by "
          f"{b['bound_by']}")
    check(err <= LSTM_BAR, f"lstm_scan (ns = {ns}) disagrees on the kraken "
          f"folio: {err} > {LSTM_BAR}")

    post, n_post = vgsl.vgsl_forward_batched(net, frames, lengths)
    keep = [i for i, v in enumerate(n_post.tolist()) if v > 0]
    want = vgsl_reference.posteriors(
        params, [frames[i, :lengths[i]] for i in keep], device=dev)
    net_err = max(float((post[i, :n_post[i]] - w).abs().max().item())
                  for i, w in zip(keep, want))
    net_ms = cuda_ms(lambda: vgsl.vgsl_forward_batched(net, frames,
                                                       lengths), 5)
    conv_ms = cuda_ms(lambda: vgsl.conv_features(net, frames, lengths), 5)
    print(f"kraken network: {len(keep)} lines, frames (B={frames.shape[0]}, "
          f"T={frames.shape[1]}, {frames.shape[2]} rows); posteriors "
          f"against the reference line by line max_abs_err={net_err:.3e} "
          f"(bar {VGSL_BAR}); network {net_ms:.3f} ms, conv stack "
          f"{conv_ms:.3f} ms")
    check(net_err <= VGSL_BAR, f"kraken's network disagrees with its "
          f"reference on the folio: {net_err} > {VGSL_BAR}")
    scan = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}
    return ({"lstm_scan.kraken": scan, "lineest_tail.kraken": tail},
            {"lstm_scan.kraken": launches["lstm_scan"],
             "lineest_tail.kraken": launches["lineest_tail"]})


def profile_ocr(rec, inks):
    """Device time by kernel over one OCR batch (torch.profiler); the
    table goes to stderr. Returns (device busy ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    rec.recognize_batch(inks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.recognize_batch(inks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=25),
          file=sys.stderr)
    # device events only: an operator's row repeats its kernels' time
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, wall


def phase_cpu_vs_cuda(params_np, codec, inks, fi):
    cpu = SeqRecognizer(tl.params_from_np(params_np), codec,
                        normalize_on_device=True, device="cpu")
    gpu = SeqRecognizer(tl.params_from_np(params_np), codec,
                        normalize_on_device=True, device="cuda")
    w_cpu = cpu._dispatch_device(fi["packed_meta"], fi["t_max"], 128)
    w_gpu = gpu._dispatch_device(fi["packed_meta"], fi["t_max"], 128)
    n = len(inks)
    same_rows = int((w_cpu[:n] == w_gpu[:n]).all(axis=1).sum())
    rows_cpu = cpu.recognize_batch(inks)
    rows_gpu = gpu.recognize_batch(inks)
    s_cpu = ["".join(c for c, _ in r) for r in rows_cpu]
    s_gpu = ["".join(c for c, _ in r) for r in rows_gpu]
    same_str = sum(a == b for a, b in zip(s_cpu, s_gpu))
    print(f"cpu_vs_cuda: decoded strings identical {same_str}/{n} lines, "
          f"wire rows byte-identical {same_rows}/{n}, chars "
          f"{sum(map(len, s_gpu))}")
    check(same_str == n, f"decoded strings differ: {s_cpu} vs {s_gpu}")
    return gpu


def seeded_pair(n: int, m: int, seed: int):
    """A random (transcript, ocr) pair over NW_ALPHABET, no sentinels."""
    rng = np.random.default_rng(seed)
    a = list(NW_ALPHABET)
    return ([a[k] for k in rng.integers(0, len(a), n)],
            [a[k] for k in rng.integers(0, len(a), m)])


def nw_tensors(ts, os_, dev):
    """Lane-layout tensors of pairs on the card (sentinels appended)."""
    arrays = nwt.lane_batch([(list(t) + [" "], list(o) + [" "])
                             for t, o in zip(ts, os_)])
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def valid_equal(a, b, nts, nos) -> bool:
    """Pointer bytes of every valid cell (i < Nt, j < No) equal."""
    for k in range(a.shape[0]):
        Nt, No = int(nts[k]), int(nos[k])
        ii = torch.arange(Nt, device=a.device)[:, None]
        jj = torch.arange(No, device=a.device)[None, :]
        if not torch.equal(a[k, ii + jj, ii], b[k, ii + jj, ii]):
            return False
    return True


def wire_equal(w1, w0) -> bool:
    """Traceback wires equal on k, xpt, ypt and ops[:k]."""
    if not torch.equal(w1[:, :3], w0[:, :3]):
        return False
    return all(torch.equal(w1[b, 3:3 + int(w1[b, 0])],
                           w0[b, 3:3 + int(w0[b, 0])])
               for b in range(w1.shape[0]))


def timed_once(fn):
    """(result, milliseconds) of one call on the card, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def wall_ms(fn):
    """(result, host-clock milliseconds) of one call ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def fill_plan_text(B, L, sms, seg=None):
    """'P = ..., S = ..., run = ...' of a launch of B pairs of L lanes."""
    S, run = nwk.fill_plan(B, L, sms) if seg is None else (
        seg, nwk._lanes_per_thread(seg))
    return (f"P = {-(-L // S)} segments of S = {S} lanes, run = {run} "
            f"({S // run} threads)")


def max_sm_mhz() -> float:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.strip().splitlines()[0])


def chain_floor_ms(D: int, mhz: float) -> float:
    """The fill's latency floor less its barriers: D diagonals, each a
    dependent chain of four integer operations (the gap add, the two
    maxima of max3, the boundary select) at 4 cycles each, at the card's
    highest SM clock. One barrier a diagonal comes on top (not counted)."""
    return D * 16 / (mhz * 1e3)


def phase_nw_fill(dev):
    """Phase 7: the fill kernel against its plain version at 4096² (the
    planned segments and a forced S = 128); the plan and the kernel's ms
    at the bench's 8191² and 16383² pairs, and there at forced S = 64 to
    1024 and 1 to 4 lanes a thread; perform_alignment on the card against the host fill at
    16383² and at 26,000 x 2,000; the host/device crossover of
    perform_alignment; the reference backend (:func:`nw_reference_backend`)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = max_sm_mhz()
    t, o = seeded_pair(4095, 4095, 7)
    tt, oo, nts, nos = nw_tensors([t], [o], dev)
    row = torch.tensor([DEFAULT_ROW], dtype=torch.int32, device=dev)
    got = nwk.fill_cuda(tt, oo, row)
    ref, plain_ms = timed_once(lambda: nwk.fill_reference(tt, oo, row))
    same = valid_equal(got, ref, nts, nos)
    small = valid_equal(nwk.fill_cuda(tt, oo, row, seg=128), ref, nts, nos)
    ms = cuda_ms(lambda: nwk.fill_cuda(tt, oo, row), 5)
    L, NoP = tt.shape[1], oo.shape[1]
    print(f"nw_fill: 4096^2 pair, {fill_plan_text(1, L, sms)}: pointer "
          f"bytes identical on valid cells {same}, and at a forced "
          f"{fill_plan_text(1, L, sms, 128)}: {small}; kernel {ms:.3f} ms "
          f"plain {plain_ms:.3f} ms; chain floor "
          f"{chain_floor_ms(L + NoP - 1, mhz):.4f} ms (max SM clock {mhz} "
          f"MHz, barriers not counted)")
    check(same, "nw_fill disagrees with its plain version at 4096^2")
    check(small, "nw_fill at S = 128 disagrees with its plain version")
    fill_bound = bound((L + NoP - 1) * L + 4 * (L + NoP) + 32,
                       20 * int(nts[0]) * int(nos[0]))
    for n in (8191, 16383):
        a, b = seeded_pair(n, n, n)
        ta, ob, _, _ = nw_tensors([a], [b], dev)
        Ln, cells = ta.shape[1], (n + 1) ** 2
        f_ms = cuda_ms(lambda: nwk.fill_cuda(ta, ob, row), 3)
        print(f"nw_fill: {n}^2 pair (L = {Ln}), {fill_plan_text(1, Ln, sms)}:"
              f" kernel {f_ms:.3f} ms = {cells / f_ms / 1e6:.4f} GCUPS (cells "
              f"Nt*No with sentinels); chain floor "
              f"{chain_floor_ms(2 * Ln - 1, mhz):.4f} ms")
        sweep = []  # a report: one timed launch a setting (phase time)
        for seg in (64, 128, 256, 512, 1024):
            for run in (1, 2, 4):
                if seg // run >= 32:
                    s_ms = cuda_ms(lambda: nwk.fill_cuda(
                        ta, ob, row, seg=seg, run=run), 1)
                    sweep.append(f"S={seg} run={run} ({seg // run} threads) "
                                 f"{s_ms:.3f}")
        print(f"nw_fill: {n}^2 forced segments, ms: " + "; ".join(sweep))
    for n, m, seed in ((16383, 16383, 16383), (26000, 2000, 26000)):
        a, b = seeded_pair(n, m, seed)
        dev_al, dev_ms = wall_ms(lambda: perform_alignment(
            a, b, backend="device", device=dev))
        host_al, host_ms = wall_ms(lambda: perform_alignment(
            a, b, backend="host"))
        print(f"nw perform_alignment {n} x {m} (L = {nwt._bucket(n + 1)}): "
              f"device {dev_ms:.1f} ms, host {host_ms:.1f} ms, aligned lists "
              f"equal {dev_al == host_al}")
        check(dev_al == host_al, f"device alignment differs from the host's "
              f"at {n} x {m}")
    for n in (128, 256, 512, 1024, 2048):
        a, b = seeded_pair(n, n, n)
        perform_alignment(a, b, backend="device", device=dev)
        d_ms = min(wall_ms(lambda: perform_alignment(
            a, b, backend="device", device=dev))[1] for _ in range(3))
        h_ms = min(wall_ms(lambda: perform_alignment(
            a, b, backend="host"))[1] for _ in range(3))
        print(f"nw crossover {n}^2: device {d_ms:.3f} ms host {h_ms:.3f} ms")
    nw_reference_backend(dev)
    return ({"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
             **fill_bound, "library_ms": None}, got, nts, nos)


def reference_score(a, b):
    """A callable scoring of phase 7's reference check: the device takes
    it through the plain wavefront, the host through the numpy fill."""
    return 6 if a == b else (-1 if " " in (a, b) else -3)


def nw_reference_backend(dev):
    """perform_alignment(backend="reference") (the literal O(N*M) fill,
    on the host) against "host" and "device" on the card, at three seeded
    pairs under the default scoring and a callable; the reference's ms
    (host clock, one call) under each."""
    sizes = ((20, 24), (64, 60), (150, 140))
    systems = {"default": None,
               "callable": [reference_score, -7, -5, -2, -1]}
    same, times = True, {name: [] for name in systems}
    wall0 = time.perf_counter()
    for n, m in sizes:
        a, b = seeded_pair(n, m, n * m)
        for name, system in systems.items():
            t0 = time.perf_counter()
            ref = perform_alignment(a, b, system, backend="reference")
            times[name].append((time.perf_counter() - t0) * 1e3)
            same &= (ref == perform_alignment(a, b, system, backend="host")
                     == perform_alignment(a, b, system, backend="device",
                                          device=dev))
    print(f"nw reference backend at " + ", ".join(
        f"{n} x {m}" for n, m in sizes) + ": aligned lists equal to host "
        f"and device (card) under both scorings {same}; reference ms "
        + "; ".join(f"{name} " + " ".join(f"{t:.2f}" for t in ts)
                    for name, ts in times.items())
        + f"; the check's wall {(time.perf_counter() - wall0) * 1e3:.1f} ms")
    check(same, "perform_alignment(backend=\"reference\") differs from "
          "the host or the card")


def tb_step_ns(dev, blocks: int = 65536) -> float:
    """Nanoseconds of one step of the traceback's walk in shared memory:
    ``ta_nw_tb_chase`` runs blocks x 16 dependent steps of the kernel's
    walk on one thread over seeded pointers (CUDA events, the mean of 5
    calls after a warm-up)."""
    sink = torch.empty(1024 * 16, dtype=torch.int32, device=dev)
    lib = _kernels.lib()

    def run():
        _kernels.check(lib.ta_nw_tb_chase(
            sink.data_ptr(), blocks, dev.index or 0,
            _kernels.stream_handle(dev)), "nw_tb_chase launch")

    return cuda_ms(run, 5) * 1e6 / (blocks * 16)


def chant_pair(page):
    """The folio's transcript against its corrupted OCR (315 x 312), the
    chant-size grid's pair."""
    ocr = ocr_with_spaces(corrupt_ocr(np.random.default_rng(5),
                                      page.char_boxes))
    return list(page.transcript), [c.char for c in ocr]


def grid_rows(rows) -> np.ndarray:
    """Scoring-grid rows as the kernels' int32 rows (boundary gap -1)."""
    rows = np.asarray(rows)
    return np.concatenate([rows, np.full((len(rows), 2), -1)],
                          axis=1).astype(np.int32)


def grid_inputs(t, o, rows, dev):
    """One align_grid launch's inputs on the card: the pair's one
    transcript and one OCR row, a scoring row each, and the pair's sizes
    (one entry each), as align_grid passes them to fill_batched."""
    tt, oo, nts, nos = nw_tensors([t], [o], dev)
    pr = torch.from_numpy(grid_rows(rows)).to(dev)
    return tt, oo, pr, nts, nos


def fill_cases(dev, page=None):
    """The batched fill's cases, one at a time as (name, t, o, params, nts,
    nos): the chant-size grid's one launch (729 rows), one 2400^2 grid
    launch (grid_step rows: 243) and its first 8 rows, and 16 sampled
    chant rows. Phase 9 and chip_nw_ablation.py time these."""
    grid = scoring_grid()
    chant = chant_pair(make_folio() if page is None else page)
    yield ("chant grid launch", *grid_inputs(*chant, grid, dev))
    yield ("2400^2 grid launch", *grid_2400(dev))
    yield ("2400^2 grid, 8 rows", *grid_2400(dev, 8))
    sample = np.random.default_rng(9).choice(len(grid), 27, replace=False)
    yield ("16 chant rows", *grid_inputs(*chant, grid[sample[:16]], dev))


def grid_2400(dev, n=None):
    """The inputs of one align_grid launch on the seeded 2400^2 pair: the
    scoring grid's first ``n`` rows, by default a launch's (grid_step:
    243 of 729)."""
    t, o = seeded_pair(2400, 2400, 2400)
    grid = scoring_grid()
    if n is None:
        n = nwt.grid_step(len(grid), nwt._bucket(2401), nwt._bucket(2401))
    return grid_inputs(t, o, grid[:n], dev)


def grid_launch(dev):
    """The packed pointers of one align_grid launch on the seeded 2400²
    pair (243 rows), and the sizes of its pairs."""
    tt, oo, pr, nts, nos = grid_2400(dev)
    n = pr.shape[0]
    packed = nwk.fill_batched_cuda(tt, oo, pr, nts, nos)
    return packed, nts.expand(n).contiguous(), nos.expand(n).contiguous()


def group_text(B, t, o, nts) -> str:
    """The group route's plan of a launch: G, run, threads, CTAs."""
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    shared = t.shape[0] == 1 and o.shape[0] == 1
    attrs = nwk.group_attrs(t.device, shared)
    run, g, threads = nwk.group_plan(B, int(nts.max()), t.shape[1], sms,
                                     attrs)
    regs, spill, _ = attrs[(run, g)]
    return (f"G = {g}, run = {run}, {threads} threads ({regs} registers, "
            f"{spill} spill bytes), {-(-B // g)} CTAs a launch, "
            f"{nwk.resident_ctas(threads, regs)} resident an SM")


def nw_split(n: int, dev) -> None:
    """perform_alignment(backend="device") on the seeded n² pair, and the
    same work in its parts: the fill and the walk (CUDA events), the
    wire's copy to the host and the host replay (host clock)."""
    a, b = seeded_pair(n, n, n)
    perform_alignment(a, b, backend="device", device=dev)
    total = min(wall_ms(lambda: perform_alignment(
        a, b, backend="device", device=dev))[1] for _ in range(3))
    t, o = list(a) + [" "], list(b) + [" "]
    tt, oo, nts, nos = nw_tensors([a], [b], dev)
    row = torch.from_numpy(
        nwt.kernel_params(resolve_scoring(None))[None]).to(dev)
    packed, fill_ms = timed_once(lambda: nwk.fill(tt, oo, row))
    wire, walk_ms = timed_once(lambda: nwk.traceback_batched(packed, nts,
                                                             nos))
    host, copy_ms = wall_ms(lambda: wire.cpu().numpy())
    ops, k, x, y = nwt.unwire(host)
    _, replay_ms = wall_ms(lambda: nwt.replay_ops(
        t, o, ops[0], int(k[0]), int(x[0]), int(y[0])))
    print(f"nw perform_alignment {n}^2 on the card: {total:.3f} ms wall "
          f"(best of 3); fill {fill_ms:.3f} ms, walk {walk_ms:.3f} ms "
          f"({walk_ms / total:.1%} of the wall), wire "
          f"copy {copy_ms:.3f} ms, host replay {replay_ms:.3f} ms, the rest "
          f"{total - fill_ms - walk_ms - copy_ms - replay_ms:.3f} ms")


def tb_cases(dev, first=None):
    """The traceback's timed cases, one at a time as (name, packed, nts,
    nos): the seeded 4096² pair of phase 7 (``first``, its pointers, when
    the caller holds them), the 8191² and 16383² pairs of phase 7, and one
    2400² grid launch. Phase 8 and chip_nw_ablation.py time these."""
    row = torch.tensor([DEFAULT_ROW], dtype=torch.int32, device=dev)
    if first is None:
        a, b = seeded_pair(4095, 4095, 7)
        ta, ob, tn, on = nw_tensors([a], [b], dev)
        first = (nwk.fill_cuda(ta, ob, row), tn, on)
    yield ("4096^2", *first)
    del first
    for n in (8191, 16383):
        a, b = seeded_pair(n, n, n)
        ta, ob, tn, on = nw_tensors([a], [b], dev)
        yield (f"{n}^2", nwk.fill_cuda(ta, ob, row), tn, on)
    yield ("2400^2 grid launch", *grid_launch(dev))


def tb_text(wire, step: float) -> str:
    """The walk's longest k, its chain floor (k x the measured step) and
    the kernel's window and miss counts, from the kernel's wire."""
    win, mis = nwk.traceback_stats(wire)
    k = int(wire[:, 0].max())
    return (f"longest k = {k}, chain floor {k * step / 1e6:.4f} ms; windows "
            f"{int(win.sum())}, misses {int(mis.sum())}")


def phase_nw_traceback(dev, packed, nts, nos):
    """Phase 8: the traceback kernel against its plain version on
    ``tb_cases`` and a mixed-length batch of one bucket: wires equal,
    kernel ms, k, windows, misses and the chain floor (the longest walk's
    k x the measured step); then perform_alignment's split at 16383²."""
    step = tb_step_ns(dev)
    print(f"nw_traceback: one walk step in shared memory {step:.3f} ns "
          f"(ta_nw_tb_chase)")
    row = torch.tensor([DEFAULT_ROW], dtype=torch.int32, device=dev)
    pairs = [seeded_pair(1100 + 150 * k, 1900 - 140 * k, 50 + k)
             for k in range(6)]
    tt, oo, bn, bo = nw_tensors([p[0] for p in pairs], [p[1] for p in pairs],
                                dev)
    mixed = ("6 mixed pairs", nwk.fill_batched_cuda(tt, oo, row), bn, bo)
    stats = None
    for name, pk, tn, on in itertools.chain(
            tb_cases(dev, (packed, nts, nos)), [mixed]):
        w1 = nwk.traceback_cuda(pk, tn, on)
        w0, plain_ms = timed_once(lambda: nwk.traceback_reference(pk, tn, on))
        same = wire_equal(w1, w0)
        ms = cuda_ms(lambda: nwk.traceback_cuda(pk, tn, on), 10)
        print(f"nw_traceback: {name} (B = {pk.shape[0]}, L = {pk.shape[2]}): "
              f"wire identical {same}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms; {tb_text(w1, step)}")
        check(same, f"nw_traceback disagrees with its plain version at "
              f"{name}")
        if stats is None:  # the kernels line: the 4096² pair
            k = int(w1[:, 0].max())
            stats = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     **bound(k + 4 * (3 + k), 6 * k), "library_ms": None}
        del pk, w1, w0
    del mixed
    nw_split(16383, dev)
    return stats


def host_align(t, o, row6):
    return perform_alignment(t, o, scoring_system=list(map(int, row6)),
                             backend="host")


def phase_nw_batched(dev, page):
    """Phase 9: align_pairs on one bucket against the host; align_grid over
    the 729-row scoring grid at chant size and at 2400², a sample of rows
    against the host fill, and each grid's work split into fill, walk,
    copy and replay; the batched kernel against its plain version on
    ``fill_cases`` (both grids' launches, 8 rows at 2400², 16 chant rows)
    with its plan and ms. Returns the stats (the 2400² launch's), the
    launches of the grid runs and each grid's alignments."""
    pairs = [seeded_pair(1100 + 150 * k, 1950 - 140 * k, 70 + k)
             for k in range(6)]
    buckets = {(nwt._bucket(len(t) + 1), nwt._bucket(len(o) + 1))
               for t, o in pairs}
    got = nwt.align_pairs(pairs, resolve_scoring(None),
                          min_device_cells=0, device=dev)
    same = got == [perform_alignment(t, o, backend="host") for t, o in pairs]
    print(f"nw align_pairs: 6 pairs in buckets {sorted(buckets)} equal to "
          f"the host {same}")
    check(same and len(buckets) == 1, "align_pairs differs from the host")

    chant = chant_pair(page)
    grid = scoring_grid()
    sample = np.random.default_rng(9).choice(len(grid), 27, replace=False)
    launches, grids = {}, {}
    for name, (t, o) in (("chant", chant),
                         ("2400", seeded_pair(2400, 2400, 2400))):
        align_grid(t, o, grid[:2], device=dev)  # warm-up
        _kernels.reset_launches()
        res, g_ms = wall_ms(lambda: align_grid(t, o, grid, device=dev))
        launches[name] = dict(_kernels.launches)
        grids[name] = res
        ok = all(res[k] == host_align(t, o, grid[k]) for k in sample)
        h_ms = min(wall_ms(lambda: host_align(t, o, grid[0]))[1]
                   for _ in range(3))
        print(f"nw align_grid {name} ({len(t)} x {len(o)}): 729 rows in "
              f"{g_ms:.1f} ms = {729e3 / g_ms:.1f} combos/s (host fill one "
              f"row {h_ms:.3f} ms = {1e3 / h_ms:.1f} combos/s); 27 sampled "
              f"rows equal to the host {ok}; launches {launches[name]}")
        check(ok, f"align_grid {name} differs from the host fill")
        check(launches[name]["nw_fill_batched"] >= 1,
              "align_grid did not launch nw_fill_batched")
        print(f"nw align_grid {name} split: "
              f"{split_text(grid_split(t, o, grid, dev))} (the grid's wall "
              f"{g_ms:.1f} ms)")
    for n in (50, 100, 200, 400):  # the grid's 40,000-cell threshold
        t, o = seeded_pair(n, n, n)
        align_grid(t, o, grid, device=dev)
        g_ms = wall_ms(lambda: align_grid(t, o, grid, device=dev))[1]
        h_ms = min(wall_ms(lambda: host_align(t, o, grid[0]))[1]
                   for _ in range(3))
        print(f"nw grid crossover {n}^2: 729 rows on the card {g_ms:.1f} ms, "
              f"729 host fills ~{729 * h_ms:.1f} ms (729 x one row)")

    stats = None
    mhz = max_sm_mhz()
    for name, tt, oo, pr, nts, nos in fill_cases(dev, page):
        B = pr.shape[0]
        sizes = nts.cpu(), nos.cpu()  # host sizes, as align_grid passes
        got = nwk.fill_batched_cuda(tt, oo, pr, *sizes)
        ref, plain_ms = timed_once(lambda: nwk.fill_reference(tt, oo, pr))
        same = valid_equal(got, ref, nts.expand(B), nos.expand(B))
        del ref
        ms = cuda_ms(lambda: nwk.fill_batched_cuda(tt, oo, pr, *sizes), 10)
        Nt, No = int(nts[0]), int(nos[0])
        floor = chain_floor_ms(Nt + No - 1, mhz)
        print(f"nw_fill_batched: {name} (B = {B}, {Nt} x {No} in L = "
              f"{tt.shape[1]}, NoP = {oo.shape[1]}), "
              f"{group_text(B, tt, oo, nts)}: valid cells identical "
              f"{same}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; chain "
              f"floor {floor:.4f} ms")
        check(same, f"nw_fill_batched disagrees with its plain version at "
              f"{name}")
        if name == "2400^2 grid launch":  # the kernels line: its 3 launches
            cells = B * Nt * No
            stats = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     **bound(cells + 4 * (tt.shape[1] + oo.shape[1] + 8 * B
                                          + 2), 20 * cells),
                     "chain_floor_ms": floor, "library_ms": None}
        del got
    return stats, launches, grids


def grid_split(t, o, grid, dev, mesh=None) -> dict:
    """align_grid's work on the pair in its parts, as align_grid does it
    (this rank's rows under ``mesh``): the fill and the walk summed over
    the launches (CUDA events), then the wires' gather (under a mesh) and
    one copy to the host, and the host replay of each distinct wire
    (host clock)."""
    transcript, ocr = list(t) + [" "], list(o) + [" "]
    t_ids, o_ids = nwt._token_ids(transcript, ocr)
    Nt, No = len(t_ids), len(o_ids)
    L, NoP = nwt._bucket(Nt), nwt._bucket(No)
    tt = torch.from_numpy(nwt._ext(t_ids, L)[None]).to(dev)
    oo = torch.from_numpy(nwt._ext(o_ids, NoP)[None]).to(dev)
    rows = grid_rows(grid)
    mine = nwt._rank_rows(rows, mesh)
    step = nwt.grid_step(len(mine), L, NoP)
    parts = {"fill": 0.0, "walk": 0.0}
    wires = []
    for c0 in range(0, len(mine), step):
        pr = torch.from_numpy(mine[c0:c0 + step]).to(dev)
        n = pr.shape[0]
        packed, f_ms = timed_once(
            lambda: nwk.fill_batched(tt, oo, pr, [Nt], [No]))
        bn = torch.full((n,), Nt, dtype=torch.int32, device=dev)
        bo = torch.full((n,), No, dtype=torch.int32, device=dev)
        wire, w_ms = timed_once(lambda: nwk.traceback_batched(packed, bn, bo))
        del packed
        wires.append(wire)
        parts["fill"] += f_ms
        parts["walk"] += w_ms
    host, parts["gather_copy"] = wall_ms(
        lambda: nwt._all_wires(wires, len(rows), mesh))
    _, parts["replay"] = wall_ms(
        lambda: nwt.replay_rows(transcript, ocr, host))
    parts.update(rows=len(mine), step=step)
    return parts


def split_text(parts) -> str:
    return (f"fill {parts['fill']:.3f} ms, walk {parts['walk']:.3f} ms, "
            f"wire gather and copy {parts['gather_copy']:.3f} ms, host "
            f"replay {parts['replay']:.3f} ms ({parts['rows']} rows here in "
            f"launches of {parts['step']})")


def make_big_page():
    """A synthetic page whose transcript x OCR passes the auto threshold:
    30 lines of 12 words on 6000 x 4000 px."""
    return make_page(
        np.random.default_rng(77), n_lines=30, words_per_line=12, H=6000,
        W=4000, char_h=48, char_w=24, gap=4, space_w=30, line_spacing=190,
        speckles=300, margin_x=60)


def phase_nw_process():
    """Phase 10: process() on a page whose NW pair passes
    auto_device_min_cells(), OCR injected: on the card it must launch the
    fill and the traceback, and its JSON must equal the CPU device's."""
    page = make_big_page()
    ocr = ocr_with_spaces(corrupt_ocr(
        np.random.default_rng(6), page.char_boxes))
    cells = (len(page.transcript) + 1) * (len(ocr) + 1)
    check(cells >= auto_device_min_cells(),
          f"page pair of {cells} cells is under the device threshold")

    process_json(page, ocr, "cuda")  # warm-up
    _kernels.reset_launches()
    timer = stage_timer(enabled=True)
    js_gpu, ms = wall_ms(lambda: process_json(page, ocr, "cuda", timer))
    launches = dict(_kernels.launches)
    js_cpu = process_json(page, ocr, "cpu")
    same = js_gpu == js_cpu
    print(f"nw process: transcript {len(page.transcript)} x ocr {len(ocr)} "
          f"chars ({cells} cells), syl_boxes {len(js_gpu['syl_boxes'])}; "
          f"card {ms:.1f} ms, align stage "
          f"{timer.totals['align'] * 1e3:.1f} ms; launches {launches}; JSON "
          f"equal to the CPU device's {same}")
    check(same, "process() JSON differs between the card and the CPU")
    for name in ("nw_fill", "nw_traceback"):
        check(launches[name] >= 1,
              f"kernel {name} was not launched by process()")
    return launches


def process_json(page, ocr, device, timer=None):
    out = process(page.image, page.transcript, existing_ocr=ocr,
                  backend="hybrid", verbose=False, device=device, timer=timer)
    check(out is not None, f"process() on {device} returned None")
    return to_JSON_dict(out[0], out[2])


def cc_ops(H: int, Wq: int, n_runs: int) -> int:
    """Integer operations of one CC filter pass: two passes over the words
    (count and decode, ~12 each) and ~40 per run (union, stats, paint)."""
    return 24 * H * Wq + 40 * n_runs


def masked_eroded(dev, pk, H: int, W: int):
    """A binarized packed page through the card raster's chain (the
    cleanup chain, the skew search, rotate + erode + project), its
    separator rows cleared as the line finder clears them: (eroded bool
    page, its packed words, the separator count). cc_table's input on the
    main path."""
    p = PreprocParams()
    cleaned, ok = cc.cc_clean(pk, H, W, p.despeckle_amt, p.sat_area_thresh,
                              False, dv._capacity(H, W))
    check(int(ok[0]) == 1, "cc_clean overflowed the page's capacity")
    angle = dv.rotation_angle_projections(cc.unpack_bits(cleaned, W),
                                          device=dev)
    H2, W2 = fxp.rotated_canvas(H, W, angle)
    _, eroded, proj = dv.rotate_erode_project_packed(
        cleaned, H, W, *fxp.rotation_coeffs(angle), H2, W2)
    _, sep_rows, _ = _peaks_and_separators(
        proj.cpu().numpy().astype(np.int64), p)
    rows = sorted({r + d for r in sep_rows for d in (0, 1) if r + d < H2})
    pke = eroded.index_fill(0, torch.tensor(rows, device=dev), 0)
    return cc.unpack_bits(pke, W2), pke, len(sep_rows)


def device_events(fn, repeat: int = 3):
    """``fn`` ``repeat`` times under torch.profiler, after a warm-up call,
    each call after a spin kernel of ~1 ms: the card's events (kernels,
    memsets, copies) of each call in start order as (name, start us, end
    us), and the last call's host-clock ms. A call's events are those
    between two spins, or, where the profiler lost a spin's record, those
    on either side of the gap over 0.5 ms that the spin left. The profiler
    also lost a call's own events now and then (one to three, late in a
    process that had profiled before), so a count is the largest of the
    calls'."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeat):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda._sleep(2_000_000)
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e[1])
    calls, cur, last_end = [], [], None
    for name, start, end in events:
        if "spin" in name or (last_end is not None
                              and start - last_end > 500.0):
            if cur:
                calls.append(cur)
            cur = []
        if "spin" not in name:
            cur.append((name, start, end))
        last_end = end if last_end is None else max(last_end, end)
    if cur:
        calls.append(cur)
    return calls, wall


def launch_split(what: str, fn) -> int:
    """Print the device time of each launch of one call of ``fn`` in
    order (kernels and memsets), their sum and the span from the first
    start to the last end, for the profiled call with the most events;
    return its number of launches."""
    calls, _ = device_events(fn)
    check(bool(calls), f"{what}: the profiler saw no device event")
    events = max(calls, key=len)
    split = ", ".join(f"{n} {e - s:.1f}" for n, s, e in events)
    busy = sum(e - s for _, s, e in events)
    span = events[-1][2] - events[0][1]
    kernels = sum(name.startswith("ta_") for name, _, _ in events)
    print(f"launch split {what}: {len(events)} launches ({kernels} of the "
          f"port's kernels), device us [{split}]; sum {busy:.1f} us, span "
          f"{span:.1f} us; launches of the {len(calls)} profiled calls "
          f"{[len(c) for c in calls]}")
    return len(events)


def idle_gaps(what: str, fn, n_gaps: int = 5) -> None:
    """Print the device-busy share of one call of ``fn`` (the union of its
    device events over the host-clock wall) and its longest idle gaps,
    each with the events before and after it."""
    calls, wall = device_events(fn, repeat=1)
    events = sorted((e for c in calls for e in c), key=lambda e: e[1])
    if not events:
        print(f"device timeline {what}: the profiler saw no device event "
              f"(not measured)")
        return
    busy, gaps = 0.0, []
    cur_name, cur_s, cur_e = events[0]
    for name, s, e in events[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_name, name))
            cur_s = s
        if e >= cur_e:
            cur_name, cur_e = name, e
    busy += cur_e - cur_s
    gaps.sort(reverse=True)
    top = "; ".join(f"{g / 1e3:.3f} ms after {a[:40]} before {b[:40]}"
                    for g, a, b in gaps[:n_gaps])
    print(f"device timeline {what}: wall {wall:.1f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / 1e3 / wall:.1f}%), "
          f"{len(events)} events, first at {events[0][1] / 1e3:.3f} ms, "
          f"last ends at {events[-1][2] / 1e3:.3f} ms; idle gaps "
          f"{sum(g for g, _, _ in gaps) / 1e3:.3f} ms in {len(gaps)}, "
          f"longest: {top}")


class GCWatch:
    """The collections of Python's cyclic garbage collector inside a with
    block, in any thread: count and host-clock ms by generation, and the
    objects it tracks at the end."""

    def __enter__(self):
        self.n, self.ms, self._t0 = [0, 0, 0], [0.0, 0.0, 0.0], None
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.n[g] += 1
            self.ms[g] += (time.perf_counter() - self._t0) * 1e3

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        self.tracked = len(gc.get_objects())

    def __str__(self):
        by_gen = ", ".join(f"{m:.1f}" for m in self.ms)
        return (f"gc: collections by generation {self.n}, "
                f"{sum(self.ms):.1f} ms ({by_gen}), {self.tracked} objects "
                f"tracked")


def profile_cc(pk, H: int, W: int, pke, He: int, We: int) -> dict:
    """The launches of one CC filter pass, the chain and the table on
    phase 11's pages, each with its device time; returns their counts."""
    p = PreprocParams()
    damt, sat, thr = p.despeckle_amt, p.sat_area_thresh, p.noise_area_thresh
    return {"cc_filter": launch_split("cc_filter", lambda: cc.cc_filter(
                pk, H, W, damt, cc.MODE_BLACK)),
            "cc_clean": launch_split("cc_clean", lambda: cc.cc_clean(
                pk, H, W, damt, sat)),
            "cc_table": launch_split("cc_table", lambda: cc.cc_table(
                pke, He, We, thr, dv.MAX_CCS))}


def phase_cc(dev, page, big_page):
    """Phase 11: the three CC kernels against their plain versions on the
    card and against the host oracle, on a batch folio's binarized page
    and on its rotated, eroded, separator-masked page; and on the phase-5
    folio, whose black runs overflow the run capacity: kernel and plain
    version report the same overflow and paint the same page."""
    p = PreprocParams()
    packed, (H, W) = binarize_pack(big_page.image)
    pk = torch.from_numpy(packed).to(dev)
    for mode in (cc.MODE_BLACK, cc.MODE_WHITE):
        got, ok = cc.cc_filter(pk, H, W, p.despeckle_amt, mode)
        ref, ok_ref = cc.filter_reference(pk, H, W, p.despeckle_amt, mode,
                                          False, cc.MAX_RUNS)
        check(torch.equal(got, ref) and torch.equal(ok, ok_ref),
              f"cc_filter mode {mode} differs from its plain version on an "
              f"overflowing page")
        print(f"cc_filter: phase-5 folio mode {mode}: ok {ok.tolist()} "
              f"(capacity {cc.MAX_RUNS}), equal to the plain version")
    packed, (H, W) = binarize_pack(page.image)
    binar = cc.unpack_page(packed, H, W)
    pk = torch.from_numpy(packed).to(dev)
    Wq = pk.shape[1]
    oracles = {cc.MODE_BLACK: lambda k: oracle.despeckle(binar, k),
               cc.MODE_WHITE: lambda k: ~oracle.despeckle(~binar, k),
               cc.MODE_TALL: lambda k: oracle.remove_tall_ccs(binar, k)}
    n_runs = {}
    for mode, want in oracles.items():
        for k in (1, 3, 25, 175):
            got, ok = cc.cc_filter(pk, H, W, k, mode)
            ref, ok_ref = cc.filter_reference(pk, H, W, k, mode, False,
                                              cc.MAX_RUNS)
            check(torch.equal(got, ref) and torch.equal(ok, ok_ref),
                  f"cc_filter mode {mode} k {k} differs from its plain "
                  f"version")
            check(int(ok[0]) == 1, f"cc_filter: the folio overflows "
                  f"{cc.MAX_RUNS} runs ({int(ok[1])})")
            check(np.array_equal(cc.unpack_page(got.cpu().numpy(), H, W),
                                 want(k)),
                  f"cc_filter mode {mode} k {k} differs from the oracle")
            n_runs[mode] = int(ok[1])
    print(f"cc_filter: {H} x {W} page (Wq={Wq}), black runs "
          f"{n_runs[cc.MODE_BLACK]}, white runs {n_runs[cc.MODE_WHITE]}; "
          f"3 modes x 4 thresholds identical to the plain version and the "
          f"oracle")
    damt, sat = p.despeckle_amt, p.sat_area_thresh
    f_ms = median_ms(lambda: cc.cc_filter(pk, H, W, damt, cc.MODE_BLACK))
    _, f_plain = timed_once(lambda: cc.filter_reference(
        pk, H, W, damt, cc.MODE_BLACK, False, cc.MAX_RUNS))

    got, ok = cc.cc_clean(pk, H, W, damt, sat)
    ref, ok_ref = cc.clean_reference(pk, H, W, damt, sat, False,
                                     cc.MAX_RUNS)
    want = oracle.remove_tall_ccs(
        ~oracle.despeckle(~oracle.despeckle(binar, damt), damt), sat)
    check(torch.equal(got, ref) and torch.equal(ok, ok_ref),
          "cc_clean differs from its plain version")
    check(int(ok[0]) == 1 and np.array_equal(
        cc.unpack_page(got.cpu().numpy(), H, W), want),
        "cc_clean differs from the oracle chain")
    c_ms = median_ms(lambda: cc.cc_clean(pk, H, W, damt, sat))
    _, c_plain = timed_once(lambda: cc.clean_reference(
        pk, H, W, damt, sat, False, cc.MAX_RUNS))

    er, pke, n_seps = masked_eroded(dev, pk, H, W)
    He, We = er.shape
    thr = p.noise_area_thresh
    tab, okt = cc.cc_table(pke, He, We, thr, dv.MAX_CCS)
    tab_ref, okt_ref = cc.table_reference(pke, He, We, thr,
                                          dv.MAX_CCS,
                                          cc.TABLE_MAX_RUNS)
    _, want_t = oracle.cc_stats(er.cpu().numpy())
    want_t = want_t[want_t[:, 4] > thr]
    count = int(okt[1])
    check(torch.equal(tab, tab_ref) and torch.equal(okt, okt_ref),
          "cc_table differs from its plain version")
    check(int(okt[0]) == 1 and count == len(want_t) and np.array_equal(
        tab[:count].cpu().numpy(), want_t), "cc_table differs from the "
          "oracle's cc_stats")
    t_ms = median_ms(lambda: cc.cc_table(pke, He, We, thr,
                                         dv.MAX_CCS))
    _, t_plain = timed_once(lambda: cc.table_reference(
        pke, He, We, thr, dv.MAX_CCS, cc.TABLE_MAX_RUNS))
    n_er = cc._runs(pke, He, We, False, cc.TABLE_MAX_RUNS)[3]
    print(f"cc_clean: chain despeckle {damt} / white {damt} / tall {sat} "
          f"identical to the plain version and the oracle; kernel "
          f"{c_ms:.3f} ms plain {c_plain:.3f} ms")
    print(f"cc_table: eroded page {He} x {We} with {n_seps} "
          f"separators, {n_er} runs, {count} components of area > {thr}, "
          f"identical to the plain version and the oracle; kernel "
          f"{t_ms:.3f} ms plain {t_plain:.3f} ms")
    print(f"cc_filter: despeckle {damt} kernel {f_ms:.3f} ms plain "
          f"{f_plain:.3f} ms")
    page_bytes = 4 * H * Wq
    return {
        "cc_filter": {"max_abs_err": 0.0, "ms": f_ms, "plain_ms": f_plain,
                      **bound(2 * page_bytes + 8,
                              cc_ops(H, Wq, n_runs[cc.MODE_BLACK])),
                      "library_ms": None},
        "cc_clean": {"max_abs_err": 0.0, "ms": c_ms, "plain_ms": c_plain,
                     **bound(2 * page_bytes + 4,
                             3 * cc_ops(H, Wq, n_runs[cc.MODE_BLACK])),
                     "library_ms": None},
        "cc_table": {"max_abs_err": 0.0, "ms": t_ms, "plain_ms": t_plain,
                     **bound(4 * pke.numel() + 20 * dv.MAX_CCS
                             + 8, cc_ops(He, pke.shape[1], n_er)),
                     "library_ms": None},
    }


def phase_skew(dev, page):
    """Phase 12: the skew search on the card against the host oracle on
    the folio and on two rotated copies."""
    packed, (H, W) = binarize_pack(page.image)
    binar = cc.unpack_page(packed, H, W)
    line = []
    for angle in (None, 1.37, -2.6):
        img = oracle.rotate_onebit(binar, angle) if angle else binar
        got = dv.rotation_angle_projections(img, device=dev)
        want = oracle.rotation_angle_projections(img, -6, 6)
        check(got == want, f"skew search on the card {got} != oracle {want}")
        t = torch.from_numpy(img).to(dev)
        ms = median_ms(lambda: sd.search(t))
        line.append(f"{img.shape[0]}x{img.shape[1]} angle {got} "
                    f"{ms:.3f} ms")
    print("skew search on the card, equal to the oracle: " + "; ".join(line))


def batch_json(results):
    return [None if r is None else json.dumps(r.json_dict, sort_keys=True)
            for r in results]


def per_folio(timer, n):
    return {k: round(v * 1e3 / n, 3) for k, v in timer.totals.items()}


def phase_batch(path, dev):
    """Phase 13: process_batch on N_FOLIOS full-size folios on the card,
    with backend="device" and "hybrid" (both rastering on the card),
    against the sequential process(). Returns the launches of the hybrid
    run, the pages, their JSON and each backend's ms a folio."""
    pages = [make_batch_folio(3000 + k) for k in range(N_FOLIOS)]
    folios = [(pg.image, pg.transcript) for pg in pages]
    seq, seq_timer = [], stage_timer(enabled=True)
    run_process(pages[0], path)  # warm-up
    t0 = time.perf_counter()
    for pg in pages:
        out = run_process(pg, path, seq_timer)
        seq.append(None if out is None else json.dumps(
            to_JSON_dict(out[0], out[2]), sort_keys=True))
    seq_ms = (time.perf_counter() - t0) * 1e3 / N_FOLIOS
    check(any(j is not None for j in seq), "no folio produced OCR")
    rec = _resolve_recognizer(path, "hybrid", dev)
    batch_ms = {}
    for backend in ("device", "hybrid"):
        process_batch(folios[:2], rec, backend=backend, device=dev)
        timer = stage_timer(enabled=True)
        _kernels.reset_launches()
        with GCWatch() as gcw:
            res, ms = wall_ms(lambda: process_batch(
                folios, rec, backend=backend, timer=timer, device=dev))
        launches = dict(_kernels.launches)
        batch_ms[backend] = ms / N_FOLIOS
        same = batch_json(res) == seq
        print(f"batch {backend}: {N_FOLIOS} folios {ms / N_FOLIOS:.1f} ms "
              f"per folio, stages ms per folio {per_folio(timer, N_FOLIOS)};"
              f" sequential process() {seq_ms:.1f} ms per folio, stages "
              f"{per_folio(seq_timer, N_FOLIOS)}; JSON identical {same}; "
              f"launches {launches}; {gcw}")
        check(same, f"process_batch(backend={backend!r}) differs from the "
              f"sequential process()")
        for name in ("cc_clean", "cc_table", "raster_rotate_erode"):
            check(launches[name] >= N_FOLIOS,
                  f"{name} launched {launches[name]} times")
    idle_gaps("batch hybrid", lambda: process_batch(
        folios, rec, backend="hybrid", device=dev))
    return launches, pages, seq, batch_ms


def full_inputs(packed_meta, dev):
    """The full chain's inputs for a packed strip batch on the card, as
    normalize_batch_device builds them: the ink mask, the v-gauss bank,
    the h-gauss taps, (h, w), the smoothing taps; and the float ink image
    the default route's products take."""
    grey, hs, ws = _unpack_bits(torch.from_numpy(packed_meta).to(dev))
    Hp = grey.shape[1]
    _, _, _, temp_f = tle._front(grey, hs, ws, True)
    return ((temp_f != 0).to(torch.uint8), tle.vgauss_bank(hs, Hp).contiguous(),
            tle.hgauss_taps(hs, Hp).contiguous(), hs, ws,
            tle._smoothing_taps_on(hs, Hp)), temp_f


def gate_strips():
    """>= 64 strips of nine 1600 x 1300 pages, seeds 30-38: the recipe of
    the JAX package's full-chain gate (tests/test_tpu_hw.py:338-376)."""
    strips = []
    for i in range(9):
        pg = make_page(np.random.default_rng(30 + i), n_lines=8,
                       words_per_line=3, H=1600, W=1300, speckles=30,
                       angle=0.4)
        image, eroded, _ = preprocess_images(pg.image, backend="hybrid")
        ls, _, _ = identify_text_lines(image, eroded, backend="hybrid",
                                       verbose=False)
        strips.extend(np.asarray(s.img) for s in ls)
    check(len(strips) >= 64, f"only {len(strips)} gate strips")
    return strips


def full_work(temp, w0, k1, hs, ws, k2):
    """The operations and bytes the full chain needs on these strips. The
    tail reads sm only inside each strip's (h, w) (rows >= h and columns
    >= w are masked out, the smoothing reflects inside [0, w)), so per
    strip: the v-gauss over the nonzero weights of w0[:h, :h] and the
    h-gauss over the nonzero taps, for h x w outputs each; the tail's means
    and argmax over h x w and its smoothing over w columns. Bytes: the ink
    mask and the v-gauss weights inside (h, w), the taps, (h, w), and the
    outputs."""
    w0, k1, k2 = w0.cpu(), k1.cpu(), k2.cpu()
    ops = nbytes = 0
    for b, (h, w) in enumerate(zip(hs.tolist(), ws.tolist())):
        ops += (2 * h * w * int((k1[b] != 0).sum())
                + 2 * w * int((w0[b, :h, :h] != 0).sum())
                + 4 * h * w + 2 * w * int((k2[b] != 0).sum()))
        nbytes += h * w + 4 * h * h
    B, Wp = temp.shape[0], temp.shape[2]
    nbytes += (4 * k1.numel() + 8 * k2.numel() + 8 * B  # taps, hs and ws
               + 4 * B * Wp + 8 * B)                    # center, dsum, dcnt
    return ops, nbytes


def phase_full(rec, fi, strips, dev):
    """Phase 14: lineest_full against its plain version, bit for bit, on
    the folio's strips and on the gate strips; its time beside the default
    chain's on the folio's strips."""
    packed_gate = rec._pack_strips(strips)[0]
    for name, meta in (("folio", fi["packed_meta"]), ("gate", packed_gate)):
        args, _ = full_inputs(meta, dev)
        got = center_full_cuda(*args)
        ref = center_full_reference(*args)
        torch.cuda.synchronize()
        same = [torch.equal(g, r) for g, r in zip(got, ref)]
        B, Hp, Wp = args[0].shape
        print(f"lineest_full: {name} strips B={B} Hp={Hp} Wp={Wp} "
              f"K1={args[2].shape[1]}: center, dsum, dcnt identical to the "
              f"plain version {same}")
        check(all(same), f"lineest_full differs from its plain version on "
              f"the {name} strips")

    args, temp_f = full_inputs(fi["packed_meta"], dev)
    temp, w0, k1, hs, ws, k2 = args
    ms = median_ms(lambda: center_full_cuda(*args))
    chain_ms = median_ms(lambda: tail_cuda(
        tle._conv_rows_banded(torch.bmm(w0, temp_f), k1).contiguous(), temp,
        hs, ws, k2))
    plain_ms = median_ms(lambda: center_full_reference(*args))
    B, Hp, Wp = temp.shape
    K1 = k1.shape[1]
    ops, nbytes = full_work(*args)
    b = bound(nbytes, ops)
    print(f"lineest_full: folio B={B} Hp={Hp} Wp={Wp} K1={K1} kernel "
          f"{ms:.3f} ms, default chain (cuBLAS v-gauss + banded h-gauss + "
          f"lineest_tail) {chain_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({ops} operations, "
          f"{nbytes} bytes)")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def phase_full_gate(params_np, codec, strips, dev):
    """Phase 15: the reference's gate for the full chain: the recognizer's
    wire rows with TEXT_ALIGNMENT_TPU_TAIL=full against the default."""
    rec = SeqRecognizer(tl.params_from_np(params_np), codec,
                        normalize_on_device=True, device=dev)
    packed_meta, _, ws, Wp = rec._pack_strips(strips)
    t_max = rec._initial_t_max(Wp, ws[:len(strips)])
    rows = {}
    env = os.environ.get("TEXT_ALIGNMENT_TPU_TAIL")
    try:
        for mode in ("default", "full"):
            if mode == "full":
                os.environ["TEXT_ALIGNMENT_TPU_TAIL"] = "full"
            else:
                os.environ.pop("TEXT_ALIGNMENT_TPU_TAIL", None)
            before = _kernels.launches["lineest_full"]
            rows[mode] = rec._dispatch_device(packed_meta, t_max, 128)
            used = _kernels.launches["lineest_full"] - before
            check(used >= 1 if mode == "full" else used == 0,
                  f"the {mode} route launched lineest_full {used} times")
    finally:
        restore_env("TEXT_ALIGNMENT_TPU_TAIL", env)
    wa, wb = rows["default"], rows["full"]
    n = len(strips)
    R = (wa.shape[1] - 3) // 2
    same_cls = all(wa[b, 0] == wb[b, 0] and np.array_equal(
        wa[b, 3 + R:3 + R + wa[b, 0]], wb[b, 3 + R:3 + R + wb[b, 0]])
        for b in range(n))
    n_same = sum(bool(np.array_equal(wa[b], wb[b])) for b in range(n))
    print(f"full-chain gate: {n} strips (B={packed_meta.shape[0]}, Wp={Wp}, "
          f"t_max={t_max}), decoded chars {int(wa[:n, 0].sum())}; counts "
          f"and classes identical on every strip {same_cls}; wire rows "
          f"byte-identical {n_same}/{n}")
    check(same_cls, "the full chain changes decoded counts or classes")
    check(n_same >= 0.95 * n, f"only {n_same}/{n} wire rows identical")


def restore_env(name, value):
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def phase_serve(pages, path, dev, workdir):
    """Phase 16: serve(do_warmup=True) drains 8 job files with
    TEXT_ALIGNMENT_TPU_TAIL=full, one job at a time and with batch=8; the
    outputs against process()'s JSON under the same setting. The launch
    counts, the calls of each route and the ms per job cover the drain
    after the warm-up. Returns
    the lineest_full launches of the one-at-a-time run."""
    from PIL import Image

    from text_alignment_tpu_torch import serve as serve_mod
    from text_alignment_tpu_torch.parallel import batch as batch_mod

    warm = {}
    # calls and wall ms of the drain's routes: process_job (one job at a
    # time, and the batched path's retry after a process_batch exception),
    # process_batch, and _parse_job (the batched path's job and PNG reads)
    calls = {}
    real = {"warmup": serve_mod.warmup, "process_job": serve_mod.process_job,
            "_parse_job": serve_mod._parse_job,
            "process_batch": batch_mod.process_batch}

    def timed_warmup(*args, **kwargs):
        t0 = time.perf_counter()
        real["warmup"](*args, **kwargs)
        torch.cuda.synchronize()
        warm["ms"] = (time.perf_counter() - t0) * 1e3
        _kernels.reset_launches()  # count the drain only
        calls.clear()

    def counted(name):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                n, ms = calls.get(name, (0, 0.0))
                calls[name] = (n + 1,
                               ms + (time.perf_counter() - t0) * 1e3)
        return wrapper

    env = os.environ.get("TEXT_ALIGNMENT_TPU_TAIL")
    os.environ["TEXT_ALIGNMENT_TPU_TAIL"] = "full"
    serve_mod.warmup = timed_warmup
    for name in ("process_job", "_parse_job"):
        setattr(serve_mod, name, counted(name))
    batch_mod.process_batch = counted("process_batch")
    try:
        want = []
        for pg in pages:
            out = run_process(pg, path)
            check(out is not None, "process() returned None on a job folio")
            want.append(json.dumps(to_JSON_dict(out[0], out[2])))
        launches = None
        for batch in (1, 8):
            spool = os.path.join(workdir, f"spool{batch}")
            os.makedirs(spool)
            for k, pg in enumerate(pages):
                Image.fromarray(pg.image).save(
                    os.path.join(spool, f"folio{k}.png"))
                with open(os.path.join(spool, f"folio{k}.job.json"), "w") as f:
                    json.dump({"image": f"folio{k}.png",
                               "transcript": pg.transcript}, f)
            stats, ms = wall_ms(lambda: serve(
                spool, path, backend="hybrid", once=True, batch=batch,
                do_warmup=True, device=dev))
            run_launches, run_calls = dict(_kernels.launches), dict(calls)
            got = []
            for k in range(len(pages)):
                with open(os.path.join(spool, f"folio{k}.json")) as f:
                    got.append(f.read())
            same = sum(g == w for g, w in zip(got, want))
            drain = ms - warm["ms"]
            n_calls = {name: n for name, (n, _) in run_calls.items()}
            split = {name: round(t / len(pages), 1)
                     for name, (_, t) in run_calls.items()}
            print(f"serve batch={batch}: {stats.processed} processed, "
                  f"{stats.failed} failed; warm-up {warm['ms']:.1f} ms, then "
                  f"{drain / len(pages):.1f} ms per job (wall of serve less its "
                  f"warm-up: the model load, claims, PNG reads, the "
                  f"pipeline, JSON and receipts), of which ms per job in "
                  f"{split}; calls {n_calls}; "
                  f"outputs identical to process() {same}/{len(pages)}; "
                  f"launches in the drain {run_launches}")
            check(stats.failed == 0 and stats.processed == len(pages),
                  f"serve batch={batch}: {stats.failed} job(s) failed")
            check(same == len(pages), f"serve batch={batch}: outputs differ "
                  f"from process()")
            # the drain took the route asked for: one job at a time, or one
            # process_batch over the sweep and no one-job retry after it
            n_job = run_calls.get("process_job", (0, 0.0))[0]
            n_batch = run_calls.get("process_batch", (0, 0.0))[0]
            want_calls = (len(pages), 0) if batch == 1 else (0, 1)
            check((n_job, n_batch) == want_calls,
                  f"serve batch={batch}: process_job called {n_job} times "
                  f"and process_batch {n_batch} times, not {want_calls}")
            check(run_launches["lineest_full"] >= (len(pages) if batch == 1
                                                   else 1),
                  f"serve batch={batch} launched lineest_full "
                  f"{run_launches['lineest_full']} times")
            if batch == 1:
                launches = run_launches
        # the drain's costs outside serve, on the same files: PNG reads,
        # the model load, and process_batch once more on the same folios
        t0 = time.perf_counter()
        images = [np.asarray(Image.open(os.path.join(spool, f"folio{k}.png")))
                  for k in range(len(pages))]
        png_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
        rec, load_ms = wall_ms(lambda: _resolve_recognizer(path, "hybrid",
                                                           dev))
        folios = [(im, pg.transcript) for im, pg in zip(images, pages)]
        _, again_ms = wall_ms(lambda: real["process_batch"](
            folios, rec, backend="hybrid", device=dev))
        print(f"serve: PNG read {png_ms:.1f} ms per job, model load "
              f"{load_ms:.1f} ms per serve call; process_batch again on the "
              f"same {len(pages)} folios {again_ms / len(pages):.1f} ms per "
              f"folio")
    finally:
        for name in ("warmup", "process_job", "_parse_job"):
            setattr(serve_mod, name, real[name])
        batch_mod.process_batch = real["process_batch"]
        restore_env("TEXT_ALIGNMENT_TPU_TAIL", env)
    return launches


def profile_only(dev) -> int:
    """``--profile``: the device time of each launch of the CC kernels
    (phase 11's pages) and of the full chain (phase 14's folio strips), and
    the device timeline of one process_batch(backend="hybrid") call (phase
    13's folios), with no other phase before them. Runs against any tree whose
    package has the same entry points."""
    big = make_batch_folio(3000)
    packed, (H, W) = binarize_pack(big.image)
    pk = torch.from_numpy(packed).to(dev)
    er, pke, _ = masked_eroded(dev, pk, H, W)
    launches = profile_cc(pk, H, W, pke, *er.shape)

    page = make_folio()
    image, eroded, _ = preprocess_images(page.image, backend="hybrid")
    strips, _, _ = identify_text_lines(image, eroded, backend="hybrid")
    codec = Codec()
    params_np = peaky_params(0, len(codec))
    rec = SeqRecognizer(tl.params_from_np(params_np), codec,
                        normalize_on_device=True, device=dev)
    fi = folio_inputs(rec, [s.img for s in strips], dev)
    launches["lineest_tail"] = launch_split("lineest_tail", lambda: tail_cuda(
        fi["sm"], fi["temp"], fi["hs"], fi["ws"], fi["k2"]))
    args, _ = full_inputs(fi["packed_meta"], dev)
    launches["lineest_full"] = launch_split(
        "lineest_full", lambda: center_full_cuda(*args))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "folio.pyrnn.gz")
        save_pyrnn(path, params_np, codec)
        folios = [(pg.image, pg.transcript) for pg in
                  (make_batch_folio(3000 + k) for k in range(N_FOLIOS))]
        brec = _resolve_recognizer(path, "hybrid", dev)
        process_batch(folios[:2], brec, backend="hybrid", device=dev)
        with GCWatch() as gcw:
            _, ms = wall_ms(lambda: process_batch(
                folios, brec, backend="hybrid", device=dev))
        print(f"batch hybrid alone: {ms / N_FOLIOS:.1f} ms per folio; {gcw}")
        idle_gaps("batch hybrid alone", lambda: process_batch(
            folios, brec, backend="hybrid", device=dev))
    print(json.dumps({"profile_launches": launches}))
    return 0


def phase_profile():
    """Phase 17: ``--profile`` in a child process (in this process, after
    earlier profiler windows, the profiler lost whole windows of events):
    its lines, and at most CC_PASS_LAUNCHES launches a CC pass and table,
    3 CC_PASS_LAUNCHES + 1 for the chain, TAIL_LAUNCHES for the tail,
    FULL_LAUNCHES for the full chain (a lost event can only lower a
    count)."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile"],
        capture_output=True, text=True, timeout=400,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = child.stdout.splitlines()
    for line in lines:
        if line.startswith(("launch split", "device timeline",
                            "batch hybrid")):
            print(f"profile: {line}")
    check(child.returncode == 0 and lines and
          lines[-1].startswith('{"profile_launches"'),
          f"chip_smoke.py --profile failed ({child.returncode}): "
          f"{child.stderr[-2000:]}")
    n = json.loads(lines[-1])["profile_launches"]
    check(n["cc_filter"] <= CC_PASS_LAUNCHES
          and n["cc_table"] <= CC_PASS_LAUNCHES
          and n["cc_clean"] <= 3 * CC_PASS_LAUNCHES + 1
          and 1 <= n["lineest_tail"] <= TAIL_LAUNCHES
          and 1 <= n["lineest_full"] <= FULL_LAUNCHES,
          f"launches over the limits: {n}")
    print(f"profile: launches a call {n} (limits: {CC_PASS_LAUNCHES} a CC "
          f"pass and table, {3 * CC_PASS_LAUNCHES + 1} the chain, "
          f"{TAIL_LAUNCHES} the tail, {FULL_LAUNCHES} the full chain)")


# phase 18's corpus: tests/test_train_quality.py's pages (the JAX package's
# training recipe), two training pages and a held-out one
TRAIN_PAGE_KW = dict(
    n_lines=6, words_per_line=2, H=1100, W=640, char_h=60, char_w=34,
    gap=7, space_w=46, line_spacing=160, margin_x=30, glyphs="char",
    vocabulary=("deus", "in", "ave"))
TRAIN_SEEDS, HELDOUT_SEED = (200, 201), 990
TRAIN_LR, TRAIN_MAX_STEPS, TRAIN_STOP = 5e-3, 700, 0.08
ACC_BAR = 0.85
STEP_B = 16        # the batch of the step timing
RESUME_K = 5       # phase 18 (c): save at step k, compare at 2k


def strip_text(strip, page, with_positions=False):
    """Ground truth of a line strip from the page's char boxes (a space
    where the gap is wider than a glyph gap) and, with
    ``with_positions``, each char's right edge in strip-local x."""
    y0, y1 = strip.offset_y, strip.offset_y + strip.img.shape[0]
    chs = sorted((cb for cb in page.char_boxes
                  if y0 <= (cb.ul[1] + cb.lr[1]) // 2 < y1),
                 key=lambda b: b.ul[0])
    out, rights = [], []
    for a, b in zip([None] + chs[:-1], chs):
        if a is not None and b.ul[0] - a.lr[0] > TRAIN_PAGE_KW["gap"] + 2:
            out.append(" ")
        out.append(b.char)
        rights.append(b.lr[0] - strip.offset_x)
    return ("".join(out), rights) if with_positions else "".join(out)


def train_strips(seed):
    page = make_page(np.random.default_rng(seed), speckles=0, angle=0.0,
                     **TRAIN_PAGE_KW)
    image, eroded, _ = preprocess_images(page.image, backend="hybrid")
    strips, _, _ = identify_text_lines(image, eroded, backend="hybrid")
    return page, strips


def char_accuracy(pred: str, truth: str) -> float:
    """1 - edit distance / len(truth), clamped at 0."""
    n, m = len(pred), len(truth)
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (pred[i - 1] != truth[j - 1]))
        prev = cur
    return max(0.0, 1.0 - prev[m] / max(1, m))


def train_corpus(codec):
    """The training batch of the corpus (every line, host-normalized as
    the CLI's train normalizes), T rounded up to 128 frames."""
    frames, texts = [], []
    for seed in TRAIN_SEEDS:
        page, strips = train_strips(seed)
        for s in strips:
            t = strip_text(s, page)
            norm = normalize_strip(s.img) if t else None
            if norm is not None:
                frames.append(norm[0])
                texts.append(t)
    check(len(frames) >= 10, f"corpus of {len(frames)} lines only")
    T = -(-max(f.shape[0] for f in frames) // 128) * 128
    S = max(len(t) for t in texts) + 8
    return frames, texts, T, S


def step_grads(tr, batch):
    """The loss and each weight's gradient of one batch (no update)."""
    args = tr.tensors(*batch)
    tr.optimizer.zero_grad(set_to_none=True)
    loss = tr.loss(*args)
    loss.backward()
    return float(loss.detach()), [p.grad.detach().cpu()
                                  for p in tr.model.parameters()]


def train_step_split(tr, batch, n: int = 20):
    """Median ms of the step's forward (the loss), backward and optimizer
    (clipping and Adam) over ``n`` steps after 3 warm-up steps, each part
    ended by a synchronize."""
    args = tr.tensors(*batch)
    parts = {"forward": [], "backward": [], "optimizer": [], "step": []}
    for i in range(n + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.optimizer.zero_grad(set_to_none=True)
        loss = tr.loss(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        clip_by_global_norm([p.grad for p in tr.model.parameters()],
                            tr.clip_norm)
        tr.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i >= 3:
            for k, a, b in (("forward", t0, t1), ("backward", t1, t2),
                            ("optimizer", t2, t3), ("step", t0, t3)):
                parts[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items()}


def train_busy(tr, batch, n: int = 5):
    """torch.profiler over ``n`` steps: device-busy ms (CUDA kernels' self
    time), wall ms and the kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    tr.step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tr.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return busy, wall, sum(e.count for e in kernels)


def heldout_decode(params, codec, dev):
    """The held-out page decoded by SeqRecognizer on ``dev`` with the
    device normalizer (process()'s setting for backend="hybrid" on the
    card): per line (decoded text, truth), the lstm_scan and lineest_tail
    launches, and the mean |x - right edge| over exactly decoded lines."""
    page, strips = train_strips(HELDOUT_SEED)
    rec = SeqRecognizer(params, codec, normalize_on_device=True,
                        decode="bestpath", device=dev)
    _kernels.reset_launches()
    rows = rec.recognize_batch([s.img for s in strips])
    launches = {k: _kernels.launches[k] for k in OCR_KERNELS}
    out, errs = [], []
    for s, r in zip(strips, rows):
        truth, rights = strip_text(s, page, with_positions=True)
        text = "".join(c for c, _ in r)
        out.append((text, truth))
        xs = [x for c, x in r if c != " "]
        if truth and text.replace(" ", "") == truth.replace(" ", ""):
            errs.extend(abs(x - e) for x, e in zip(xs, rights))
    return out, launches, (float(np.mean(errs)) if errs else None)


def phase_train(dev):
    """Phase 18: training on the card (the port's models/train.py)."""
    codec = Codec()
    frames, texts, T, S = train_corpus(codec)
    batch = batch_lines(frames, texts, codec, T, S)
    print(f"train corpus: {len(frames)} lines, T = {T}, S = {S}, "
          f"ni = {NI}, ns = {NS}, nout = {len(codec)}")

    # (a) one step from the same weights and batch, card against CPU
    cpu = Trainer(codec, lr=TRAIN_LR, seed=1, device="cpu")
    card = Trainer(codec, lr=TRAIN_LR, seed=1, device=dev)
    loss_c, g_c = step_grads(cpu, batch)
    loss_g, g_g = step_grads(card, batch)
    norm = float(torch.sqrt(sum((g * g).sum() for g in g_c)))
    gerr = max(float((a - b).abs().max()) for a, b in zip(g_c, g_g))
    step_c, step_g = cpu.step(*batch), card.step(*batch)
    perr = max(float((a - b.cpu()).abs().max()) for a, b in
               zip(tl.params_leaves(cpu.params), tl.params_leaves(card.params)))
    print(f"train (a): loss card {loss_g!r} cpu {loss_c!r} (rel "
          f"{abs(loss_g - loss_c) / abs(loss_c):.3e}); gradients max |diff| "
          f"{gerr:.3e} = {gerr / norm:.3e} x global norm {norm:.4f}; after "
          f"the step loss {step_g!r} / {step_c!r}, weights max |diff| "
          f"{perr:.3e}")
    check(abs(loss_g - loss_c) <= 1e-5 * abs(loss_c),
          f"train (a): card loss {loss_g} vs CPU {loss_c}")
    check(gerr <= 1e-4 * norm, f"train (a): gradients differ by {gerr} "
          f"(global norm {norm})")

    # (b) the test's recipe on the card
    tr = Trainer(codec, lr=TRAIN_LR, seed=1, device=dev)
    t0 = time.perf_counter()
    loss = float("inf")
    while tr.iteration < TRAIN_MAX_STEPS and not loss < TRAIN_STOP:
        loss = tr.step(*batch)
    wall = time.perf_counter() - t0
    print(f"train (b): {tr.iteration} steps to loss {loss:.4f} in "
          f"{wall:.1f} s wall ({wall / tr.iteration * 1e3:.1f} ms a step, "
          f"B = {len(frames)}, T = {T})")
    rows, launches, err = heldout_decode(tr.params, codec, dev)
    rows_cpu, _, _ = heldout_decode(tr.params, codec, "cpu")
    accs = [char_accuracy(p, t) for p, t in rows if t]
    acc = float(np.mean(accs))
    same = sum(a == b for a, b in zip(rows, rows_cpu))
    err_txt = "no exactly decoded line" if err is None else (
        f"{err:.1f} px ({err / TRAIN_PAGE_KW['char_w']:.2f} char widths; "
        f"the test's bound 2.5)")
    print(f"train (b): held-out accuracy {acc:.4f} over {len(accs)} lines "
          f"(bar {ACC_BAR}), launches {launches}, CPU decode identical on "
          f"{same}/{len(rows)} lines, mean position error {err_txt}")
    check(acc >= ACC_BAR, f"train (b): held-out accuracy {acc} < {ACC_BAR}")
    check(all(n >= 1 for n in launches.values()),
          f"train (b): the decode launched {launches}")
    check(same == len(rows), f"train (b): CPU decode differs: {rows_cpu} "
          f"vs {rows}")

    # (c) save_state at k, load_state, continue to 2k: bit-identical
    with tempfile.TemporaryDirectory() as tmp:
        straight = Trainer(codec, lr=TRAIN_LR, seed=1, device=dev)
        for _ in range(2 * RESUME_K):
            straight.step(*batch)
        first = Trainer(codec, lr=TRAIN_LR, seed=1, device=dev)
        for _ in range(RESUME_K):
            first.step(*batch)
        path = first.save_state(os.path.join(tmp, "t.state"))
        resumed = Trainer.load_state(path, device=dev)
        for _ in range(RESUME_K):
            resumed.step(*batch)
    same = all(torch.equal(a, b) for a, b in zip(
        tl.params_leaves(straight.params), tl.params_leaves(resumed.params)))
    print(f"train (c): resumed at {RESUME_K}, weights at {2 * RESUME_K} "
          f"bit-identical to the uninterrupted run: {same}")
    check(same, "train (c): resume is not bit-exact on the card")

    # (d) ms a step at B = 16 (the corpus's lines repeated), its split, and
    # the device-busy share of 5 steps
    pick = [k % len(frames) for k in range(STEP_B)]
    batch16 = batch_lines([frames[k] for k in pick], [texts[k] for k in pick],
                          codec, T, S)
    timed = Trainer(codec, lr=TRAIN_LR, seed=1, device=dev)
    split = train_step_split(timed, batch16)
    busy, wall_ms, n_kernels = train_busy(timed, batch16)
    print(f"train (d): B = {STEP_B}, T = {T}: ms a step (median of 20) "
          f"{split['step']:.2f} = forward {split['forward']:.2f} + backward "
          f"{split['backward']:.2f} + optimizer {split['optimizer']:.2f}; "
          f"5 steps under torch.profiler: device busy {busy:.2f} of "
          f"{wall_ms:.2f} ms wall ({busy / wall_ms:.3f}), "
          f"{n_kernels / 5:.0f} kernels a step")


MESH_WORLD = 2          # phase 19 (b): gloo ranks sharing the card
MESH_DEADLINE_S = 300   # phase 19 (b), the ranks' start to their end
MESH_KERNELS = ("lstm_scan", "lineest_tail", "nw_fill_batched",
                "nw_traceback")
MESH_GRID_CALLS = 3     # timed calls of each grid, sharded and unsharded


def uncounted(fn):
    """fn(), its kernel launches taken back out of the counts."""
    before = dict(_kernels.launches)
    out = fn()
    _kernels.launches.update(before)
    return out


def ms_list(ms) -> str:
    return "/".join(f"{m:.1f}" for m in ms)


def grid_text(out) -> str:
    """Phase 19's grid times of one rank: each timed call of the sharded
    and the unsharded grid, and the sharded grid's split."""
    return "; ".join(
        f"{name} grid sharded {ms_list(out[f'grid_{name}_ms'])} ms, "
        f"unsharded {ms_list(out[f'grid_{name}_one_ms'])} ms, sharded "
        f"split: {split_text(out[f'grid_{name}_split'])}"
        for name in ("chant", "2400"))


def digest(value) -> str:
    """sha256 of a JSON-able value's canonical JSON (alignments, JSON)."""
    return hashlib.sha256(json.dumps(value).encode()).hexdigest()


def mesh_pairs(page):
    """Phase 9's two grid pairs: the folio's chant pair and 2400^2."""
    return {"chant": chant_pair(page),
            "2400": seeded_pair(2400, 2400, 2400)}


def mesh_work(mesh, path, dev, folios, pairs, recipe_batch):
    """Phase 19's work in one rank of ``mesh``: process_batch on the
    folios (one folio's warm-up, then all, timed; every pair through the
    sharded NW buckets), the 729-row grid on both pairs, the demo train
    step on data_model_mesh(world) and one Trainer-recipe step on the
    phase-18 corpus. Returns the JSON, the grids' digests, the ms, the work
    shares, this rank's launches and the losses."""
    import torch.distributed as dist

    from text_alignment_tpu_torch.parallel import (
        data_model_mesh, infer_dp, make_sharded_train_step,
        sharded_train_demo_step)
    from text_alignment_tpu_torch.parallel.multihost import (
        assert_same_across_processes)
    from text_alignment_tpu_torch.parallel.train_dp import trainer_recipe

    rec = _resolve_recognizer(path, "hybrid", dev)
    grid = scoring_grid()
    kw = dict(backend="hybrid", mesh=mesh, min_align_device_cells=0)
    process_batch(folios[:1], rec, **kw)  # warm-up
    for t, o in pairs.values():  # warm-up at the grids' full launch shapes
        align_grid(t, o, grid, mesh=mesh)
        align_grid(t, o, grid, device=dev)
    _kernels.reset_launches()
    res, ms = wall_ms(lambda: process_batch(folios, rec, **kw))
    out = {"json": batch_json(res), "batch_ms": ms / len(folios),
           "shares": dict(infer_dp.LAST_WORK_SHARES)}
    for name, (t, o) in pairs.items():
        # sharded and unsharded calls alternate; the unsharded ones' and
        # the split's launches are taken back out of the counts
        sharded, one = [], []
        for _ in range(MESH_GRID_CALLS):
            got, ms = wall_ms(lambda: align_grid(t, o, grid, mesh=mesh))
            sharded.append(ms)
            one.append(uncounted(lambda: wall_ms(
                lambda: align_grid(t, o, grid, device=dev)))[1])
        out[f"grid_{name}"] = digest(got)
        out[f"grid_{name}_ms"], out[f"grid_{name}_one_ms"] = sharded, one
        out[f"grid_{name}_split"] = uncounted(
            lambda: grid_split(t, o, grid, dev, mesh))
    out["launches"] = {k: _kernels.launches[k] for k in MESH_KERNELS}
    assert_same_across_processes("phase 19 results", [
        out["json"], out["grid_chant"], out["grid_2400"]])
    mesh2 = data_model_mesh(dist.get_world_size())
    out["demo_loss"] = sharded_train_demo_step(mesh2)
    tr = Trainer(Codec(), lr=TRAIN_LR, seed=1, device=dev)
    opt = trainer_recipe(tr)
    step, shard_params, shard_batch = make_sharded_train_step(mesh2, opt)
    sp = shard_params(tr.params)
    _, _, out["recipe_loss"] = step(sp, opt.init(sp),
                                    *shard_batch(*recipe_batch))
    return out


def _mesh_rank(workdir, path):
    """Phase 19 (b): one of MESH_WORLD gloo ranks sharing the card; writes
    ``rank<r>.json`` into ``workdir``."""
    import torch.distributed as dist

    from text_alignment_tpu_torch.parallel import make_mesh
    from text_alignment_tpu_torch.parallel.multihost import (
        gather_shares, rank_device)

    dev = rank_device()
    pages = [make_batch_folio(3000 + k) for k in range(N_FOLIOS)]
    with np.load(os.path.join(workdir, "recipe.npz")) as z:
        batch = tuple(z[k] for k in ("xs", "xlens", "labels", "llens"))
    out = mesh_work(make_mesh(dist.get_world_size()), path, dev,
                    [(pg.image, pg.transcript) for pg in pages],
                    mesh_pairs(make_folio()), batch)
    out.update(backend=dist.get_backend(), device=str(dev))
    out["all_launches"] = gather_shares({f"rank{dist.get_rank()}":
                                         out["launches"]})
    with open(os.path.join(workdir, f"rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(out, f)


def phase_mesh(dev, card, path, page, pages, seq, batch_ms, grids,
               workdir):
    """Phase 19: the mesh on the card. (a) One NCCL rank in this process:
    phase 13's folios through process_batch(mesh=make_mesh(1)), JSON
    byte-identical to phase 13's, and both 729-row grids equal to phase
    9's. (b) MESH_WORLD gloo ranks sharing cuda:0 (NCCL refuses two ranks
    on one card), spawned with a deadline: the same bytes in every rank,
    one equal work share a rank, each rank's launches of the four kernels
    on the path >= 1. In both, the demo step on data_model_mesh(world) and
    a Trainer-recipe step on the phase-18 corpus match the one-process
    step to 1e-5 relative."""
    import torch.distributed as dist

    from text_alignment_tpu_torch.parallel import make_mesh
    from text_alignment_tpu_torch.parallel import multihost

    folios = [(pg.image, pg.transcript) for pg in pages]
    pairs = mesh_pairs(page)
    want = {name: digest(grids[name]) for name in pairs}
    codec = Codec()
    frames, texts, T, S = train_corpus(codec)
    batch = batch_lines(frames, texts, codec, T, S)
    np.savez(os.path.join(workdir, "recipe.npz"),
             **dict(zip(("xs", "xlens", "labels", "llens"), batch)))
    one = Trainer(codec, lr=TRAIN_LR, seed=1, device=dev).step(*batch)

    def check_run(tag, out, demo_ref):
        check(out["json"] == seq, f"mesh {tag}: the JSON differs from phase "
              f"13's")
        for name in pairs:
            check(out[f"grid_{name}"] == want[name], f"mesh {tag}: the "
                  f"{name} grid differs from phase 9's")
        check(abs(out["recipe_loss"] - one) <= 1e-5 * abs(one),
              f"mesh {tag}: recipe loss {out['recipe_loss']} vs {one}")
        check(abs(out["demo_loss"] - demo_ref) <= 1e-5 * abs(demo_ref),
              f"mesh {tag}: demo loss {out['demo_loss']} vs {demo_ref}")

    t0 = time.perf_counter()
    multihost.init_rank(0, 1, os.path.join(workdir, "store"), "cuda")
    try:
        mesh = make_mesh(1)
        backends = {dist.get_backend(), dist.get_backend(
            mesh.get_group("data"))}
        check(backends == {"nccl"}, f"mesh (a): backends {backends}")
        a = mesh_work(mesh, path, dev, folios, pairs, batch)
    finally:
        multihost.leave_rank()
    a_wall = time.perf_counter() - t0
    check_run("(a)", a, a["demo_loss"])
    print(f"mesh (a) one NCCL rank on cuda:0 (card {card}): process_batch "
          f"of {N_FOLIOS} folios {a['batch_ms']:.1f} ms a folio (phase 13: "
          f"device {batch_ms['device']:.1f}, hybrid "
          f"{batch_ms['hybrid']:.1f}), JSON "
          f"identical to phase 13's; grids equal to phase 9's, "
          f"{grid_text(a)}; shares {a['shares']}; launches "
          f"{a['launches']}; demo loss "
          f"{a['demo_loss']!r}, recipe loss {a['recipe_loss']!r} (one "
          f"process {one!r}); phase (a) wall {a_wall:.1f} s")
    check(all(a["launches"][k] >= 1 for k in MESH_KERNELS),
          f"mesh (a): launches {a['launches']}")

    t0 = time.perf_counter()
    multihost.launch(_mesh_rank, MESH_WORLD, args=(workdir, path),
                     device="cuda", deadline_s=MESH_DEADLINE_S)
    b_wall = time.perf_counter() - t0
    outs = []
    for r in range(MESH_WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    for r, b in enumerate(outs):
        check(b["backend"] == "gloo" and b["device"] == "cuda:0",
              f"mesh (b) rank {r}: {b['backend']} on {b['device']}")
        check_run(f"(b) rank {r}", b, a["demo_loss"])
        shares = b["shares"]
        check(len(shares) == MESH_WORLD and len(set(shares.values())) == 1,
              f"mesh (b): work shares {shares}")
        for rank, counts in b["all_launches"].items():
            check(all(counts[k] >= 1 for k in MESH_KERNELS),
                  f"mesh (b) {rank}: launches {counts}")
    b = outs[0]
    print(f"mesh (b) {MESH_WORLD} gloo ranks sharing cuda:0 (card {card}; "
          f"two ranks on one card test the partition and the collectives, "
          f"not scaling): process_batch {b['batch_ms']:.1f} / "
          f"{outs[1]['batch_ms']:.1f} ms a folio (phase 13: device "
          f"{batch_ms['device']:.1f}, hybrid {batch_ms['hybrid']:.1f}; mesh "
          f"(a) "
          f"{a['batch_ms']:.1f}), JSON identical to phase 13's in every "
          f"rank; grids equal to phase 9's, rank 0: {grid_text(b)}; rank "
          f"1: {grid_text(outs[1])}; work shares "
          f"{b['shares']}; launches by rank {b['all_launches']}; demo loss "
          f"{b['demo_loss']!r} (one rank {a['demo_loss']!r}), recipe loss "
          f"{b['recipe_loss']!r} (one process {one!r}); spawn to join "
          f"{b_wall:.1f} s")


EXAMPLE_RUNGS = 4  # the ladder's three rungs and the final checkpoint


def rung_text(row) -> str:
    diag = row["diag"]
    counts = {k: v for k, v in diag["counts"].items() if v} if diag else {}
    cer = diag["ocr_cer"] if diag else 1.0
    return (f"{os.path.basename(row['path'])} (saved at loss "
            f"{row['save_loss']:.4f}): CER {cer:.4f}, syllables "
            f"{row['n_pred']}, bbox IoU {row['iou']:.4f}, ink IoU "
            f"{row['ink_iou']:.4f}, {counts}")


def heldout_output(path, page, device):
    """process() of the example's held-out page on ``device`` with the
    checkpoint at ``path``, its recognizer normalizing lines on the device
    (on the CPU the kernels' plain versions): all_chars as (char, ul, lr)
    and the syl_boxes JSON."""
    rec = SeqRecognizer.from_pyrnn(path, device=device)
    rec.normalize_on_device = True
    out = process(page.image, page.transcript, ocropus_model=rec,
                  backend="hybrid", verbose=False, device=device)
    check(out is not None, f"example: nothing aligned on {device}")
    return ([(c.char, c.ul, c.lr) for c in out[3]],
            json.dumps(to_JSON_dict(out[0], out[2]), sort_keys=True))


def ceiling_json(e2e, page, device):
    """The example's perfect-OCR rung on ``device``: its syl_boxes JSON."""
    image_bin, _, angle = preprocess_images(page.image, backend="hybrid")
    chars = e2e.llocs_ceiling_chars(page, angle, page.image.shape[:2],
                                    image_bin.shape)
    out = process(page.image, page.transcript, existing_ocr=chars,
                  backend="hybrid", verbose=False, device=device)
    return json.dumps(to_JSON_dict(out[0], out[2]), sort_keys=True)


def phase_example(dev, card):
    """Phase 20: the end-to-end example on the card at its defaults. Gates:
    the example's own PASS (>= 80% of the GT syllables found and ink IoU
    > 0.50 at the final checkpoint, wrong-line 0 at every rung), the
    ladder's four rungs, lstm_scan and lineest_tail launched during its
    run, the final checkpoint's decode and JSON on the CPU (plain
    versions) equal to the card's, the ceiling's JSON equal on both.
    Reports: steps, ms a step, the training wall, every rung, the ceiling,
    the full chain's quality beside the default tail's, the phase's wall."""
    import shutil

    from text_alignment_tpu_torch.examples import end_to_end_synthetic as e2e

    t0 = time.perf_counter()
    args = e2e.parse_args([])
    _kernels.reset_launches()
    out = e2e.run(args)
    launches = {k: _kernels.launches[k] for k in OCR_KERNELS}
    rows, n_gt = out["rows"], out["n_gt"]
    step_ms = out["step_ms"]
    print(f"example: {out['steps']} steps to loss {out['final_loss']:.4f} "
          f"(stop 0.15), {out['lines']} lines, B = {out['B']}, T = "
          f"{out['T']}, ni = {NI}, ns = {NS}: ms a step median "
          f"{np.median(step_ms):.1f} (first {step_ms[0]:.1f}, min "
          f"{min(step_ms):.1f}, max {max(step_ms):.1f}), training wall "
          f"{out['train_s']:.1f} s on {out['device']} ({card})")
    for row in rows:
        print(f"example rung {rung_text(row)} of {n_gt} ({card})")
    ceiling = out["ceiling"]
    if ceiling is not None:
        print(f"example ceiling: syllables {ceiling['n_pred']}, bbox IoU "
              f"{ceiling['iou']:.4f}, ink IoU {ceiling['ink_iou']:.4f} "
              f"({card})")
    print(f"example: held-out launches {launches}, PASS {out['ok']}")
    check(torch.device(out["device"]).type == "cuda",
          f"example: ran on {out['device']}")
    check(len(rows) == EXAMPLE_RUNGS and ceiling is not None,
          f"example: {len(rows)} rungs, ceiling {ceiling}")
    final = rows[-1]
    check(final["n_pred"] >= 0.8 * n_gt,
          f"example: {final['n_pred']} of {n_gt} syllables found")
    check(final["ink_iou"] > 0.50, f"example: ink IoU {final['ink_iou']}")
    wrong = [r["diag"]["counts"]["wrong-line"] if r["diag"] else None
             for r in rows]
    check(wrong == [0] * len(rows), f"example: wrong-line {wrong}")
    check(out["ok"], "example: its own gate says FAIL")
    check(all(n >= 1 for n in launches.values()),
          f"example: the held-out process() calls launched {launches}")

    page, gt = e2e.heldout_page()
    path = final["path"]
    card_chars, card_json = heldout_output(path, page, dev)
    cpu_chars, cpu_json = heldout_output(path, page, "cpu")
    print(f"example: final checkpoint reloaded on the CPU: all_chars equal "
          f"{cpu_chars == card_chars} ({len(card_chars)} chars), syl_boxes "
          f"JSON equal {cpu_json == card_json}")
    check(cpu_chars == card_chars, "example: the CPU decode differs")
    check(cpu_json == card_json, "example: the CPU JSON differs")
    same = ceiling_json(e2e, page, dev) == ceiling_json(
        e2e, page, "cpu")
    print(f"example: ceiling JSON byte-identical card vs CPU {same}")
    check(same, "example: the ceiling's JSON differs on the CPU")

    # the open question of the full chain on a trained model: a report
    before = _kernels.launches["lineest_full"]
    old = os.environ.get("TEXT_ALIGNMENT_TPU_TAIL")
    os.environ["TEXT_ALIGNMENT_TPU_TAIL"] = "full"
    try:
        n_full, _, ink_full, diag_full = e2e.evaluate_checkpoint(
            path, page, gt, "hybrid", "region", dev)
    finally:
        restore_env("TEXT_ALIGNMENT_TPU_TAIL", old)
    cer_full = diag_full["ocr_cer"] if diag_full else 1.0
    cer = final["diag"]["ocr_cer"]
    print(f"example full chain (TEXT_ALIGNMENT_TPU_TAIL=full, report only): "
          f"ink IoU {ink_full:.4f} (default tail {final['ink_iou']:.4f}), "
          f"CER {cer_full:.4f} ({cer:.4f}), syllables {n_full} "
          f"({final['n_pred']}), lineest_full launches "
          f"{_kernels.launches['lineest_full'] - before} ({card})")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    print(f"example: phase 20 {time.perf_counter() - t0:.1f} s ({card})")


DEVICE_KERNELS = ("cc_clean", "cc_table", "nw_fill", "nw_traceback",
                  "lstm_scan", "lineest_tail")
DEVICE_CALLS = 3  # measured process() calls of each backend in phase 21


def serpentine(n: int = 250, width: int = 40) -> np.ndarray:
    """One component: n one-pixel bars ``width`` px wide, joined at
    alternating ends, (2n - 1) x width px. At n = 250 the JAX package's
    device labeling stops after its 192 rounds and counts 59."""
    img = np.zeros((2 * n - 1, width), bool)
    img[::2] = True
    for i in range(n - 1):
        img[2 * i + 1, width - 1 if i % 2 == 0 else 0] = True
    return img


def timed_process(page, path, backend, device, n):
    """JSON of process() and its ms and stage ms (medians of n calls)."""
    timers, totals = [], []
    for _ in range(n):
        timer = stage_timer(enabled=True)
        out, ms = wall_ms(lambda: process(
            page.image, page.transcript, ocropus_model=path,
            backend=backend, verbose=False, device=device, timer=timer))
        totals.append(ms)
        timers.append(timer)
    check(out is not None, f"process(backend={backend!r}) returned None")
    stages = {k: round(float(np.median([t.totals[k] for t in timers])) * 1e3,
                       3) for k in timers[0].totals}
    js = json.dumps(to_JSON_dict(out[0], out[2]), sort_keys=True)
    return js, float(np.median(totals)), stages


def device_raster_split(image, dev, n: int = 3) -> dict:
    """Each step of the card route's raster on ``image``
    (preprocess_device_packed, then the line finder on the packed page):
    host-clock ms (medians of n runs, each step ending in a sync) and
    device ms (the sum of the step's device events under torch.profiler,
    the largest of its profiled calls)."""
    p = PreprocParams()
    runs, steps = [], {}
    for _ in range(n):
        ms, st = {}, {}

        def step(name, fn):
            out, ms[name] = wall_ms(fn)
            st[name] = fn
            return out

        grey = step("upload + greyscale", lambda: dv.to_greyscale(image,
                                                                  dev))
        t = step("histogram + Otsu", lambda: dv._otsu_from_hist(
            dv.grey_histogram(grey, dev).cpu().numpy()))
        H, W = int(grey.shape[0]), int(grey.shape[1])
        cleaned, ok = step("cleanup chain", lambda: dv.preproc_stage1_packed(
            grey, t, p.despeckle_amt, p.sat_area_thresh, device=dev))
        idx = step("skew", lambda: torch.cat([sd.search(
            cc.unpack_bits(cleaned, W), -6, 6), ok.to(torch.int64)]).tolist())
        angle = sd.angle_from_indices(*idx[:3], -6, 6)
        H2, W2 = fxp.rotated_canvas(H, W, angle)
        cs = fxp.rotation_coeffs(angle)
        rot = step("rotate + erode + project",
                   lambda: dv.rotate_erode_project_packed(
                       cleaned, H, W, *cs, H2, W2))
        wire, image_bin = step("download + unpack", lambda: (
            w := torch.cat([rot[2], rot[0].reshape(-1)]).cpu().numpy(),
            dv.unpack_bool(w[H2:].reshape(H2, -1), W2)))
        step("line finder", lambda: identify_text_lines(
            image_bin, PackedPage(rot[1], W2, wire[:H2]), backend="device",
            device=dev))
        runs.append(ms)
        steps = st
    out = {}
    for name, fn in steps.items():
        calls, _ = device_events(fn, repeat=2)
        dev_ms = max((sum(e - s for _, s, e in c) for c in calls),
                     default=0.0) / 1e3
        out[name] = {"host_ms": round(float(np.median(
            [r[name] for r in runs])), 3), "device_ms": round(dev_ms, 4)}
    return out


RASTER_ANGLES = (0.8, -0.8, 6.0, -6.0)  # and three seeded ones


def phase_raster_kernel(image, dev, seed: int = 21) -> dict:
    """The rotate + erode + project kernel on ``image``'s packed stage-1
    page (the native engine's) at its detected angle, RASTER_ANGLES and
    three seeded angles: bit for bit its plain version (on the CPU) and
    the native rotate + erode and row projection; its ms, its bound and
    the plain chain's ms on the card at the detected angle."""
    img, runs, n_runs = host_native.preprocess_page_phase1(image, 100, 150)
    H, W = img.shape
    detected = host_native.rotation_angle_projections(
        img, -6, 6, runs_n=(runs, n_runs))
    seeded = np.round(np.random.default_rng(seed).uniform(-6, 6, 3), 2)
    pk = torch.from_numpy(cc.pack_page(img.astype(bool)))
    pkd = pk.to(dev)

    def geometry(angle):
        return (*fxp.rotation_coeffs(angle),
                *fxp.rotated_canvas(H, W, angle))

    for angle in (detected, *RASTER_ANGLES, *map(float, seeded)):
        g = geometry(angle)
        got = [t.cpu() for t in dv.rotate_erode_project_packed(
            pkd, H, W, *g)]
        want = dv.rotate_erode_project_reference(pk, H, W, *g)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"raster_rotate_erode differs from its plain version at "
              f"{angle} deg")
        bin_n, ero_n = host_native.preprocess_page_phase2(
            img, runs, n_runs, angle, 1, 2, True)
        check(np.array_equal(cc.unpack_page(got[0].numpy(), *g[2:]), bin_n)
              and np.array_equal(cc.unpack_page(got[1].numpy(), *g[2:]),
                                 ero_n)
              and np.array_equal(got[2].numpy(),
                                 host_native.projection_rows(ero_n)),
              f"raster_rotate_erode differs from the native engine at "
              f"{angle} deg")
    g = geometry(detected)
    H2, W2 = g[2:]
    ms = cuda_ms(lambda: dv.rotate_erode_project_packed(pkd, H, W, *g), 50)
    plain_ms = cuda_ms(lambda: dv.rotate_erode_project_reference(
        pkd, H, W, *g), 10)
    # the packed page in, two packed pages and the projection out; some 20
    # integer operations a rotated pixel
    b = bound(4 * pk.numel() + 2 * 4 * H2 * -(-W2 // 32) + 4 * H2,
              20 * H2 * W2)
    print(f"raster_rotate_erode: {H} x {W} -> {H2} x {W2} at {detected} deg "
          f"and at {list(RASTER_ANGLES) + seeded.tolist()}: bit for bit its "
          f"plain version and the native engine; kernel {ms:.4f} ms, plain "
          f"chain on the card {plain_ms:.3f} ms, bound {b['bound_ms']:.5f} "
          f"ms by {b['bound_by']}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def phase_device_backend(dev, card, path, page):
    """Phase 21: backend="device" (ops/device.py: the raster on the card
    through cc_clean and cc_table, NW always on the card) through
    process() and the Rodan job, against the hybrid route and the CPU,
    and the serpentine page."""
    from text_alignment_tpu_torch import rodan_job
    from text_alignment_tpu_torch.ops import device as dv
    from text_alignment_tpu_torch.pipeline.preprocess import _cc_table

    t0 = time.perf_counter()
    run_process(page, path)  # warm-up of both routes
    process(page.image, page.transcript, ocropus_model=path,
            backend="device", verbose=False, device=dev)
    _kernels.reset_launches()
    js, ms, stages = timed_process(page, path, "device", dev, DEVICE_CALLS)
    launches = dict(_kernels.launches)
    _kernels.reset_launches()
    js_h, ms_h, stages_h = timed_process(page, path, "hybrid", dev,
                                         DEVICE_CALLS)
    launches_h = dict(_kernels.launches)
    js_cpu, ms_cpu, _ = timed_process(page, path, "device",
                                      torch.device("cpu"), 1)
    js_h_cpu, _, _ = timed_process(page, path, "hybrid",
                                   torch.device("cpu"), 1)
    print(f"device backend: folio process(backend=\"device\") {ms:.1f} ms "
          f"(median of {DEVICE_CALLS}), stages ms {stages}; "
          f"backend=\"hybrid\" {ms_h:.1f} ms, stages {stages_h}; CPU "
          f"{ms_cpu:.1f} ms; launches {launches} ({card})")
    folio_launches = {k: v / DEVICE_CALLS for k, v in launches_h.items()
                      if v}
    print(f"device backend: backend=\"hybrid\" on the card, launches a "
          f"folio {folio_launches}; JSON identical to the CPU's (native "
          f"raster) {js_h == js_h_cpu}")
    for name in ("raster_rotate_erode", "cc_clean", "cc_table"):
        check(launches_h[name] == DEVICE_CALLS, f"process(backend='hybrid') "
              f"on the card: {launches_h[name]} {name} launches in "
              f"{DEVICE_CALLS} folios")
    check(js_h == js_h_cpu, "process(backend='hybrid') differs between the "
          "card and the CPU")
    print(f"device backend: the card route's raster by step "
          f"{device_raster_split(page.image, dev)} ({card})")
    raster = phase_raster_kernel(page.image, dev)
    check(js == js_h, "process(backend='device') differs from 'hybrid' on "
          "the card")
    check(js == js_cpu, "process(backend='device') differs between the card "
          "and the CPU")
    for name in DEVICE_KERNELS:
        check(launches[name] >= 1, f"kernel {name} was not launched by "
              "process(backend='device')")

    with tempfile.TemporaryDirectory() as tmp:
        from PIL import Image

        img_path = os.path.join(tmp, "folio.png")
        Image.fromarray(page.image).save(img_path)
        txt_path = os.path.join(tmp, "folio.txt")
        with open(txt_path, "w") as f:
            f.write(page.transcript)
        out_path = os.path.join(tmp, "folio.json")
        ok = rodan_job.run_task(
            {"Text Layer": [{"resource_path": img_path}],
             "Transcript": [{"resource_path": txt_path}]},
            {"OCR Model": path}, {"JSON": [{"resource_path": out_path}]})
        with open(out_path) as f:
            rodan = json.dumps(json.load(f), sort_keys=True)
    print(f"device backend: rodan_job.run_task (default backend) ok {ok}, "
          f"JSON identical {rodan == js}")
    check(ok and rodan == js, "the Rodan job's JSON differs from process()")

    serp = serpentine()
    _, count = dv.cc_stats_compact(serp, device=dev)
    rows = len(_cc_table(serp, "device", dev))
    hybrid_rows = len(_cc_table(serp, "hybrid"))
    print(f"device backend: serpentine {serp.shape[0]} x {serp.shape[1]}: "
          f"{count} component(s) on the card, {rows} table row(s), hybrid "
          f"{hybrid_rows}")
    check(count == rows == hybrid_rows == 1,
          "the serpentine is not one component")
    print(f"device backend: phase 21 {time.perf_counter() - t0:.1f} s "
          f"({card})")
    return raster, launches_h["raster_rotate_erode"]


class Walls:
    """Wall seconds of each group of phases, printed as the group ends."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def lap(self, phases: str) -> None:
        now = time.perf_counter()
        print(f"wall: phases {phases} {now - self.last:.1f} s, the script "
              f"{now - self.start:.1f} s")
        self.last = now


BENCH_ARGS = ()  # phase 22's bench arguments beyond --out (its defaults)
BENCH_KERNELS = ("lstm_scan", "lineest_tail", "nw_fill", "nw_fill_batched",
                 "nw_traceback", "cc_clean")
BENCH_GUARD = "# batch guard: the batched JSON equals the sequential JSON"


def phase_bench(card):
    """Phase 22: the port's bench in a child process on the card, checked
    as its docstring and the script's say (a failure is not caught)."""
    from text_alignment_tpu_torch.bench import HIGHER_IS_BETTER

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        child = subprocess.run(
            [sys.executable, "-m", "text_alignment_tpu_torch.bench", "--out",
             out, *BENCH_ARGS], capture_output=True, text=True, timeout=600,
            cwd=root)
        check(child.returncode == 0,
              f"the bench failed ({child.returncode}): "
              f"{child.stderr[-3000:]}")
        head = json.loads(child.stdout.strip().splitlines()[-1])
        with open(os.path.join(out, "bench_last.json")) as f:
            last = json.load(f)
    check(head["metric"] == "folios/sec" and head["unit"] == "folios/sec"
          and head["value"] > 0 and head["vs_baseline"] > 0,
          f"bad bench headline {head}")
    bad = [k for k in HIGHER_IS_BETTER
           if not (np.isfinite(last.get(k, np.nan)) and last[k] > 0)]
    check(len(HIGHER_IS_BETTER) == 13 and not bad,
          f"bench_last.json lacks or has bad metrics {bad}")
    check(last.get("card") == card, f"bench card {last.get('card')!r}")
    check(round(last["folios_per_sec"], 3) == head["value"],
          f"headline {head} against {last['folios_per_sec']}")
    check(BENCH_GUARD in child.stderr, "the bench's batch guard did not pass")
    lines = [ln for ln in child.stderr.splitlines()
             if ln.startswith("# kernel launches: ")]
    check(len(lines) == 1, "the bench printed no kernel launches")
    launched = json.loads(lines[0].split(": ", 1)[1])
    check(all(launched[k] >= 1 for k in BENCH_KERNELS),
          f"the bench launched {launched}")
    for ln in child.stderr.splitlines():
        if ln.startswith(("# device[", "# cpu baseline", "# regression",
                          "# REGRESSIONS")):
            print(f"bench: {ln[2:]}")
    print(f"bench: {card}: " + ", ".join(
        f"{k} {last[k]:.6g}" for k in HIGHER_IS_BETTER))
    print(f"bench: headline {json.dumps(head)}; launches {launched}; phase "
          f"22 {time.perf_counter() - t0:.1f} s {list(BENCH_ARGS)}")


def main(argv) -> int:
    walls = Walls()
    card = phase_card()
    phase_build()
    tl.pin_float32()
    dev = torch.device("cuda")
    if argv == ["--profile"]:
        return profile_only(dev)
    check(not argv, f"unknown arguments {argv} (only --profile)")
    walls.lap("1-2")
    page = make_folio()
    image, eroded, _ = preprocess_images(page.image, backend="hybrid")
    strips, _, _ = identify_text_lines(image, eroded, backend="hybrid")
    inks = [s.img for s in strips]
    check(len(inks) >= 8, f"folio segmented into {len(inks)} lines only")
    codec = Codec()
    params_np = peaky_params(0, len(codec))
    rec = SeqRecognizer(tl.params_from_np(params_np), codec,
                        normalize_on_device=True, device=dev)
    fi = folio_inputs(rec, inks, dev)
    strips = gate_strips()
    stats = {"lstm_scan": phase_lstm(rec, fi, dev),
             "lineest_tail": phase_tail(rec, fi, strips, dev)}
    walls.lap("3-4")

    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "folio.pyrnn.gz")
    save_pyrnn(path, params_np, codec)
    launches = phase_slice(page, path)

    gpu = phase_cpu_vs_cuda(params_np, codec, inks, fi)
    prof = profile_ocr(gpu, inks)
    print(f"ocr profile: device busy {prof[0]:.3f} ms of {prof[1]:.3f} ms "
          f"wall (table by kernel on stderr)")
    walls.lap("5-6")

    stats["nw_fill"], packed, nts, nos = phase_nw_fill(dev)
    stats["nw_traceback"] = phase_nw_traceback(dev, packed, nts, nos)
    del packed
    stats["nw_fill_batched"], grid_launches, grids = phase_nw_batched(dev,
                                                                      page)
    nw_launches = phase_nw_process()
    # the long pairs' packed pointers (up to 735 MB a launch) stay in the
    # caching allocator; hand them back before the batch phases
    torch.cuda.empty_cache()
    # each kernel's launches come from its own path's run: the folio
    # (phase 5), process() on the large page (phase 10), the 2400^2 grid
    launches.update({k: nw_launches[k] for k in ("nw_fill", "nw_traceback")})
    launches["nw_fill_batched"] = grid_launches["2400"]["nw_fill_batched"]
    walls.lap("7-10")

    stats.update(phase_cc(dev, make_batch_folio(3000), page))
    phase_skew(dev, page)
    batch_launches, batch_pages, batch_seq, batch_ms = phase_batch(path,
                                                                   dev)
    # the CC kernels' launches: process_batch with the raster on the card
    launches.update({k: batch_launches[k]
                     for k in ("cc_filter", "cc_clean", "cc_table")})
    walls.lap("11-13")

    stats["lineest_full"] = phase_full(rec, fi, strips, dev)
    phase_full_gate(params_np, codec, strips, dev)
    serve_launches = phase_serve(batch_pages, path, dev, tmp.name)
    launches["lineest_full"] = serve_launches["lineest_full"]
    walls.lap("14-16")
    phase_profile()
    walls.lap("17")
    stats["raster_rotate_erode"], launches["raster_rotate_erode"] = \
        phase_device_backend(dev, card, path, page)
    walls.lap("21")
    phase_bench(card)
    walls.lap("22")
    kraken_stats, kraken_launches = phase_kraken(page, inks, codec, dev)
    stats.update(kraken_stats)
    launches.update(kraken_launches)
    walls.lap("23")
    phase_train(dev)
    walls.lap("18")
    phase_mesh(dev, card, path, page, batch_pages, batch_seq, batch_ms,
               grids, tmp.name)
    walls.lap("19")
    phase_example(dev, card)
    tmp.cleanup()
    walls.lap("20")

    pallas = "text_alignment_tpu/align/nw_pallas.py"
    cc_pallas = "text_alignment_tpu/ops/cc_pallas.py"
    csrc = "text_alignment_tpu_torch/csrc"
    sources = {"lstm_scan": (f"{csrc}/lstm_scan.cu",
                             "text_alignment_tpu/models/lstm_pallas.py:175"),
               "lineest_tail": (
                   f"{csrc}/lineest_tail.cu",
                   "text_alignment_tpu/models/lineest_pallas.py:185"),
               "lineest_full": (
                   f"{csrc}/lineest_full.cu",
                   "text_alignment_tpu/models/lineest_pallas.py:336"),
               "nw_fill": (f"{csrc}/nw_fill.cu", f"{pallas}:238"),
               "nw_fill_batched": (f"{csrc}/nw_fill.cu", f"{pallas}:444"),
               "nw_traceback": (f"{csrc}/nw_traceback.cu", f"{pallas}:733"),
               "cc_filter": (f"{csrc}/cc_filter.cu", f"{cc_pallas}:443"),
               "cc_table": (f"{csrc}/cc_filter.cu", f"{cc_pallas}:537"),
               "cc_clean": (f"{csrc}/cc_filter.cu", f"{cc_pallas}:662"),
               # no Pallas kernel: the XLA ops of rotate_erode_project
               "raster_rotate_erode": (
                   f"{csrc}/raster.cu",
                   "text_alignment_tpu/ops/device.py rotate_erode_project")}
    # kraken's network on the main path (phase 23)
    for name in ("lstm_scan", "lineest_tail"):
        sources[f"{name}.kraken"] = sources[name]
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name], **stats[name]}
               for name, (src, rep) in sources.items()]
    for k in kernels:
        check(k["launches"] >= 1, f"kernel {k['name']} was not launched on "
              f"its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
