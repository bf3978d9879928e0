"""End-to-end benchmark of the port on one CUDA card: folios/sec through the
full alignment pipeline.

    python -m text_alignment_tpu_torch.bench [--device cuda|cpu]
        [--folios N] [--out DIR]

Counterpart of the repo-root ``bench.py``, which measures the JAX package
on a TPU: the same 13 metrics (names and directions), the same pages,
injected OCR and counts, the same CPU baseline, the same stage lines on
stderr and the same last stdout line::

  {"metric": "folios/sec", "value": N, "unit": "folios/sec", "vs_baseline": N}

Flow per folio (identical stage graph on both paths):
  binarize -> despeckle x2 -> tall-CC removal -> skew detect -> rotate ->
  run filters -> projection/peaks -> separator CC analysis -> line strips ->
  BiLSTM+CTC recognizer over all strips -> affine-gap NW (transcript vs OCR
  char stream) -> abbreviation/syllable assembly -> JSON dict.

- device path (backend from ``TEXT_ALIGNMENT_TPU_BENCH_BACKEND``:
  ``hybrid``, the default, the native C++ raster with the skew search on
  the card; ``device``, the raster of :mod:`.ops.device` on the card;
  ``host``, the numpy raster): the recognizer normalizes, runs the BiLSTM
  and decodes on the card (``lstm_scan``, ``lineest_tail``), NW takes
  the host fill at chant size as ``"auto"`` does. The batch runs
  :func:`.pipeline.preprocess.raster_stream`, the
  :class:`.parallel.batch.PipelinedOCRWorker` and ``process_batch``.
- baseline path: the host pipeline with the reference's literal O(N*M) NW
  fill (``perform_alignment(backend="reference")``) and the numpy per-line
  LSTM with the scipy normalizer, on the host whatever ``--device`` is: the
  stand-in for the CPU reference stack (Python 2 + Gamera/OCRopus), which
  cannot run here.

Weights are random: ``init_params_seeded(0, ...)``, the JAX bench's
``init_bilstm(PRNGKey(0), ...)`` bit for bit (a numpy Threefry), so the
recognizer's output is noise; its compute is timed at realistic shapes,
and NW and assembly run on an injected OCR stream with realistic error
rates. Secondary metrics: the OCR stage's strips/s (end to end, and raw
on a batch already on the card), NW GCUPS at 8191^2 and 16383^2 (single
shot, pipelined, raw fill), the 729-row scoring grid, the CC cleanup
chain (``ta_cc_clean``; the metric keeps the JAX name
``cc_pallas_clean_ms``) and the training step.

Every timed region ends in a host read of its result (on the card a read
waits for the stream, so it is the sync), and starts after one.
``batched_ms_per_folio`` is recorded only when the batch's JSON equals
the sequential JSON folio for folio; a mismatch exits non-zero.
``bench_last.json`` (the metrics and the ``card`` line) goes to
``--out`` (default: the working directory), and the regression table
compares the run with the H100 run in ``bench_baseline.json`` beside this
module, flagging a change for the worse of more than 15%. Refresh that
baseline by copying an accepted run's ``bench_last.json`` over it.

Left out of ``bench.py``, on purpose:
- ``_probe_backend`` and its degraded mode (with the
  ``..._BENCH_FORCE_CPU`` and ``..._BENCH_NO_PROBE`` switches): a fallback
  that hides the device. The bench runs on the card; without one
  ``resolve_device`` raises. It runs on the CPU (the kernels' plain
  versions) only when asked: ``--device cpu``.
- The ``except Exception`` around each secondary metric: a metric that
  fails ends the run with a non-zero exit; no headline has a hole.
- ``ensure_compile_cache`` and ``compile_log_capture``: PyTorch compiles
  no programs (the CUDA kernels are built once by nvcc at first use); the
  warm-up lines give their wall time only.

``Trainer.step`` reads its loss each step (``float(loss)``), so the
training metric waits for the card once a step where the JAX bench fences
once over K steps, and uploads the host batch each step.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import random
import subprocess
import sys
import time
from importlib import import_module

import numpy as np
import torch

from . import _kernels
from .align import api as align_api
from .align import nw_kernel, nw_torch
from .align.scoring import resolve_scoring
from .evaluate import scoring_grid
from .models import lstm
from .models.codec import Codec
from .models.ctc import translate_back_np
from .models.lineest_host import normalize_strip
from .models.lstm_np import bilstm_forward_np
from .models.recognizer import SeqRecognizer, _recognize_device_wire
from .models.train import Trainer
from .ops import cc, oracle
from .parallel.batch import PipelinedOCRWorker, process_batch
from .pipeline import to_JSON_dict
from .pipeline.assemble import expand_abbreviations
from .pipeline.preprocess import (identify_text_lines, preprocess_images,
                                  raster_stream)
from .synth import corrupt_ocr, make_page, ocr_with_spaces

# the module, not the function that ``pipeline/__init__`` binds to the same
# name (``import ...pipeline.process as m`` would give the function, and the
# baseline's patch of ``perform_alignment`` would then change nothing)
proc_mod = import_module(".pipeline.process", __package__)

BENCH_SEED = 1234

# every metric, with its direction (True: higher is better); record()
# takes no other name, and main() fails unless all of them were recorded
HIGHER_IS_BETTER = {
    "sequential_ms_per_folio": False,
    "batched_ms_per_folio": False,
    "folios_per_sec": True,
    "ocr_strips_per_sec_e2e": True,
    "ocr_strips_per_sec_raw": True,
    "nw_pipelined_gcups_8k": True,
    "nw_pipelined_gcups_16k": True,
    "nw_raw_gcups_8k": True,
    "nw_raw_gcups_16k": True,
    "grid_chant_combos_per_sec": True,
    "grid_2400_combos_per_sec": True,
    "cc_pallas_clean_ms": False,
    "train_line_updates_per_sec": True,
}
METRICS: dict = {}

# 12 folios per batch: the batch's fixed tail (the last folio's OCR and
# the combined copy back) is amortized over a realistic serving batch
N_DEVICE_FOLIOS = 12
N_BASELINE_FOLIOS = 5  # median of 5: the host clock is bursty
DEVICE_BACKEND = os.environ.get("TEXT_ALIGNMENT_TPU_BENCH_BACKEND", "hybrid")
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_baseline.json")
K_PIPELINED = 8  # queued calls a pipelined or raw metric times
NI, NS = 48, 100


class BenchError(RuntimeError):
    pass


def record(name: str, value: float) -> None:
    """Record one metric: a known name and a finite positive value."""
    if name not in HIGHER_IS_BETTER:
        raise KeyError(f"unknown bench metric {name!r}")
    value = float(value)
    if not (math.isfinite(value) and value > 0):
        raise BenchError(f"metric {name} = {value}: not finite and positive")
    METRICS[name] = value


def regression_report(threshold: float = 0.15, out_dir: str = ".",
                      baseline_path: str = BASELINE_PATH,
                      card: str | None = None) -> list:
    """Write METRICS (and ``card``) to ``out_dir``/bench_last.json, then
    diff them against ``baseline_path``'s numeric keys on stderr, flagging
    each change for the worse beyond ``threshold``. Returns the flagged
    names."""
    last = dict(METRICS)
    if card is not None:
        last["card"] = card
    last_path = os.path.join(out_dir, "bench_last.json")
    with open(last_path, "w") as f:
        json.dump(last, f, indent=2, sort_keys=True)
    if not os.path.isfile(baseline_path):
        print(f"# regression table: no {baseline_path} — wrote {last_path}",
              file=sys.stderr)
        return []
    with open(baseline_path) as f:
        base = json.load(f)
    rows, regressions = [], []
    for name in sorted(METRICS):
        now = METRICS[name]
        prev = base.get(name)
        if isinstance(prev, bool) or not isinstance(prev, (int, float)) \
                or prev == 0:
            rows.append(f"#   {name:<34} {'—':>10} -> {now:>10.4g}  (new)")
            continue
        change = (now - prev) / abs(prev)
        worse = -change if HIGHER_IS_BETTER[name] else change
        flag = ""
        if worse > threshold:
            flag = f"  ** REGRESSION ({worse:.0%} worse)"
            regressions.append(name)
        rows.append(f"#   {name:<34} {prev:>10.4g} -> {now:>10.4g}  "
                    f"{change:+.1%}{flag}")
    print(f"# regression table (vs {os.path.basename(baseline_path)}, card "
          f"{base.get('card')!r}; flag >{threshold:.0%} drops):",
          file=sys.stderr)
    for r in rows:
        print(r, file=sys.stderr)
    if regressions:
        print(f"# REGRESSIONS: {', '.join(regressions)}", file=sys.stderr)
    else:
        print("# regression table: all green", file=sys.stderr)
    return regressions


def make_bench_page(seed):
    return make_page(
        np.random.default_rng(seed),
        n_lines=10,
        words_per_line=3,
        H=2000,
        W=1600,
        char_h=70,
        char_w=40,
        gap=8,
        space_w=60,
        line_spacing=180,
        speckles=200,
        margin_x=60,
        angle=0.8,
    )


def folio_flow(page, ocr_chars, recognizer, backend, device=None):
    """One folio end-to-end on ``device`` (None: the card); returns the
    JSON dict. The recognizer runs over the page's strips for its time
    (its output is noise: the weights are random); the alignment takes
    the injected ``ocr_chars``."""
    image, eroded, angle = preprocess_images(page.image, backend=backend,
                                             device=device)
    strips, _, _ = identify_text_lines(image, eroded, backend=backend,
                                       verbose=False, device=device)
    recognizer.recognize_batch([s.img for s in strips])
    syl_boxes, _, lines_peak_locs, _ = proc_mod.process(
        page.image,
        page.transcript,
        existing_ocr=ocr_chars,
        existing_preproc_images=(image, eroded, angle),
        verbose=False,
        backend=backend,
        device=device,
    )
    return to_JSON_dict(syl_boxes, lines_peak_locs)


def device_recognizer(backend: str = DEVICE_BACKEND, device=None):
    """The recognizer of the device path: random weights (the JAX bench's),
    the device normalizer unless ``backend`` is "host"."""
    codec = Codec()
    dev = align_api.resolve_device(device)
    return SeqRecognizer(
        lstm.params_from_np(lstm.init_params_seeded(0, NI, NS, len(codec)),
                            dev),
        codec, normalize_on_device=(backend != "host"), device=dev)


def baseline_recognizer(params=None):
    """Pure-numpy per-line recognizer (the ocropy-equivalent CPU path):
    the scipy normalizer, the numpy BiLSTM and the numpy CTC decode, on the
    host. ``params``: weights in the numpy-dict format (default: the JAX
    bench's, ``init_bilstm(PRNGKey(0), 48, 100, 64)``)."""
    d = (lstm.init_params_seeded(0, NI, NS, 64) if params is None
         else params)

    class _NpRec:
        def recognize_batch(self, strip_imgs):
            out = []
            for img in strip_imgs:
                norm = normalize_strip(img)
                if norm is None:
                    out.append([])
                    continue
                frames, _ = norm
                posteriors = bilstm_forward_np(d, frames)
                out.append(translate_back_np(posteriors))
            return out

    return _NpRec()


def injected_ocr(page, seed):
    rng = np.random.default_rng(seed)
    return ocr_with_spaces(corrupt_ocr(rng, page.char_boxes))


def ocr_metrics(pages, dev_rec, backend: str = DEVICE_BACKEND):
    """Recognizer throughput: strips/sec through the normalize -> BiLSTM ->
    CTC path, plus model FLOP/s from the BiLSTM flops model (2 dirs x 4
    gate matmuls of (ns, 1+ni+ns) + softmax (nout, 2ns+1), 2 flops/MAC)
    over the normalized frame count (width * 48/height). End to end:
    ``recognize_batch``, best of 3. Raw: the strips packed once and put on
    the card, then K wires of the device program queued with one read of
    the last."""
    dev = dev_rec.device
    strips = []
    for p in pages[1:]:
        image, eroded, _ = preprocess_images(p.image, backend=backend,
                                             device=dev)
        ls, _, _ = identify_text_lines(image, eroded, backend=backend,
                                       verbose=False, device=dev)
        strips.extend(s.img for s in ls)
    frames = sum(
        int(round(s.shape[1] * 48.0 / max(1, s.shape[0]))) for s in strips
    )
    ni, ns, nout = NI, NS, 64
    flops_per_frame = (2 * (4 * 2 * ns * (1 + ni + ns))
                       + 2 * nout * (2 * ns + 1))
    dev_rec.recognize_batch(strips)  # warm the size buckets
    dt = float("inf")  # best of 3: host-side packing rides the host clock
    for _ in range(3):
        t0 = time.perf_counter()
        dev_rec.recognize_batch(strips)
        dt = min(dt, time.perf_counter() - t0)
    record("ocr_strips_per_sec_e2e", len(strips) / dt)
    print(f"# ocr: {len(strips)/dt:.0f} strips/sec, "
          f"~{frames * flops_per_frame / dt / 1e9:.2f} model GFLOP/s "
          f"({len(strips)} strips, ~{frames} frames, fp32 parity path)",
          file=sys.stderr)

    # raw device program (no host packing, no upload, no copy back): the
    # packed batch already on the card, K wires queued, one read
    inks = [np.asarray(s) for s in strips]
    packed_meta, _, ws, Wp = dev_rec._pack_strips(inks)
    t_max = dev_rec._initial_t_max(Wp, ws[: len(inks)])
    pm = dev_rec._to_device(packed_meta)
    kw = dict(t_max=t_max, target_height=dev_rec.target_height,
              pad=dev_rec.pad, max_regions=128, decode=dev_rec.decode)
    int(_recognize_device_wire(dev_rec.params, pm, **kw)[0, 0])
    t0 = time.perf_counter()
    for _ in range(K_PIPELINED - 1):
        _recognize_device_wire(dev_rec.params, pm, **kw)
    int(_recognize_device_wire(dev_rec.params, pm, **kw)[0, 0])
    raw_dt = (time.perf_counter() - t0) / K_PIPELINED
    record("ocr_strips_per_sec_raw", len(strips) / raw_dt)
    print(f"# ocr raw compute (bits resident on device): "
          f"{len(strips)/raw_dt:.0f} strips/sec, "
          f"~{frames * flops_per_frame / raw_dt / 1e9:.2f} model "
          f"GFLOP/s", file=sys.stderr)


def stress_pair(n: int):
    """The seeded n x n NW stress pair, a ' ' sentinel appended to each."""
    rng = random.Random(0)
    t = [rng.choice("abcdefgh ") for _ in range(n)] + [" "]
    o = [rng.choice("abcdefgh ") for _ in range(n)] + [" "]
    return t, o


def nw_gcups_stress(n: int = 8191, device=None):
    """NW fill + traceback throughput at (n + 1)^2 cells, in GCUPS: the
    single-shot latency (``perform_alignment``'s device route without the
    replay, best of 3), pipelined (K fills and walks of the prepared pair
    queued, one read of the last wire) and the raw fill (K fills each
    reduced on the device to an int32 sum, one read). Returns (lat, thr,
    raw, (tra_align, ocr_align)): the last pipelined wire's alignment."""
    dev = align_api.resolve_device(device)
    t, o = stress_pair(n)
    cells = (n + 1) * (n + 1)
    sc = resolve_scoring(None)
    fused = align_api._device_align_ops(sc)
    fused(t, o, sc, dev)  # warm
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fused(t, o, sc, dev)
        dt = min(dt, time.perf_counter() - t0)
    lat = cells / dt / 1e9

    tt, oo, nts, nos = nw_torch.lane_batch([(t, o)])
    t_d = torch.from_numpy(tt).to(dev)
    o_d = torch.from_numpy(oo).to(dev)
    params = torch.from_numpy(nw_torch.kernel_params(sc)[None]).to(dev)
    nts_d = torch.from_numpy(nts).to(dev)
    nos_d = torch.from_numpy(nos).to(dev)

    def wire():
        return nw_kernel.traceback_batched(
            nw_kernel.fill(t_d, o_d, params), nts_d, nos_d)

    int(wire()[0, 0])
    t0 = time.perf_counter()
    outs = [wire() for _ in range(K_PIPELINED)]
    last = outs[-1].cpu().numpy()
    thr = cells / ((time.perf_counter() - t0) / K_PIPELINED) / 1e9
    del outs

    def fill_sum():
        return nw_kernel.fill(t_d, o_d, params).sum(dtype=torch.int32)

    int(fill_sum())
    t0 = time.perf_counter()
    for _ in range(K_PIPELINED):
        s = fill_sum()
    int(s)
    raw = cells / ((time.perf_counter() - t0) / K_PIPELINED) / 1e9
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ops, k, xpt, ypt = nw_torch.unwire(last)
    aligned = nw_torch.replay_ops(t, o, ops[0], int(k[0]), int(xpt[0]),
                                  int(ypt[0]))
    return lat, thr, raw, aligned


def grid_sweep_metric(pages, ocrs, n: int = 2400, device=None):
    """The reference's 729-combination scoring grid search
    (evaluate_text_alignment.py:181-189), NW stage only, through
    ``align_grid``: on the bench folio's chant-sized pair and on
    :func:`stress_pair` (n), a prev-folio-prepended transcript's size.
    Warmed on the first 128 rows, best of 2. Returns {metric: the last
    call's alignments}."""
    dev = align_api.resolve_device(device)
    params = scoring_grid()
    chars = expand_abbreviations(list(ocrs[1]))
    ocr = "".join(c.char for c in chars)
    tra = list(pages[1].transcript)
    big_t, big_o = (x[:-1] for x in stress_pair(n))
    out = {}
    for key, label, t, o in (
            ("grid_chant_combos_per_sec", "chant page", tra, list(ocr)),
            ("grid_2400_combos_per_sec", f"{n}^2 stress", big_t, big_o)):
        align_api.align_grid(t, o, params[:128], device=dev)  # warm
        dt = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            out[key] = align_api.align_grid(t, o, params, device=dev)
            dt = min(dt, time.perf_counter() - t0)
        record(key, len(params) / dt)
        print(f"# scoring grid sweep ({label}, {len(t)}x{len(o)}): "
              f"{len(params)} alignments in {dt:.2f}s = "
              f"{len(params)/dt:.0f} combos/s", file=sys.stderr)
    return out


def cc_pallas_metric(pages, device=None):
    """The CC cleanup chain (``ta_cc_clean``: despeckle, despeckle_white,
    tall-CC removal; textAlignPreprocessing.py:166-178) on the binarized
    bench page packed on the device, (100, 150): K calls queued, one read
    of the last, best of 3. The run capacity is the page's own, H *
    ceil(W / 2), as ``backend="device"`` runs the chain: the bench page's
    ~46.7k white runs overflow the JAX bench's 45,056 (its call reports
    ok 0 and cleans a part of the page). Returns the last output page as a
    bool array; an ``ok`` of 0 raises."""
    dev = align_api.resolve_device(device)
    img = oracle.to_onebit(pages[1].image)
    H, W = img.shape
    pk = torch.from_numpy(cc.pack_page(img)).to(dev)
    capacity = H * ((W + 1) // 2)

    def clean():
        return cc.preproc_clean_packed(pk, H, W, 100, 150,
                                       max_runs=capacity)

    int(clean()[0][0, 0])
    K = 10
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(K - 1):
            clean()
        out, ok = clean()
        int(out[0, 0])
        best = min(best, (time.perf_counter() - t0) / K)
    if not bool(ok):
        raise BenchError(f"cc_clean reported ok = 0 at capacity {capacity}")
    record("cc_pallas_clean_ms", best * 1e3)
    print(f"# cc preproc_clean (ta_cc_clean, 3 passes, device-resident, "
          f"{H}x{W}): {best*1e3:.3f} ms", file=sys.stderr)
    return cc.unpack_page(out.cpu().numpy(), H, W)


def train_metric(B: int = 128, T: int = 512, S: int = 48, K: int = 20,
                 device=None):
    """CTC training throughput, the ocropus-rtrain equivalent (reference
    README.md:52-56): ``Trainer.step`` (BiLSTM forward + CTC loss +
    backward + clipped Adam) at a realistic line shape, K steps after one
    warm-up step. The reference's only published training number is ~12 h
    of CPU for the Salzinnes model's 54,500 single-line iterations
    (.MISSING_LARGE_BLOBS:1-2), ~1.26 line-updates/s. Returns the last
    loss."""
    codec = Codec()
    tr = Trainer(codec=codec, device=device)
    rng = np.random.default_rng(3)
    xs = (rng.random((B, T, NI)) < 0.1).astype(np.float32)
    labels = rng.integers(1, len(codec), (B, S)).astype(np.int32)
    args = (xs, np.full(B, T, np.int32), labels, np.full(B, S, np.int32))
    t0 = time.perf_counter()
    tr.step(*args, ground_weight=0.0)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(K):
        loss = tr.step(*args, ground_weight=0.0)
    dt = (time.perf_counter() - t0) / K
    record("train_line_updates_per_sec", B / dt)
    ref_rate = 54500 / (12 * 3600.0)
    print(f"# train step (B={B}, T={T}, ni={NI}, ns={NS}): {dt*1e3:.1f} "
          f"ms/step = {B/dt:.0f} line-updates/s (warmup {warm:.1f}s; "
          f"reference ocropus-rtrain ~{ref_rate:.2f} lines/s CPU -> the "
          f"54,500-iter Salzinnes workload is ~{54500/(B/dt):.0f}s of step "
          f"compute)", file=sys.stderr)
    return loss


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    host's processor on a CPU device."""
    if device.type != "cuda":
        return f"cpu {platform.processor() or platform.machine()}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _json_text(d) -> str:
    return json.dumps(d, sort_keys=True)


def check_batch(results, seq) -> None:
    """Raise unless the batch's JSON equals the sequential JSON ``seq``
    folio for folio."""
    got = [None if r is None else _json_text(r.json_dict) for r in results]
    bad = [i + 1 for i, (g, s) in enumerate(zip(got, seq)) if g != s]
    if len(got) != len(seq) or bad:
        raise BenchError(f"the batch's JSON differs from the sequential JSON "
                         f"at folios {bad} ({len(got)} of {len(seq)})")


def _reference_alignment(orig):
    """``perform_alignment`` with the reference's literal fill whatever
    backend the caller names (the CPU baseline's NW)."""
    def ref_nw_alignment(t, o, scoring_system=None, verbose=False,
                         backend="auto", strict=True, device=None):
        return orig(t, o, scoring_system=scoring_system, verbose=verbose,
                    backend="reference", strict=strict)

    return ref_nw_alignment


def cpu_baseline(pages, ocrs, n: int, device=None):
    """The CPU baseline on folios 1..n: the host pipeline with the numpy
    recognizer and the reference NW fill (``process``'s
    ``perform_alignment`` patched for the run, restored after it). Returns
    (the per-folio seconds, their JSON dicts)."""
    base_rec = baseline_recognizer()
    orig = proc_mod.perform_alignment
    proc_mod.perform_alignment = _reference_alignment(orig)
    times, out = [], []
    try:
        for i in range(1, n + 1):
            t0 = time.perf_counter()
            out.append(folio_flow(pages[i], ocrs[i], base_rec, "host",
                                  device))
            times.append(time.perf_counter() - t0)
    finally:
        proc_mod.perform_alignment = orig
    return times, out


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m text_alignment_tpu_torch.bench",
        description="folios/sec of the port on one CUDA card")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--folios", type=int, default=N_DEVICE_FOLIOS,
                    help="folios of the sequential and batched laps")
    ap.add_argument("--out", default=".",
                    help="directory of bench_last.json")
    args = ap.parse_args(argv)
    if args.folios < 1:
        ap.error("--folios must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = align_api.resolve_device(args.device)
    backend = DEVICE_BACKEND
    if backend not in proc_mod.BACKENDS:
        raise ValueError(f"TEXT_ALIGNMENT_TPU_BENCH_BACKEND={backend!r}: "
                         f"one of {proc_mod.BACKENDS}")
    METRICS.clear()
    _kernels.reset_launches()
    card = card_line(dev)
    print(f"# device: {dev}; {card}; backend {backend}", file=sys.stderr)

    NF = args.folios
    pages = [make_bench_page(BENCH_SEED + i) for i in range(NF + 1)]
    ocrs = [injected_ocr(p, 77 + i) for i, p in enumerate(pages)]
    dev_rec = device_recognizer(backend, dev)

    # warm-up on folio 0: the kernels' build (once per source hash) and
    # the first call of every path
    t0 = time.perf_counter()
    folio_flow(pages[0], ocrs[0], dev_rec, backend, dev)
    print(f"# device[{backend}] warmup (incl. kernel build/load): "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    # the first pass learned the recognizer's frame-bucket hint, so later
    # folios run other shapes: run them once before the timed laps
    t0 = time.perf_counter()
    folio_flow(pages[0], ocrs[0], dev_rec, backend, dev)
    print(f"# hint-shape warmup pass: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    t0 = time.perf_counter()
    for i in range(1, NF + 1):
        folio_flow(pages[i], ocrs[i], dev_rec, backend, dev)
    print(f"# rung-warming lap: {time.perf_counter()-t0:.1f}s wall",
          file=sys.stderr)

    t0 = time.perf_counter()
    seq = [_json_text(folio_flow(pages[i], ocrs[i], dev_rec, backend, dev))
           for i in range(1, NF + 1)]
    seq_dt = (time.perf_counter() - t0) / NF
    record("sequential_ms_per_folio", seq_dt * 1e3)
    print(f"# device[{backend}] sequential: {seq_dt*1e3:.0f} ms/folio",
          file=sys.stderr)

    # the batched stage-major pipeline (the production throughput path):
    # the same work as folio_flow, the OCR queued from the raster loop by
    # process_batch's own worker, alignment on the injected OCR streams
    folios = [(p.image, p.transcript) for p in pages[1:]]
    inj = ocrs[1:NF + 1]

    def batched_flow():
        pre = []
        worker = (PipelinedOCRWorker(dev_rec, NF)
                  if dev_rec.normalize_on_device else None)
        try:
            for image, angle, strips, peaks in raster_stream(
                    [p.image for p in pages[1:]], backend=backend,
                    device=dev):
                pre.append((image, angle, strips, peaks))
                if worker is not None:
                    worker.put([s.img for s in strips])
                else:
                    dev_rec.recognize_batch([s.img for s in strips])
        finally:
            if worker is not None:
                worker.abandon()
        if worker is not None:
            worker.rows()
        return process_batch(folios, None, backend=backend,
                             existing_ocr=inj, existing_pre=pre, device=dev)

    t0 = time.perf_counter()
    check_batch(batched_flow(), seq)
    print(f"# batched warm-up lap: {time.perf_counter()-t0:.1f}s wall",
          file=sys.stderr)
    dev_dt = float("inf")  # best of 3: the host clock is bursty
    for _ in range(3):
        t0 = time.perf_counter()
        results = batched_flow()
        dev_dt = min(dev_dt, (time.perf_counter() - t0) / NF)
        check_batch(results, seq)
    record("batched_ms_per_folio", dev_dt * 1e3)
    print(f"# batch guard: the batched JSON equals the sequential JSON on "
          f"all {NF} folios", file=sys.stderr)
    print(f"# device[{backend}] batched: {dev_dt*1e3:.0f} ms/folio "
          f"(best of 3)", file=sys.stderr)

    # CPU baseline: the same pages (1..NB) as the device laps, median of NB
    NB = min(N_BASELINE_FOLIOS, NF)
    times, _ = cpu_baseline(pages, ocrs, NB, dev)
    base_dt = float(np.median(times))
    print(f"# cpu baseline: {base_dt*1e3:.0f} ms/folio "
          f"(median of {NB}: "
          f"{['%.1fs' % t for t in times]})", file=sys.stderr)
    print(f"# absolute: batched {dev_dt*1e3:.1f} ms/folio, "
          f"sequential {seq_dt*1e3:.1f} ms/folio, "
          f"baseline {base_dt*1e3:.0f} ms/folio", file=sys.stderr)

    ocr_metrics(pages, dev_rec, backend)
    cc_pallas_metric(pages, dev)
    grid_sweep_metric(pages, ocrs, device=dev)
    train_metric(device=dev)
    lat8, thr8, raw8, _ = nw_gcups_stress(8191, dev)
    lat16, thr16, raw16, _ = nw_gcups_stress(16383, dev)
    record("nw_pipelined_gcups_8k", thr8)
    record("nw_pipelined_gcups_16k", thr16)
    record("nw_raw_gcups_8k", raw8)
    record("nw_raw_gcups_16k", raw16)
    print(f"# nw fill+traceback: {lat8:.2f} GCUPS @ 8192x8192, "
          f"{lat16:.2f} GCUPS @ 16384x16384 (single-shot, one host read)",
          file=sys.stderr)
    print(f"# nw pipelined throughput (depth {K_PIPELINED}): {thr8:.2f} "
          f"GCUPS @ 8192x8192, {thr16:.2f} GCUPS @ 16384x16384",
          file=sys.stderr)
    print(f"# nw raw fill compute (no traceback/download): "
          f"{raw8:.2f} GCUPS @ 8192x8192, {raw16:.2f} GCUPS @ "
          f"16384x16384", file=sys.stderr)

    folios_per_sec = 1.0 / dev_dt
    vs_baseline = base_dt / dev_dt
    record("folios_per_sec", folios_per_sec)
    missing = sorted(set(HIGHER_IS_BETTER) - set(METRICS))
    if missing:
        raise BenchError(f"metrics not recorded: {missing}")
    print(f"# metrics ({card}): "
          + ", ".join(f"{k}={METRICS[k]:.6g}" for k in HIGHER_IS_BETTER),
          file=sys.stderr)
    print(f"# kernel launches: {json.dumps(_kernels.launches)}",
          file=sys.stderr)
    regression_report(out_dir=args.out, card=card)
    print(json.dumps({
        "metric": "folios/sec",
        "value": round(folios_per_sec, 3),
        "unit": "folios/sec",
        "vs_baseline": round(vs_baseline, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
