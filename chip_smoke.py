"""Smoke run of text_alignment_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero):
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build the CUDA kernels from text_alignment_tpu_torch/csrc/ with nvcc;
  3. the BiLSTM recurrence kernel against its plain version on the card, on
     the folio's own frames (B, T = t_max, ni = 48, ns = 100); bar 1e-4;
  4. the normalizer tail kernel against its plain version on the card, on
     the folio's own h-gauss output; bar: ink counts exact, center within
     one row, >= 99% of valid columns identical;
  5. the slice: process() on a full-size synthetic folio (2000 x 1600 px,
     11 lines, packed at B = 12, Hp = 96, Wp = 1536) with a random-weight
     .pyrnn.gz (ni = 48, ns = 100): one warm-up call, then five measured
     calls; both kernels' launch counts over those must be >= 1; median
     milliseconds of each stage and of the whole call;
  6. the same recognizer and page on the CPU (the plain versions) against
     the card: every line's decoded characters identical;
  7. nw_fill: the kernel against its plain version on a seeded 4096^2 pair
     (pointer bytes identical on every valid cell), its GCUPS at the
     bench's 8191^2 and 16383^2 pairs, perform_alignment(backend="device")
     against backend="host" at 16383^2 (aligned lists equal), and the
     device/host times of perform_alignment from 128^2 to 2048^2;
  8. nw_traceback: the kernel against its plain version on the phase-7
     pointers and on a mixed-length batch (ops[:k], k, xpt, ypt identical);
  9. nw_fill_batched: align_pairs(min_device_cells=0) on six pairs of one
     bucket against the host; align_grid over the 729-row scoring grid on
     the folio's transcript against its corrupted OCR and on a seeded
     2400^2 pair, combos/s, 27 sampled rows against the host fill; the
     kernel against its plain version on 16 rows at chant size;
  10. NW inside process(): a 6000 x 4000 px page of 30 lines whose pair
     passes auto_device_min_cells(), OCR injected; process(backend="hybrid")
     on the card launches nw_fill and nw_traceback and its JSON equals the
     same call on the CPU device (the host fill).
Then one JSON line with each kernel's launches (from its own path's run:
the folio for the OCR kernels, phase 10 for nw_fill and nw_traceback, the
2400^2 grid for nw_fill_batched), error and times, and last the device
JSON line. Weights and page are made from fixed seeds. Needs no
network and no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from text_alignment_tpu_torch import _kernels, _reuse
from text_alignment_tpu_torch.align import align_grid, perform_alignment
from text_alignment_tpu_torch.align import nw_kernel as nwk
from text_alignment_tpu_torch.align import nw_torch as nwt
from text_alignment_tpu_torch.models import lineest as tle
from text_alignment_tpu_torch.models import lstm as tl
from text_alignment_tpu_torch.models.lineest_kernel import (
    tail_cuda, tail_reference)
from text_alignment_tpu_torch.models.lstm_kernel import (
    bidir_scan_cuda, bidir_scan_reference)
from text_alignment_tpu_torch.models.recognizer import (
    SeqRecognizer, _unpack_bits)
from text_alignment_tpu_torch.pipeline import process, to_JSON_dict

NI, NS = 48, 100
LSTM_BAR = 1e-4
OCR_KERNELS = ("lstm_scan", "lineest_tail")
NW_ALPHABET = "abcdefgh "
DEFAULT_ROW = [8, -4, -7, -7, -3, 0, -1, -1]  # the reference's default


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


def make_folio():
    return _reuse.make_page(
        np.random.default_rng(2024), n_lines=11, words_per_line=4,
        H=2000, W=1600, char_h=66, char_w=36, gap=6, space_w=44,
        line_spacing=170, speckles=200, margin_x=60)


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


def phase_lstm(rec, fi):
    gx, whT, peep = tl.scan_inputs(rec.params, fi["frames"], fi["lengths"])
    got = bidir_scan_cuda(gx, whT, peep)
    ref = bidir_scan_reference(gx, whT, peep)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max().item())
    ms = cuda_ms(lambda: bidir_scan_cuda(gx, whT, peep), 20)
    plain_ms = cuda_ms(lambda: bidir_scan_reference(gx, whT, peep), 3)
    _, T, B, _ = gx.shape
    print(f"lstm_scan: B={B} T={T} ns={NS} max_abs_err={err:.3e} "
          f"(bar {LSTM_BAR}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    check(err <= LSTM_BAR, f"lstm_scan disagrees: {err} > {LSTM_BAR}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_tail(fi):
    args = (fi["sm"], fi["temp"], fi["hs"], fi["ws"], fi["k2"])
    c1, s1, n1 = tail_cuda(*args)
    c0, s0, n0 = tail_reference(*args)
    torch.cuda.synchronize()
    Wp = c1.shape[1]
    valid = torch.arange(Wp, device=c1.device)[None, :] < fi["ws"][:, None]
    d = (c1 - c0).abs()[valid]
    err = int(d.max().item()) if d.numel() else 0
    same = float((d == 0).float().mean().item()) if d.numel() else 1.0
    ms = cuda_ms(lambda: tail_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: tail_reference(*args), 5)
    B, Hp, _ = fi["sm"].shape
    print(f"lineest_tail: B={B} Hp={Hp} Wp={Wp} center max |d|={err} "
          f"identical columns {same:.5f} dcnt exact "
          f"{bool(torch.equal(n1, n0))} dsum max |d|="
          f"{int((s1 - s0).abs().max().item())} kernel {ms:.3f} ms "
          f"plain {plain_ms:.3f} ms")
    check(torch.equal(n1, n0), "lineest_tail: ink counts differ")
    check(err <= 1, f"lineest_tail: center off by {err} rows")
    check(same >= 0.99, f"lineest_tail: only {same:.4f} of columns agree")
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}


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
        timer = _reuse.stage_timer(enabled=True)
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


def phase_nw_fill(dev):
    """Phase 7: the fill kernel against its plain version at 4096², its
    GCUPS at the bench's 8191² and 16383² pairs, perform_alignment on the
    card against the host fill at 16383², and the host/device crossover of
    perform_alignment."""
    t, o = seeded_pair(4095, 4095, 7)
    tt, oo, nts, nos = nw_tensors([t], [o], dev)
    row = torch.tensor([DEFAULT_ROW], dtype=torch.int32, device=dev)
    got = nwk.fill_cuda(tt, oo, row)
    ref, plain_ms = timed_once(lambda: nwk.fill_reference(tt, oo, row))
    same = valid_equal(got, ref, nts, nos)
    ms = cuda_ms(lambda: nwk.fill_cuda(tt, oo, row), 5)
    print(f"nw_fill: 4096^2 pair, pointer bytes identical on valid cells "
          f"{same}; kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    check(same, "nw_fill disagrees with its plain version at 4096^2")
    for n in (8191, 16383):
        a, b = seeded_pair(n, n, n)
        ta, ob, _, _ = nw_tensors([a], [b], dev)
        f_ms = cuda_ms(lambda: nwk.fill_cuda(ta, ob, row), 3)
        print(f"nw_fill: {n}^2 pair (L = {ta.shape[1]}) kernel {f_ms:.3f} ms "
              f"= {(n + 1) ** 2 / f_ms / 1e6:.4f} GCUPS (cells Nt*No with "
              f"sentinels)")
    a, b = seeded_pair(16383, 16383, 16383)
    dev_al, dev_ms = wall_ms(lambda: perform_alignment(
        a, b, backend="device", device=dev))
    host_al, host_ms = wall_ms(lambda: perform_alignment(
        a, b, backend="host"))
    print(f"nw perform_alignment 16383^2: device {dev_ms:.1f} ms, host "
          f"{host_ms:.1f} ms, aligned lists equal {dev_al == host_al}")
    check(dev_al == host_al, "device alignment differs from the host's at "
          "16383^2")
    for n in (128, 256, 512, 1024, 2048):
        a, b = seeded_pair(n, n, n)
        perform_alignment(a, b, backend="device", device=dev)
        d_ms = min(wall_ms(lambda: perform_alignment(
            a, b, backend="device", device=dev))[1] for _ in range(3))
        h_ms = min(wall_ms(lambda: perform_alignment(
            a, b, backend="host"))[1] for _ in range(3))
        print(f"nw crossover {n}^2: device {d_ms:.3f} ms host {h_ms:.3f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}, got, nts, nos


def phase_nw_traceback(dev, packed, nts, nos):
    """Phase 8: the traceback kernel against its plain version on the
    phase-7 pointers and on a mixed-length batch of one bucket."""
    w1 = nwk.traceback_cuda(packed, nts, nos)
    w0, plain_ms = timed_once(
        lambda: nwk.traceback_reference(packed, nts, nos))
    same = wire_equal(w1, w0)
    ms = cuda_ms(lambda: nwk.traceback_cuda(packed, nts, nos), 10)
    pairs = [seeded_pair(1100 + 150 * k, 1900 - 140 * k, 50 + k)
             for k in range(6)]
    tt, oo, bn, bo = nw_tensors([p[0] for p in pairs], [p[1] for p in pairs],
                                dev)
    row = torch.tensor([DEFAULT_ROW], dtype=torch.int32, device=dev)
    bp = nwk.fill_batched_cuda(tt, oo, row)
    same_b = wire_equal(nwk.traceback_cuda(bp, bn, bo),
                        nwk.traceback_reference(bp, bn, bo))
    print(f"nw_traceback: 4096^2 path k={int(w1[0, 0])} wire identical "
          f"{same}; 6 mixed pairs of one bucket identical {same_b}; kernel "
          f"{ms:.3f} ms plain {plain_ms:.3f} ms")
    check(same and same_b, "nw_traceback disagrees with its plain version")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


def host_align(t, o, row6):
    return perform_alignment(t, o, scoring_system=list(map(int, row6)),
                             backend="host")


def phase_nw_batched(dev, page):
    """Phase 9: align_pairs on one bucket against the host; align_grid over
    the 729-row scoring grid at chant size and at 2400², a sample of rows
    against the host fill; the batched kernel against its plain version on
    16 rows at chant size. Returns the stats and the launches of the grid
    runs."""
    pairs = [seeded_pair(1100 + 150 * k, 1950 - 140 * k, 70 + k)
             for k in range(6)]
    buckets = {(nwt._bucket(len(t) + 1), nwt._bucket(len(o) + 1))
               for t, o in pairs}
    got = nwt.align_pairs(pairs, _reuse.resolve_scoring(None),
                          min_device_cells=0, device=dev)
    same = got == [perform_alignment(t, o, backend="host") for t, o in pairs]
    print(f"nw align_pairs: 6 pairs in buckets {sorted(buckets)} equal to "
          f"the host {same}")
    check(same and len(buckets) == 1, "align_pairs differs from the host")

    chant_ocr = _reuse.ocr_with_spaces(_reuse.corrupt_ocr(
        np.random.default_rng(5), page.char_boxes))
    chant = (list(page.transcript), [c.char for c in chant_ocr])
    grid = _reuse.scoring_grid()
    sample = np.random.default_rng(9).choice(len(grid), 27, replace=False)
    launches = {}
    for name, (t, o) in (("chant", chant),
                         ("2400", seeded_pair(2400, 2400, 2400))):
        align_grid(t, o, grid[:2], device=dev)  # warm-up
        _kernels.reset_launches()
        res, g_ms = wall_ms(lambda: align_grid(t, o, grid, device=dev))
        launches[name] = dict(_kernels.launches)
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
    for n in (50, 100, 200, 400):  # the grid's 40,000-cell threshold
        t, o = seeded_pair(n, n, n)
        align_grid(t, o, grid, device=dev)
        g_ms = wall_ms(lambda: align_grid(t, o, grid, device=dev))[1]
        h_ms = min(wall_ms(lambda: host_align(t, o, grid[0]))[1]
                   for _ in range(3))
        print(f"nw grid crossover {n}^2: 729 rows on the card {g_ms:.1f} ms, "
              f"729 host fills ~{729 * h_ms:.1f} ms (729 x one row)")

    t, o = chant
    tt, oo, nts, nos = nw_tensors([t], [o], dev)
    rows = np.concatenate([grid[sample[:16]], np.full((16, 2), -1)], axis=1)
    pr = torch.from_numpy(rows.astype(np.int32)).to(dev)
    tb = tt.expand(16, -1).contiguous()
    got = nwk.fill_batched_cuda(tb, oo, pr)
    ref, plain_ms = timed_once(lambda: nwk.fill_reference(tb, oo, pr))
    same = valid_equal(got, ref, nts.expand(16), nos.expand(16))
    ms = cuda_ms(lambda: nwk.fill_batched_cuda(tb, oo, pr), 10)
    print(f"nw_fill_batched: 16 rows at chant size (L = {tt.shape[1]}, "
          f"NoP = {oo.shape[1]}), per_pair + shared_feed, identical {same}; "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    check(same, "nw_fill_batched disagrees with its plain version")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}, launches


def make_big_page():
    """A synthetic page whose transcript x OCR passes the auto threshold:
    30 lines of 12 words on 6000 x 4000 px."""
    return _reuse.make_page(
        np.random.default_rng(77), n_lines=30, words_per_line=12, H=6000,
        W=4000, char_h=48, char_w=24, gap=4, space_w=30, line_spacing=190,
        speckles=300, margin_x=60)


def phase_nw_process():
    """Phase 10: process() on a page whose NW pair passes
    auto_device_min_cells(), OCR injected: on the card it must launch the
    fill and the traceback, and its JSON must equal the CPU device's."""
    page = make_big_page()
    ocr = _reuse.ocr_with_spaces(_reuse.corrupt_ocr(
        np.random.default_rng(6), page.char_boxes))
    cells = (len(page.transcript) + 1) * (len(ocr) + 1)
    check(cells >= _reuse.auto_device_min_cells(),
          f"page pair of {cells} cells is under the device threshold")

    process_json(page, ocr, "cuda")  # warm-up
    _kernels.reset_launches()
    timer = _reuse.stage_timer(enabled=True)
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


def main() -> int:
    phase_card()
    phase_build()
    tl.pin_float32()
    dev = torch.device("cuda")
    page = make_folio()
    image, eroded, _ = _reuse.preprocess_images(page.image, backend="hybrid")
    strips, _, _ = _reuse.identify_text_lines(image, eroded,
                                              backend="hybrid")
    inks = [s.img for s in strips]
    check(len(inks) >= 8, f"folio segmented into {len(inks)} lines only")
    codec = _reuse.Codec()
    params_np = peaky_params(0, len(codec))
    rec = SeqRecognizer(tl.params_from_np(params_np), codec,
                        normalize_on_device=True, device=dev)
    fi = folio_inputs(rec, inks, dev)
    stats = {"lstm_scan": phase_lstm(rec, fi), "lineest_tail": phase_tail(fi)}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "folio.pyrnn.gz")
        _reuse.save_pyrnn(path, params_np, codec)
        launches = phase_slice(page, path)

    gpu = phase_cpu_vs_cuda(params_np, codec, inks, fi)
    prof = profile_ocr(gpu, inks)
    print(f"ocr profile: device busy {prof[0]:.3f} ms of {prof[1]:.3f} ms "
          f"wall (table by kernel on stderr)")

    stats["nw_fill"], packed, nts, nos = phase_nw_fill(dev)
    stats["nw_traceback"] = phase_nw_traceback(dev, packed, nts, nos)
    del packed
    stats["nw_fill_batched"], grid_launches = phase_nw_batched(dev, page)
    nw_launches = phase_nw_process()
    # each kernel's launches come from its own path's run: the folio
    # (phase 5), process() on the large page (phase 10), the 2400^2 grid
    launches.update({k: nw_launches[k] for k in ("nw_fill", "nw_traceback")})
    launches["nw_fill_batched"] = grid_launches["2400"]["nw_fill_batched"]

    pallas = "text_alignment_tpu/align/nw_pallas.py"
    csrc = "text_alignment_tpu_torch/csrc"
    sources = {"lstm_scan": (f"{csrc}/lstm_scan.cu",
                             "text_alignment_tpu/models/lstm_pallas.py:175"),
               "lineest_tail": (
                   f"{csrc}/lineest_tail.cu",
                   "text_alignment_tpu/models/lineest_pallas.py:185"),
               "nw_fill": (f"{csrc}/nw_fill.cu", f"{pallas}:238"),
               "nw_fill_batched": (f"{csrc}/nw_fill.cu", f"{pallas}:444"),
               "nw_traceback": (f"{csrc}/nw_traceback.cu", f"{pallas}:733")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name], **stats[name]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
