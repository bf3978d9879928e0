"""Where the time of the NW traceback and batched fill kernels goes, on one
CUDA card.

    python3 chip_nw_ablation.py [--parent TREE]

The batched fill: on ``chip_smoke.fill_cases``' two grid launches (the
chant grid's 729 rows, one 2400^2 launch of 243 rows), the kernel's launch
alone (no wrapper; CUDA events, the mean of 10 calls after a warm-up) at
its plan, forced to G = 1 (the plan's best run there), given the whole
bucket as every pair's extent (Nt = L, No = NoP) at the plan, and at every
(run, G) the group route is built for; with ``--parent TREE``, also TREE's
``ta_nw_fill_batched`` (one CTA a pair over the whole bucket, an older tree
of the port unpacked under ``build/``), whose pointer bytes must equal this
kernel's on every valid cell. This separates what the extent, the grouping
and the plan each give.

The traceback: builds ``text_alignment_tpu_torch/csrc/nw_traceback.cu`` as
it is and with ``-DTA_TB_STOP=n`` (1: every window staged on demand and
waited for, no prefetch; 2: only the first window staged, the walk runs on
over stale bytes, so it times the walk without staging; 3: the windows a
diagonal path would need staged one after another, no walk, so it times
staging alone) and with ``-DTA_TB_PROFILE`` (the kernel's own clock64()
cycles waiting for copies, walking, and in all), each into a library of its
own under ``build/ablation/``; with ``--parent TREE``, also TREE's
``nw_traceback.cu``, whose wire must equal this kernel's. The variants'
outputs are wrong: only their times mean anything. On
``chip_smoke.tb_cases``, phase 8's pointers (the seeded 4096² pair, the
8191² and 16383² pairs, one 2400² grid launch of 243 scoring rows), it
prints, per case: k (the longest walk), windows and misses, each variant's
ms (CUDA events, the mean of 10 calls after a warm-up), the profile's
shares, and the chain floor (k x one step of ``ta_nw_tb_chase``). Prints
the card line first. Needs a card and nvcc; exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import subprocess
import sys

import torch

import chip_ablation as ca
import chip_smoke as cs
from text_alignment_tpu_torch import _kernels
from text_alignment_tpu_torch.align import nw_kernel as nwk

VARIANTS = {"kernel": (), "no prefetch": ("-DTA_TB_STOP=1",),
            "walk only": ("-DTA_TB_STOP=2",),
            "staging only": ("-DTA_TB_STOP=3",),
            "profile": ("-DTA_TB_PROFILE",)}
SRC = os.path.join("text_alignment_tpu_torch", "csrc", "nw_traceback.cu")
FILL_SRC = os.path.join("text_alignment_tpu_torch", "csrc", "nw_fill.cu")


def build(parent: str | None) -> dict:
    """The variants' libraries, TREE's traceback as "parent" and TREE's
    fill as "parent fill" when given."""
    os.makedirs(ca.OUT, exist_ok=True)
    jobs = {name: ([*flags], os.path.join(_kernels.CSRC, "nw_traceback.cu"))
            for name, flags in VARIANTS.items()}
    if parent is not None:
        jobs["parent"] = ([], os.path.join(parent, SRC))
        jobs["parent fill"] = ([], os.path.join(parent, FILL_SRC))
    sos = {name: os.path.join(ca.OUT, f"tb{k}.so")
           for k, name in enumerate(jobs)}
    nvcc = _kernels._nvcc()
    _kernels._run_all([[nvcc, *_kernels.NVCC_FLAGS, *jobs[name][0], "-shared",
                        "-o", so, jobs[name][1]] for name, so in sos.items()])
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "parent fill":
            lib.ta_nw_fill_scratch_bytes.restype = ctypes.c_size_t
            lib.ta_nw_fill_scratch_bytes.argtypes = [i, i, i, i]
            lib.ta_nw_fill_batched.restype = i
            lib.ta_nw_fill_batched.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                               i, p, i, p]
        else:
            lib.ta_nw_traceback_batched.restype = i
            lib.ta_nw_traceback_batched.argtypes = [p, p, p, p, i, i, i, i, p]
        libs[name] = lib
    return libs


def parent_fill(lib, t, o, params):
    """A launch of TREE's ta_nw_fill_batched as its wrapper planned the
    grids: one CTA a pair of S = L lanes, the fewest lanes a thread that
    keep 1024 threads, per_pair and shared_feed, B transcript rows."""
    B, L, NoP = params.shape[0], t.shape[1], o.shape[1]
    dev = t.device
    tb = t.expand(B, L).contiguous()
    run = next(r for r in (1, 2, 4, 8, 16, 32) if L // r <= 1024)
    scratch = torch.empty(lib.ta_nw_fill_scratch_bytes(B, L, NoP, L),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((B, L + NoP - 1, L), dtype=torch.uint8, device=dev)

    def launch():
        ca.check(lib.ta_nw_fill_batched(
            tb.data_ptr(), o.data_ptr(), params.data_ptr(), out.data_ptr(), B,
            L, NoP, run, 1, 1, dev.index or 0, _kernels.stream_handle(dev), L,
            scratch.data_ptr()), "parent fill")
        return out
    return launch


def group_fill(t, o, params, nts, nos, plan):
    """A launch of this tree's group route at ``plan`` (run, G, threads)
    over the extents ``nts`` x ``nos`` (one entry each), no wrapper."""
    B, L, NoP = params.shape[0], t.shape[1], o.shape[1]
    dev = t.device
    sizes = torch.stack([nts, nos]).to(torch.int32).contiguous()
    out = torch.empty((B, L + NoP - 1, L), dtype=torch.uint8, device=dev)
    run, g, threads = plan
    lib = _kernels.lib()

    def launch():
        ca.check(lib.ta_nw_fill_batched(
            t.data_ptr(), o.data_ptr(), params.data_ptr(),
            sizes[0].data_ptr(), sizes[1].data_ptr(), out.data_ptr(), B, L,
            NoP, 1, 1, B, 1, run, g, threads, dev.index or 0,
            _kernels.stream_handle(dev), 0, None), "group fill")
        return out
    return launch


def fill_lines(libs, dev) -> None:
    """The batched fill's ms at both grid launches: TREE's kernel, the
    plan, G = 1, the whole bucket as the extent, and every (run, G)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    attrs = nwk.group_attrs(dev, True)
    for name, t, o, pr, nts, nos in itertools.islice(cs.fill_cases(dev), 2):
        B, L, NoP = pr.shape[0], t.shape[1], o.shape[1]
        Nt, No = int(nts[0]), int(nos[0])

        def plan(g=None, run=None, nt=Nt):
            return nwk.group_plan(B, nt, L, sms, attrs, run, g)

        full = torch.tensor([L], dtype=torch.int32, device=dev), torch.tensor(
            [NoP], dtype=torch.int32, device=dev)
        variants = {"plan": group_fill(t, o, pr, nts, nos, plan()),
                    "G = 1": group_fill(t, o, pr, nts, nos, plan(g=1)),
                    "whole bucket": group_fill(t, o, pr, *full,
                                               plan(nt=L))}
        if "parent fill" in libs:
            variants["parent"] = parent_fill(libs["parent fill"], t, o, pr)
        mine = variants["plan"]().clone()
        bn, bo = nts.expand(B), nos.expand(B)
        for v in ("G = 1", "whole bucket", "parent"):
            if v in variants and not cs.valid_equal(variants[v](), mine, bn,
                                                    bo):
                raise RuntimeError(f"{name}: {v} differs from the plan")
        del mine
        times = "; ".join(f"{v} {ca.time_ms(fn, 10):.4f}"
                          for v, fn in variants.items())
        print(f"nw_fill_batched {name} (B = {B}, {Nt} x {No} in L = {L}): "
              f"plan (run, G, threads) {plan()}, G = 1 {plan(g=1)}, whole "
              f"bucket {plan(nt=L)}; ms: {times}")
        sweep = []
        for run, g in nwk.GROUPS:
            p = plan(g=g, run=run)
            if p is not None:
                fn = group_fill(t, o, pr, nts, nos, p)
                sweep.append(f"({run}, {g}, {p[2]}) {ca.time_ms(fn, 5):.4f}")
        print(f"nw_fill_batched {name}: every (run, G, threads), ms: "
              + "; ".join(sweep))
        del variants


def walk(lib, packed, nts, nos, name: str):
    B, D, L = packed.shape
    wire = torch.empty((B, 3 + D + 1), dtype=torch.int32,
                       device=packed.device)
    ca.check(lib.ta_nw_traceback_batched(
        packed.data_ptr(), nts.data_ptr(), nos.data_ptr(), wire.data_ptr(),
        B, D, L, packed.device.index or 0,
        _kernels.stream_handle(packed.device)), name)
    return wire


def profile_text(wire) -> str:
    """Shares of the profile build's cycles, summed over the pairs."""
    k = wire[:, 0].long()
    rows = torch.arange(wire.shape[0], device=wire.device)
    wait, walk_, total, stage, segs = (
        wire[rows, 3 + k + j].double().sum().item() for j in range(5))
    return (f"profile: waiting {wait / total:.1%}, walking "
            f"{walk_ / total:.1%}, predicting and issuing prefetches "
            f"{stage / total:.1%}, the rest "
            f"{1 - (wait + walk_ + stage) / total:.1%} of "
            f"{total / wire.shape[0]:.0f} cycles a pair; "
            f"{segs / wire.shape[0]:.1f} walk segments a pair")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = argv[1]
    elif argv:
        print(f"unknown arguments {argv}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    dev = torch.device("cuda")
    libs = build(parent)
    fill_lines(libs, dev)
    step = cs.tb_step_ns(dev)
    print(f"walk step in shared memory: {step:.3f} ns (ta_nw_tb_chase)")
    for name, packed, nts, nos in cs.tb_cases(dev):
        wire = nwk.traceback_cuda(packed, nts, nos)
        if parent is not None:
            same = cs.wire_equal(walk(libs["parent"], packed, nts, nos,
                                      "parent"), wire)
            if not same:
                print(f"{name}: the parent's wire differs", file=sys.stderr)
                return 1
        times = "; ".join(
            f"{v} {ca.time_ms(lambda: walk(lib, packed, nts, nos, v), 10):.4f}"
            for v, lib in libs.items() if v != "parent fill")
        print(f"{name} (B = {packed.shape[0]}): {cs.tb_text(wire, step)}; "
              f"ms: {times}; "
              f"{profile_text(walk(libs['profile'], packed, nts, nos, 'p'))}")
        del packed
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
