"""Where the time of the NW traceback kernel goes, on one CUDA card.

    python3 chip_nw_ablation.py [--parent TREE]

Builds ``text_alignment_tpu_torch/csrc/nw_traceback.cu`` as it is and with
``-DTA_TB_STOP=n`` (1: every window staged on demand and waited for, no
prefetch; 2: only the first window staged, the walk runs on over stale
bytes, so it times the walk without staging; 3: the windows a diagonal
path would need staged one after another, no walk, so it times staging
alone) and with ``-DTA_TB_PROFILE`` (the kernel's own clock64() cycles
waiting for copies, walking, and in all), each into a library of its own
under ``build/ablation/``; with ``--parent TREE``, also TREE's
``nw_traceback.cu`` (an older tree of the port unpacked under ``build/``),
whose wire must equal this kernel's. The variants' outputs are wrong: only
their times mean anything. On ``chip_smoke.tb_cases``, phase 8's pointers
(the seeded 4096² pair, the 8191² and 16383² pairs, one 2400² grid launch
of 327 scoring rows), it prints, per case: k (the longest walk), windows and
misses, each variant's ms (CUDA events, the mean of 10 calls after a
warm-up), the profile's shares, and the chain floor (k x one step of
``ta_nw_tb_chase``). Prints the card line first. Needs a card and nvcc;
exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
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


def build(parent: str | None) -> dict:
    """The variants' libraries, TREE's kernel as "parent" when given."""
    os.makedirs(ca.OUT, exist_ok=True)
    jobs = {name: ([*flags], os.path.join(_kernels.CSRC, "nw_traceback.cu"))
            for name, flags in VARIANTS.items()}
    if parent is not None:
        jobs["parent"] = ([], os.path.join(parent, SRC))
    sos = {name: os.path.join(ca.OUT, f"tb{k}.so")
           for k, name in enumerate(jobs)}
    nvcc = _kernels._nvcc()
    _kernels._run_all([[nvcc, *_kernels.NVCC_FLAGS, *jobs[name][0], "-shared",
                        "-o", so, jobs[name][1]] for name, so in sos.items()])
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ta_nw_traceback_batched.restype = i
        lib.ta_nw_traceback_batched.argtypes = [p, p, p, p, i, i, i, i, p]
        libs[name] = lib
    return libs


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
            for v, lib in libs.items())
        print(f"{name} (B = {packed.shape[0]}): {cs.tb_text(wire, step)}; "
              f"ms: {times}; "
              f"{profile_text(walk(libs['profile'], packed, nts, nos, 'p'))}")
        del packed
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
