"""How much of a step of the BiLSTM recurrence kernel is the h . Wh
product, on one CUDA card.

    python3 chip_lstm_ablation.py

Builds ``text_alignment_tpu_torch/csrc/lstm_scan.cu`` twice, as it is and
with ``-DTA_LSTM_NO_PRODUCT`` (the step skips h . Wh; its values are wrong,
only its time means anything), each into a library of its own under
``build/lstm_ablation/``, and times both with the planned batch tile on the
same seeded inputs (CUDA events, mean of 10 launches after one warm-up) at
the folio's shape (B = 12, T = 1536, ns = 100) and the gate strips'
(B = 96, T = 512). The kernel's time less the variant's is what the product
costs; the variant's is the cell update, the loads and the barrier. Prints
the card line, then one line per shape. Needs a card and nvcc; exits
non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from text_alignment_tpu_torch import _kernels
from text_alignment_tpu_torch.models import lstm as tl
from text_alignment_tpu_torch.models import lstm_kernel as lk

OUT = os.path.join(os.path.dirname(_kernels.BUILD_DIR), "lstm_ablation")
VARIANTS = {"kernel": (), "no product": ("-DTA_LSTM_NO_PRODUCT",)}
SHAPES = ((12, 1536), (96, 512))
NS, NI = 100, 48


def build() -> dict:
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(_kernels.CSRC, "lstm_scan.cu")
    sos = {name: os.path.join(OUT, f"variant{k}.so")
           for k, name in enumerate(VARIANTS)}
    nvcc = _kernels._nvcc()
    _kernels._run_all([[nvcc, *_kernels.NVCC_FLAGS, *VARIANTS[name],
                        "-shared", "-o", so, src]
                       for name, so in sos.items()])
    libs = {}
    for name, so in sos.items():
        L = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        L.ta_lstm_scan.restype = i
        L.ta_lstm_scan.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        libs[name] = L
    return libs


def time_ms(fn, n: int = 10) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    libs = build()
    tl.pin_float32()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    for B, T in SHAPES:
        p = tl.params_from_np(tl.init_params_np(rng, NI, NS, 29, 0.3), dev)
        xs = torch.from_numpy(
            rng.normal(0, 1, (B, T, NI)).astype(np.float32)).to(dev)
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        gx, whT, peep = tl.scan_inputs(p, xs, lens)
        out = torch.empty((2, T, B, NS), device=dev)
        bt = lk.card_plan(B, NS, dev)
        row = []
        for name, L in libs.items():

            def launch():
                _kernels.check(L.ta_lstm_scan(
                    gx.data_ptr(), whT.data_ptr(), peep.data_ptr(),
                    out.data_ptr(), T, B, NS, lk.quads(NS), bt,
                    lk.cluster_size(NS, bt), dev.index or 0, stream),
                    f"{name} launch")

            ms = time_ms(launch)
            row.append(f"{name} {ms:.3f} ms ({ms * 1e3 / T:.3f} us a step)")
        print(f"lstm_scan B={B} T={T} bt={bt}: " + "; ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
