"""Where the time of the CC band kernel and of the full chain's fused pass
goes, on one CUDA card.

    python3 chip_ablation.py

Builds ``text_alignment_tpu_torch/csrc/cc_filter.cu`` as it is and with
``-DTA_CC_STOP=n`` (the band kernel returns after step n of its source
note: 2 the counts and the look-back, 3 the decode, 4 the band's union, 6
the write-out, 8 the merge too; the resolve and paint kernels return at
once), and ``csrc/lineest_full.cu`` (with ``lineest_tail.cu``) as it is and
with ``-DTA_FULL_NO_V`` or ``-DTA_FULL_NO_H`` (the fused pass skips the
v-gauss or the h-gauss), each into a library of its own under
``build/ablation/``. The variants' outputs are wrong: only their times mean
anything. Times one despeckle pass (black) and one white pass of the
filter on the binarized batch folio (seed 3000, 2000 x 1600) and the full
chain on the folio's packed strips (B = 12, Hp = 96, Wp = 1536), CUDA
events, the mean of 20 calls after one warm-up. Prints the card line, then
one line per kernel. Needs a card and nvcc; exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from text_alignment_tpu_torch import _kernels

OUT = os.path.join(os.path.dirname(_kernels.BUILD_DIR), "ablation")
CC_VARIANTS = {"pass": (), "stop 2": ("-DTA_CC_STOP=2",),
               "stop 3": ("-DTA_CC_STOP=3",), "stop 4": ("-DTA_CC_STOP=4",),
               "stop 6": ("-DTA_CC_STOP=6",), "stop 8": ("-DTA_CC_STOP=8",)}
FULL_VARIANTS = {"chain": (), "no v-gauss": ("-DTA_FULL_NO_V",),
                 "no h-gauss": ("-DTA_FULL_NO_H",)}


def build(variants: dict, sources, tag: str) -> dict:
    os.makedirs(OUT, exist_ok=True)
    srcs = [os.path.join(_kernels.CSRC, s) for s in sources]
    sos = {name: os.path.join(OUT, f"{tag}{k}.so")
           for k, name in enumerate(variants)}
    nvcc = _kernels._nvcc()
    _kernels._run_all([[nvcc, *_kernels.NVCC_FLAGS, *variants[name],
                        "-shared", "-o", so, *srcs]
                       for name, so in sos.items()])
    return {name: ctypes.CDLL(so) for name, so in sos.items()}


def time_ms(fn, n: int = 20) -> float:
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


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def cc_line(libs: dict, dev) -> None:
    import chip_smoke as cs
    from text_alignment_tpu_torch.ops import cc
    from text_alignment_tpu_torch.pipeline import device_raster
    from text_alignment_tpu_torch.pipeline.preprocess import PreprocParams

    packed, (H, W) = device_raster._binarize_pack(
        cs.make_batch_folio(3000).image)
    page = torch.from_numpy(packed).to(dev)
    Wq = page.shape[1]
    out = torch.empty_like(page)
    ok = torch.empty(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    thresh = PreprocParams().despeckle_amt
    p, i = ctypes.c_void_p, ctypes.c_int
    for mode, label in ((cc.MODE_BLACK, "black"), (cc.MODE_WHITE, "white")):
        row = []
        for name, L in libs.items():
            L.ta_cc_scratch_ints.restype = ctypes.c_size_t
            L.ta_cc_scratch_ints.argtypes = [i, i]
            L.ta_cc_filter.restype = i
            L.ta_cc_filter.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
            scratch = torch.empty(L.ta_cc_scratch_ints(H, cc.MAX_RUNS),
                                  dtype=torch.int32, device=dev)

            def launch():
                check(L.ta_cc_filter(page.data_ptr(), out.data_ptr(),
                                     ok.data_ptr(), scratch.data_ptr(), H, Wq,
                                     W, thresh, mode, 0, cc.MAX_RUNS,
                                     dev.index or 0, stream), name)

            row.append(f"{name} {time_ms(launch):.4f} ms")
        print(f"cc_filter {label} pass, {H} x {W} page: " + "; ".join(row))


def full_line(libs: dict, dev) -> None:
    import chip_smoke as cs
    from text_alignment_tpu_torch.models import lstm as tl
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
    from text_alignment_tpu_torch.pipeline.preprocess import (
        identify_text_lines, preprocess_images)

    page = cs.make_folio()
    image, eroded, _ = preprocess_images(page.image, backend="hybrid")
    strips, _, _ = identify_text_lines(image, eroded, backend="hybrid")
    codec = Codec()
    rec = SeqRecognizer(tl.params_from_np(cs.peaky_params(0, len(codec))),
                        codec, normalize_on_device=True, device=dev)
    fi = cs.folio_inputs(rec, [s.img for s in strips], dev)
    (temp, w0, k1, hs, ws, k2), _ = cs.full_inputs(fi["packed_meta"], dev)
    B, Hp, Wp = temp.shape
    K1, K2 = k1.shape[1], k2.shape[1]
    bufs = [torch.empty((B, Hp, Wp), device=dev) for _ in range(2)]
    outs = [torch.empty((B, Wp), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    row = []
    for name, L in libs.items():
        L.ta_lineest_full.restype = i
        L.ta_lineest_full.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, p,
                                      p, p, p, i, p]

        def launch():
            check(L.ta_lineest_full(
                temp.data_ptr(), w0.data_ptr(), k1.data_ptr(), hs.data_ptr(),
                ws.data_ptr(), k2.data_ptr(), B, Hp, Wp, K1, K2,
                bufs[0].data_ptr(), bufs[1].data_ptr(),
                *(t.data_ptr() for t in outs), dev.index or 0, stream), name)

        row.append(f"{name} {time_ms(launch):.4f} ms")
    print(f"lineest_full B={B} Hp={Hp} Wp={Wp} K1={K1}: " + "; ".join(row))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    dev = torch.device("cuda")
    cc_line(build(CC_VARIANTS, ("cc_filter.cu",), "cc"), dev)
    full_line(build(FULL_VARIANTS, ("lineest_full.cu", "lineest_tail.cu"),
                    "full"), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
