"""Where the time of the CC band kernel, the full chain's fused pass and
the normalizer tail goes, on one CUDA card.

    python3 chip_ablation.py [--parent TREE]

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
events, the mean of 20 calls after one warm-up.

The tail: builds ``csrc/lineest_tail.cu`` alone and, with ``--parent
TREE``, TREE's ``lineest_tail.cu`` (an older tree of the port unpacked
under ``build/``); on the folio's strips and on chip_smoke's gate strips
(B = 96, Hp = 32, Wp = 512), each library's outputs against the plain
version bit for bit, its launch alone in turns (parent, this, this,
parent; CUDA events, the mean of 20 calls after a warm-up), and the device
time of each of its launches (torch.profiler, chip_smoke.launch_split);
and ptxas's registers and spills for this tree's passes.

Prints the card line, then one line per kernel. Needs a card and nvcc;
exits non-zero without a card.
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
    from text_alignment_tpu_torch.pipeline.preprocess import PreprocParams

    packed, (H, W) = cs.binarize_pack(cs.make_batch_folio(3000).image)
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
    keys = torch.empty((B, Wp), dtype=torch.int64, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    row = []
    for name, L in libs.items():
        L.ta_lineest_full.restype = i
        L.ta_lineest_full.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, p,
                                      p, p, p, p, i, p]

        def launch():
            check(L.ta_lineest_full(
                temp.data_ptr(), w0.data_ptr(), k1.data_ptr(), hs.data_ptr(),
                ws.data_ptr(), k2.data_ptr(), B, Hp, Wp, K1, K2,
                bufs[0].data_ptr(), bufs[1].data_ptr(), keys.data_ptr(),
                *(t.data_ptr() for t in outs), dev.index or 0, stream), name)

        row.append(f"{name} {time_ms(launch):.4f} ms")
    print(f"lineest_full B={B} Hp={Hp} Wp={Wp} K1={K1}: " + "; ".join(row))


def ptxas_report(src: str) -> str:
    """Registers, stack and spills of each kernel in ``src``, from nvcc's
    ``-Xptxas -v`` report."""
    obj = os.path.join(OUT, "ptxas.o")
    out = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas",
                          "-v", "-c", src, "-o", obj], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode, f"nvcc -Xptxas -v {src}")
    lines, name = [], None
    for line in out.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return "; ".join(lines)


def tail_launchers(libs: dict, args, dev) -> dict:
    """A launch of each library's ta_lineest_tail on ``args``, over buffers
    held by the closure; "parent" takes the older signature (no keys)."""
    sm, temp, hs, ws, k2 = args
    B, Hp, Wp = sm.shape
    K2 = k2.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    launchers = {}
    for name, L in libs.items():
        scratch = torch.empty((B, Hp, Wp), device=dev)
        keys = torch.empty((B, Wp), dtype=torch.int64, device=dev)
        outs = [torch.empty((B, Wp), dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev)]
        bufs = [scratch] + ([] if name == "parent" else [keys]) + outs
        L.ta_lineest_tail.restype = i
        L.ta_lineest_tail.argtypes = [p] * 5 + [i] * 4 + [p] * len(bufs) + [
            i, p]

        def launch(L=L, bufs=bufs, outs=outs, name=name):
            check(L.ta_lineest_tail(
                *(t.data_ptr() for t in args), B, Hp, Wp, K2,
                *(t.data_ptr() for t in bufs), dev.index or 0, stream), name)
            return outs

        launchers[name] = launch
    return launchers


def tail_line(parent: str | None, dev) -> None:
    import chip_smoke as cs
    from text_alignment_tpu_torch.models import lstm as tl
    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.lineest_kernel import tail_reference
    from text_alignment_tpu_torch.models.recognizer import SeqRecognizer
    from text_alignment_tpu_torch.pipeline.preprocess import (
        identify_text_lines, preprocess_images)

    src = os.path.join(_kernels.CSRC, "lineest_tail.cu")
    print(f"lineest_tail ptxas: {ptxas_report(src)}")
    libs = build({"kernel": ()}, ("lineest_tail.cu",), "tail")
    if parent is not None:
        so = os.path.join(OUT, "tail_parent.so")
        _kernels._run_all([[_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                            "-shared", "-o", so, os.path.join(
                                parent, "text_alignment_tpu_torch", "csrc",
                                "lineest_tail.cu")]])
        libs["parent"] = ctypes.CDLL(so)
    page = cs.make_folio()
    image, eroded, _ = preprocess_images(page.image, backend="hybrid")
    strips, _, _ = identify_text_lines(image, eroded, backend="hybrid")
    codec = Codec()
    rec = SeqRecognizer(tl.params_from_np(cs.peaky_params(0, len(codec))),
                        codec, normalize_on_device=True, device=dev)
    cases = {"folio": rec._pack_strips([s.img for s in strips])[0],
             "gate": rec._pack_strips(cs.gate_strips())[0]}
    for case, meta in cases.items():
        args = cs.tail_inputs(meta, dev)
        B, Hp, Wp = args[0].shape
        launchers = tail_launchers(libs, args, dev)
        ref = tail_reference(*args)
        for name, launch in launchers.items():
            got = launch()
            torch.cuda.synchronize()
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise RuntimeError(f"{name} tail differs from the plain "
                                   f"version on the {case} strips")
        order = (["parent", "kernel", "kernel", "parent"] if parent
                 else ["kernel", "kernel"])
        row = [f"{name} {time_ms(launchers[name]):.4f} ms" for name in order]
        print(f"lineest_tail {case} strips B={B} Hp={Hp} Wp={Wp} "
              f"K2={args[4].shape[1]}: outputs identical to the plain "
              f"version for {list(launchers)}; launch alone: "
              + "; ".join(row))
        for name, launch in launchers.items():
            cs.launch_split(f"lineest_tail {name} {case}", launch)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = argv[1]
    elif argv:
        print(f"unknown arguments {argv} (only --parent TREE)",
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
    tail_line(parent, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
