"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source started together, and linked into one shared library
with a plain C interface, at the first CUDA use, and loaded with
``ctypes``. The library lands in ``build/torch_kernels/`` beside the
package, keyed by a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. Nothing is built when a
module is imported: the CPU tests import every module and there is no
``nvcc`` there.

Every C entry point launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code. A missing ``nvcc`` or a failed build raises too. Nothing
here falls back to anything.

``launches`` counts, per kernel, the launches its wrapper made: the proof
that a run went through the kernel and not through its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("lstm_scan.cu", "lineest_tail.cu", "lineest_full.cu",
           "nw_fill.cu", "nw_traceback.cu", "cc_filter.cu", "raster.cu")
HEADERS = ("lineest_tail.cuh",)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can use

launches = {"lstm_scan": 0, "lineest_tail": 0, "lineest_full": 0,
            "nw_fill": 0, "nw_fill_batched": 0, "nw_traceback": 0,
            "cc_filter": 0, "cc_table": 0, "cc_clean": 0,
            "raster_rotate_erode": 0}
build_seconds: float | None = None  # wall time of the last nvcc build

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(cand):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of text_alignment_tpu_torch cannot be built")
    return cand


def _source_paths():
    return [os.path.join(CSRC, s) for s in SOURCES]


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _source_paths() + [os.path.join(CSRC, s) for s in HEADERS]:
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libta_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Run the commands at once, wait for all, raise on the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(so_path: str) -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in _source_paths()]
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                  for src, obj in zip(_source_paths(), objs)])
        tmp = f"{so_path}.{tag}"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so_path)
    build_seconds = time.perf_counter() - t0


def lib():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not os.path.exists(so_path):
            _build(so_path)
        L = ctypes.CDLL(so_path)
        p, i = ctypes.c_void_p, ctypes.c_int
        L.ta_error_string.restype = ctypes.c_char_p
        L.ta_error_string.argtypes = [i]
        L.ta_lstm_scan.restype = i
        L.ta_lstm_scan.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        L.ta_lstm_scan_attrs.restype = i
        L.ta_lstm_scan_attrs.argtypes = [i, i, i, i, i, p]
        L.ta_lineest_tail_plan.restype = i
        L.ta_lineest_tail_plan.argtypes = [i, i, i, i, i, p]
        L.ta_lineest_tail.restype = i
        L.ta_lineest_tail.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p, p,
                                      p, i, p]
        L.ta_lineest_full_smem.restype = ctypes.c_size_t
        L.ta_lineest_full_smem.argtypes = [i, i, i]
        L.ta_lineest_full.restype = i
        L.ta_lineest_full.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, p,
                                      p, p, p, p, i, p]
        L.ta_nw_fill_smem.restype = ctypes.c_size_t
        L.ta_nw_fill_smem.argtypes = [i, i]
        L.ta_nw_fill_scratch_bytes.restype = ctypes.c_size_t
        L.ta_nw_fill_scratch_bytes.argtypes = [i, i, i, i]
        L.ta_nw_fill.restype = i
        L.ta_nw_fill.argtypes = [p, p, p, p, i, i, i, i, p, i, p]
        L.ta_nw_fill_batched.restype = i
        L.ta_nw_fill_batched.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                         i, i, i, i, i, p, i, p]
        L.ta_nw_group_attrs.restype = i
        L.ta_nw_group_attrs.argtypes = [i, i, i, i, p]
        L.ta_nw_traceback_batched.restype = i
        L.ta_nw_traceback_batched.argtypes = [p, p, p, p, i, i, i, i, p]
        L.ta_nw_tb_chase.restype = i
        L.ta_nw_tb_chase.argtypes = [p, i, i, p]
        L.ta_cc_band_rows.restype = i
        L.ta_cc_band_rows.argtypes = [i]
        L.ta_cc_scratch_ints.restype = ctypes.c_size_t
        L.ta_cc_scratch_ints.argtypes = [i, i]
        L.ta_cc_filter.restype = i
        L.ta_cc_filter.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        L.ta_cc_table.restype = i
        L.ta_cc_table.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        L.ta_cc_clean.restype = i
        L.ta_cc_clean.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                  i, p]
        L.ta_raster_band_rows.restype = i
        L.ta_raster_band_rows.argtypes = [i]
        L.ta_raster_rotate_erode.restype = i
        L.ta_raster_rotate_erode.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                             i, p]
        _lib = L
        return L


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().ta_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
