"""Repo-wide test set-up: build the JAX package's native raster engine once,
before any test process starts.

``text_alignment_tpu/ops/host_native.py`` compiles ``native/raster.cpp``
on first use into ``~/.cache/text_alignment_tpu_native/raster_<tag>.so``
through one fixed temporary name. Test workers that start that build at
once on a cold cache overwrite or load one another's partial file, and the
one that loses skips every test gated on ``host_native.available()``. Here
the xdist controller (or a run without xdist) builds the library first,
through a name of its own process, so every worker finds it finished.

This module imports neither package: ``text_alignment_tpu`` imports JAX.
Any failure (no g++, no source) leaves the build to the loader, as before.
"""

import hashlib
import os
import subprocess

_REPO = os.path.dirname(os.path.abspath(__file__))


def native_target():
    """(source, library path) as host_native computes them: the source is
    ``TEXT_ALIGNMENT_TPU_NATIVE_SRC`` or ``native/raster.cpp`` of this
    repo, the library is named after the first 16 hex digits of the
    source's sha256."""
    src = (os.environ.get("TEXT_ALIGNMENT_TPU_NATIVE_SRC")
           or os.path.join(_REPO, "native", "raster.cpp"))
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    cache_dir = os.path.join(os.path.expanduser("~"), ".cache",
                             "text_alignment_tpu_native")
    return src, os.path.join(cache_dir, f"raster_{tag}.so")


def build_native():
    """Compile the raster engine where host_native looks for it, with its
    g++ flags, unless it is there. Returns the library's path, or None when
    the source or the compiler is missing or the build fails."""
    try:
        src, so_path = native_target()
        if os.path.exists(so_path):
            return so_path
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        try:
            subprocess.check_call(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", tmp, src],
                stderr=subprocess.DEVNULL,
            )
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return so_path
    except (OSError, subprocess.CalledProcessError):
        return None


def pytest_configure(config):
    if not hasattr(config, "workerinput"):  # the controller, not a worker
        build_native()
