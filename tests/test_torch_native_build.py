"""The port's native build (ops/host_native.build_library) from several
processes at once on a cold build directory, as the test workers start it:
every process must load the library, and no temporary file may be left.
"""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import ctypes, os, sys, time
from text_alignment_tpu_torch.ops.host_native import build_library
src, build, go = sys.argv[1:4]
while not os.path.exists(go):
    time.sleep(0.001)
for k in range(4):  # four cold targets, the six processes in step
    so_path = os.path.join(build, f"answer{k}.so")
    build_library(src, so_path)
    print(ctypes.CDLL(so_path).ta_answer())
"""


def test_concurrent_native_builds_all_load(tmp_path):
    src = tmp_path / "answer.cpp"
    src.write_text('extern "C" int ta_answer() { return 42; }\n')
    build = str(tmp_path / "build")
    os.makedirs(build)
    go = str(tmp_path / "go")
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(src),
                               build, go], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(6)]
    open(go, "w").close()  # all six start their builds together
    results = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err
        assert out.split() == ["42"] * 4
    assert sorted(os.listdir(build)) == [f"answer{k}.so" for k in range(4)]
