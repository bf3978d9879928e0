"""The port's native build (ops/host_native.build_library) from several
processes at once on a cold build directory, as the test workers start it:
every process must load the library, and no temporary file may be left.
And the repo-root conftest.py, which builds the JAX package's native
library once before the test workers start, against that package's loader.
"""

import importlib.util
import os
import subprocess
import sys
import types

import pytest
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


def _load(path, name):
    """A fresh module object of the file ``path``, imported by path alone
    (the JAX package's ``__init__`` would import JAX)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _root_conftest():
    return _load(os.path.join(_REPO, "conftest.py"), "_root_conftest")


def _jax_loader():
    return _load(os.path.join(_REPO, "text_alignment_tpu", "ops",
                              "host_native.py"), "_jax_host_native")


class _Refused(Exception):
    pass


def _jax_target(monkeypatch):
    """(source, library path) of the JAX package's native loader: the
    output of the g++ call it would make on a cold cache, stopped there."""
    calls = []

    def refuse(cmd, **kw):
        calls.append(cmd)
        raise _Refused

    loader = _jax_loader()
    monkeypatch.setattr(loader.subprocess, "check_call", refuse)
    assert not loader.available()
    (cmd,) = calls
    out = cmd[cmd.index("-o") + 1]
    assert out.endswith(".tmp") and cmd[-1] == loader._SRC
    return loader._SRC, out[:-len(".tmp")], cmd


@pytest.mark.parametrize("override", [False, True])
def test_repo_conftest_builds_where_the_jax_loader_looks(
        tmp_path, monkeypatch, override):
    """The repo-root conftest's source, library path and g++ flags are the
    JAX package's host_native's, with and without
    TEXT_ALIGNMENT_TPU_NATIVE_SRC."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if override:
        src = tmp_path / "moved" / "raster.cpp"
        src.parent.mkdir()
        src.write_text(open(os.path.join(_REPO, "native", "raster.cpp"))
                       .read() + "\n// moved\n")
        monkeypatch.setenv("TEXT_ALIGNMENT_TPU_NATIVE_SRC", str(src))
    else:
        monkeypatch.delenv("TEXT_ALIGNMENT_TPU_NATIVE_SRC", raising=False)
    jax_src, jax_so, jax_cmd = _jax_target(monkeypatch)
    hook = _root_conftest()
    assert hook.native_target() == (jax_src, jax_so)
    assert jax_so.startswith(str(tmp_path / "home" / ".cache"))
    calls = []
    monkeypatch.setattr(hook.subprocess, "check_call",
                        lambda cmd, **kw: calls.append(cmd))
    hook.build_native()
    (cmd,) = calls
    out = cmd.index("-o") + 1
    assert cmd[:out] + cmd[out + 1:] == jax_cmd[:out] + jax_cmd[out + 1:]
    assert cmd[out] != jax_cmd[out]  # a temporary name of its own


def test_repo_conftest_build_is_what_the_jax_loader_loads(
        tmp_path, monkeypatch):
    """The controller's pytest_configure builds the library once, leaves
    no temporary file, and the JAX loader then loads it without compiling;
    a worker's pytest_configure builds nothing."""
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("TEXT_ALIGNMENT_TPU_NATIVE_SRC", raising=False)
    hook = _root_conftest()
    worker = types.SimpleNamespace(workerinput={"workerid": "gw0"})
    hook.pytest_configure(worker)
    assert not home.exists()
    hook.pytest_configure(types.SimpleNamespace())
    src, so_path = hook.native_target()
    assert os.listdir(os.path.dirname(so_path)) == [
        os.path.basename(so_path)]
    built = os.stat(so_path).st_mtime_ns
    assert hook.build_native() == so_path  # there already: no rebuild
    assert os.stat(so_path).st_mtime_ns == built

    loader = _jax_loader()

    def refuse(cmd, **kw):
        raise AssertionError("the JAX loader compiled: " + " ".join(cmd))

    monkeypatch.setattr(loader.subprocess, "check_call", refuse)
    assert loader.available(), loader._load_error
    assert loader._SRC == src


@pytest.mark.parametrize("missing", ["source", "compiler"])
def test_repo_conftest_fails_soft(tmp_path, monkeypatch, missing):
    """No source or no g++: the hook returns None, raises nothing and
    leaves no file behind."""
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    if missing == "source":
        monkeypatch.setenv("TEXT_ALIGNMENT_TPU_NATIVE_SRC",
                           str(tmp_path / "absent.cpp"))
    else:
        monkeypatch.delenv("TEXT_ALIGNMENT_TPU_NATIVE_SRC", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    hook = _root_conftest()
    assert hook.build_native() is None
    hook.pytest_configure(types.SimpleNamespace())
    cache = home / ".cache" / "text_alignment_tpu_native"
    assert not cache.exists() or os.listdir(cache) == []
