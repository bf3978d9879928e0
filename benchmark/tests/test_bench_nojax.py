"""Nothing under benchmark/ imports JAX or the JAX package: every module's
imports are compared by their top-level name, whole."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "text_alignment_tpu"}


def modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    bad = sorted(set(top_names(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_the_port_is_not_taken_for_the_jax_package():
    assert "text_alignment_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "text_alignment_tpu" in FORBIDDEN
