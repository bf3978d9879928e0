"""The control of each cell on the card: the plain reference in the
program's place, one precision down (NW scores clamped to int8), at the
cell's own size and limits,
comes out not correct, while the program on the same seed comes out
correct. Run on a machine with a card:

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""

import shutil
import tempfile

import pytest

from benchmark import common

SEED = 2 ** 31 + 4242


def _cells():
    return [w["name"] for w in common.load_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_and_the_program_passes(cell):
    import importlib

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    spec = common.load_spec()
    _, config, traffic, limits = common.cell_parts(spec, cell)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        c = kind.Cell(config, traffic, SEED, device, workdir, False)
        c.setup()
        records = [dict(c.step(i), ok=True) for i in range(c.trace_items())]
        torch.cuda.synchronize(device)
        c.free()
        program = c.check(records)
        control = c.control()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
