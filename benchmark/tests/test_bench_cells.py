"""Whole runs of each kind of cell on the CPU at a tiny size, past the
harness's look for a card: a sound run comes out correct, and a run with
the timed path broken underneath comes out not correct, once for each
fault the cell can have (an answer altered where it is made; no cell
trains, so no state can be left unchanged or a batch halved, and one card
runs every cell, so no exchange between cards can be left out)."""

import copy
import json
import time

import pytest
import torch

from benchmark import common, run

DATA = common.os.path.join(common.HERE, "tests", "data")
SEED = 2 ** 32 + 99
KINDS = {"grid": "grid_combos_per_s"}


def tiny_spec(kind):
    """BENCHMARK.json with a cell ``tiny.<kind>`` of the tiny page and the
    kind's tiny traffic, reporting the kind's metrics."""
    spec = copy.deepcopy(common.load_spec())
    spec["configs"].append({"name": "tiny", "source": "tests",
                            "file": "benchmark/tests/data/tiny.json",
                            "reduced": [], "why": "tests"})
    cell = f"tiny.{kind}"
    spec["workloads"].append({"name": cell, "config": "tiny",
                              "traffic": f"{kind}_tiny", "chips": 1,
                              "why": "tests"})
    if not any(m["name"] == KINDS[kind] for m in spec["end_to_end"]):
        spec["end_to_end"].append({"name": KINDS[kind], "unit": "u",
                                   "better": "higher", "bound": 0.1,
                                   "source": "host_clock", "workloads": []})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == KINDS[kind] or m.get("moves") == KINDS[kind]:
            m["workloads"] = m.get("workloads", []) + [cell]
    return spec, cell


def run_tiny(kind, trace=0, seconds=0.5):
    spec, cell = tiny_spec(kind)
    args = run.parse_args(["--workload", cell, "--seed", str(SEED),
                           "--seconds", str(seconds), "--trace",
                           str(trace)])
    res = run.run_cell(args, torch.device("cpu"), spec,
                       t_process=time.perf_counter(), data_dir=DATA)
    json.dumps(res)
    return res


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sound_run_is_correct(kind):
    res = run_tiny(kind)
    assert res["correct"], res["limits"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {KINDS[kind], "setup_s"}
    assert list(res)[-1] == "limits"


def test_traced_run_reports_the_layers():
    res = run_tiny("grid", trace=1)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res
    assert "mfu.grid" in res["metrics"]


def test_altered_alignment_fails_the_grid(monkeypatch):
    from text_alignment_tpu_torch.align import nw_torch

    orig = nw_torch.align_grid

    def broken(*a, **k):
        out = orig(*a, **k)
        return [(t, ["q"] + list(o[1:])) for t, o in out]

    monkeypatch.setattr(nw_torch, "align_grid", broken)
    res = run_tiny("grid")
    assert not res["correct"]
    assert res["limits"]["grid_rows_diff"]["value"] > 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_control_runs_on_the_cpu(kind):
    """The control's path end to end (on the CPU TF32 changes nothing, so
    only the card can show that it fails)."""
    import importlib
    import shutil
    import tempfile

    spec, cell = tiny_spec(kind)
    _, config, traffic, limits = common.cell_parts(spec, cell, DATA)
    mod = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    workdir = tempfile.mkdtemp()
    try:
        c = mod.Cell(config, traffic, SEED, torch.device("cpu"), workdir,
                     False)
        c.setup()
        recs = [dict(c.step(i), ok=True) for i in range(c.trace_items())]
        c.free()
        c.check(recs)
        control = c.control()
    finally:
        shutil.rmtree(workdir)
    assert set(control) == set(limits)
