"""``BENCHMARK.json`` against the rules of its format that need no card."""

import copy

from benchmark import common, validate


def test_benchmark_json_is_valid():
    assert validate.problems(common.load_spec()) == []


def test_every_cell_reports_setup_and_its_metrics():
    spec = common.load_spec()
    for cell in spec["workloads"]:
        e2e, layers = common.cell_metrics(spec, cell["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layers
        for m in layers:
            assert m["moves"] in names


def test_the_validator_finds_faults():
    spec = common.load_spec()
    bad = copy.deepcopy(spec)
    bad["per_layer"][0]["unit"] = "tokens per second"
    bad["configs"].append(dict(bad["configs"][0], name="unused"))
    bad["per_layer"][0]["moves"] = "no_such_metric"
    out = validate.problems(bad)
    assert any("unit" in p for p in out)
    assert any("no cell uses it" in p for p in out)
    assert any("moves" in p for p in out)
