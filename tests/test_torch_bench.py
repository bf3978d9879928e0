"""The port's bench (``text_alignment_tpu_torch/bench.py``) against the
repo-root ``bench.py`` on the CPU, on one bench page (seed 1235):

- the pages and the injected OCR are byte-identical;
- the CPU baseline's numpy recognizer, given the JAX bench's weights,
  decodes every strip of the page as the JAX one does, and the port's
  ``folio_flow(..., backend="host")`` gives the JAX bench's JSON;
- the baseline's patch routes ``process``'s NW through the reference
  fill, gives the host route's JSON and is undone afterwards;
- the 13 metric names and directions are those of ``bench.py``'s
  ``record`` calls (read with ``ast``);
- the regression report flags a change for the worse of 20% and not one
  of 10%, in both directions, skips the baseline's ``card`` and writes
  ``bench_last.json`` into the directory it is given;
- the secondary metrics at small sizes on ``device="cpu"`` record positive
  finite figures, and their alignments equal the JAX host fill's (the CC
  chain: the JAX host oracle's page);
- without a card ``main`` raises, and the module reads none of the JAX
  bench's fallback switches.
"""

import ast
import importlib.util
import json
import math
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from text_alignment_tpu.align.api import (
    perform_alignment as jax_perform_alignment)
from text_alignment_tpu.models.lstm_jax import init_bilstm, params_to_np
from text_alignment_tpu.ops import oracle as jax_oracle
from text_alignment_tpu.pipeline.preprocess import (
    identify_text_lines as jax_identify_text_lines,
    preprocess_images as jax_preprocess_images)
from text_alignment_tpu_torch import bench as tb
from text_alignment_tpu_torch.align import api as port_api

_REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = tb.BENCH_SEED + 1  # the first timed folio of both benches


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  _REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jb = _load_jax_bench()


def _boxes(chars):
    return [(c.char, tuple(c.ul), tuple(c.lr)) for c in chars]


@pytest.fixture(scope="module")
def pages():
    """(JAX page, port page, JAX OCR, port OCR) of folio SEED."""
    jp, tp = jb.make_bench_page(SEED), tb.make_bench_page(SEED)
    return jp, tp, jb.injected_ocr(jp, 78), tb.injected_ocr(tp, 78)


@pytest.fixture(scope="module")
def jax_weights():
    import jax

    return params_to_np(init_bilstm(jax.random.PRNGKey(0), 48, 100, 64))


@pytest.fixture(scope="module")
def host_json(pages, jax_weights):
    """The port's unpatched host-route JSON of the page."""
    _, tp, _, to = pages
    return tb.folio_flow(tp, to, tb.baseline_recognizer(jax_weights), "host",
                         "cpu")


def test_bench_page_and_ocr_equal_the_jax_bench(pages):
    jp, tp, jo, to = pages
    assert tp.image.dtype == jp.image.dtype
    assert tp.image.tobytes() == jp.image.tobytes()
    assert tp.transcript == jp.transcript
    assert _boxes(tp.char_boxes) == _boxes(jp.char_boxes)
    assert _boxes(to) == _boxes(jo)
    assert len(to) > 200


def test_baseline_weights_are_the_jax_bench_weights(jax_weights):
    from text_alignment_tpu_torch.models.lstm import init_params_seeded

    ours = init_params_seeded(0, 48, 100, 64)
    for direction in ("fwd", "bwd"):
        for k, v in jax_weights[direction].items():
            assert np.array_equal(ours[direction][k], v), (direction, k)
    assert np.array_equal(ours["W2"], jax_weights["W2"])


def test_baseline_recognizer_decodes_as_the_jax_one(pages, jax_weights):
    jp, tp, _, _ = pages
    image, eroded, _ = jax_preprocess_images(jp.image, backend="host")
    strips, _, _ = jax_identify_text_lines(image, eroded, backend="host",
                                           verbose=False)
    imgs = [s.img for s in strips]
    assert len(imgs) >= 8
    want = jb.baseline_recognizer().recognize_batch(imgs)
    got = tb.baseline_recognizer(jax_weights).recognize_batch(imgs)
    assert got == want
    assert tb.baseline_recognizer().recognize_batch(imgs[:2]) == want[:2]


def test_folio_flow_host_gives_the_jax_bench_json(pages, host_json):
    jp, _, jo, _ = pages
    want = jb.folio_flow(jp, jo, jb.baseline_recognizer(), backend="host")
    assert host_json["syl_boxes"]
    assert json.dumps(host_json, sort_keys=True) == json.dumps(
        want, sort_keys=True)


def test_cpu_baseline_runs_the_reference_fill_and_restores(
        pages, host_json, monkeypatch):
    _, tp, _, to = pages
    calls = []
    slow = port_api.fill_reference_slow

    def counted(*args, **kwargs):
        calls.append(1)
        return slow(*args, **kwargs)

    monkeypatch.setattr(port_api, "fill_reference_slow", counted)
    orig = tb.proc_mod.perform_alignment
    times, out = tb.cpu_baseline([None, tp], [None, to], 1, "cpu")
    assert len(times) == 1 and times[0] > 0
    assert calls == [1]
    assert tb.proc_mod.perform_alignment is orig
    assert json.dumps(out[0], sort_keys=True) == json.dumps(
        host_json, sort_keys=True)


def test_cpu_baseline_restores_after_a_failure(monkeypatch):
    orig = tb.proc_mod.perform_alignment

    def boom(*args, **kwargs):
        assert tb.proc_mod.perform_alignment is not orig
        raise RuntimeError("folio failed")

    monkeypatch.setattr(tb, "folio_flow", boom)
    with pytest.raises(RuntimeError, match="folio failed"):
        tb.cpu_baseline([None, None], [None, None], 1, "cpu")
    assert tb.proc_mod.perform_alignment is orig


def _recorded(path):
    """{metric: higher_is_better} of a file's ``record(...)`` calls; a name
    given by a variable is read from the tuples of the ``for`` loop that
    binds it (the grid's ``(key, label, t, o)`` rows)."""
    tree = ast.parse(path.read_text())
    loops = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Tuple):
            first = node.target.elts[0]
            if isinstance(first, ast.Name) and isinstance(node.iter,
                                                          ast.Tuple):
                loops[first.id] = [ast.literal_eval(row.elts[0])
                                   for row in node.iter.elts]
    out = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "record"):
            continue
        hib = True
        for kw in node.keywords:
            if kw.arg == "higher_is_better":
                hib = ast.literal_eval(kw.value)
        arg = node.args[0]
        names = ([arg.value] if isinstance(arg, ast.Constant)
                 else loops[arg.id])
        for name in names:
            out[name] = hib
    return out


def test_metric_names_and_directions_are_bench_pys():
    want = _recorded(_REPO / "bench.py")
    assert len(want) == 13
    assert tb.HIGHER_IS_BETTER == want


def test_record_takes_only_known_finite_positive_metrics(monkeypatch):
    monkeypatch.setattr(tb, "METRICS", {})
    tb.record("folios_per_sec", 3)
    assert tb.METRICS == {"folios_per_sec": 3.0}
    with pytest.raises(KeyError):
        tb.record("folios/sec", 1.0)
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(tb.BenchError):
            tb.record("cc_pallas_clean_ms", bad)


@pytest.mark.parametrize("name,factor,flagged", [
    ("folios_per_sec", 0.8, True),
    ("folios_per_sec", 0.9, False),
    ("folios_per_sec", 1.2, False),
    ("batched_ms_per_folio", 1.2, True),
    ("batched_ms_per_folio", 1.1, False),
    ("batched_ms_per_folio", 0.8, False),
])
def test_regression_report_flags_20_percent_worse(tmp_path, monkeypatch,
                                                  capsys, name, factor,
                                                  flagged):
    base = {"folios_per_sec": 40.0, "batched_ms_per_folio": 25.0,
            "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(base))
    now = {k: v for k, v in base.items() if k != "card"}
    now[name] *= factor
    now["train_line_updates_per_sec"] = 100.0  # not in the baseline
    monkeypatch.setattr(tb, "METRICS", now)
    out = tmp_path / "out"
    out.mkdir()
    flags = tb.regression_report(out_dir=str(out), baseline_path=str(path),
                                 card="a card, 1.00 W")
    assert flags == ([name] if flagged else [])
    err = capsys.readouterr().err
    assert "train_line_updates_per_sec" in err and "(new)" in err
    assert "#   card" not in err
    last = json.loads((out / "bench_last.json").read_text())
    assert last == {**now, "card": "a card, 1.00 W"}
    assert not (tmp_path / "bench_last.json").exists()


def test_regression_report_without_a_baseline_writes_last(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(tb, "METRICS", {"folios_per_sec": 2.0})
    assert tb.regression_report(out_dir=str(tmp_path),
                                baseline_path=str(tmp_path / "none")) == []
    assert json.loads((tmp_path / "bench_last.json").read_text()) == {
        "folios_per_sec": 2.0}


def test_shipped_baseline_is_an_h100_run_of_every_metric():
    base = json.loads(pathlib.Path(tb.BASELINE_PATH).read_text())
    assert set(base) == set(tb.HIGHER_IS_BETTER) | {"card"}
    assert base["card"].startswith("NVIDIA H100") and " W" in base["card"]
    for name in tb.HIGHER_IS_BETTER:
        assert math.isfinite(base[name]) and base[name] > 0, name


def _positive(*values):
    return all(math.isfinite(v) and v > 0 for v in values)


def test_nw_stress_on_cpu_aligns_as_the_host_fill(monkeypatch):
    monkeypatch.setattr(tb, "METRICS", {})
    lat, thr, raw, aligned = tb.nw_gcups_stress(127, device="cpu")
    assert _positive(lat, thr, raw)
    t, o = tb.stress_pair(127)
    assert aligned == jax_perform_alignment(t[:-1], o[:-1], backend="host")


def test_grid_sweep_on_cpu_aligns_as_the_host_fill(pages, monkeypatch):
    _, tp, _, to = pages
    monkeypatch.setattr(tb, "METRICS", {})
    small_page = types.SimpleNamespace(transcript=tp.transcript[:40])
    out = tb.grid_sweep_metric([None, small_page], [None, to[:40]], n=40,
                               device="cpu")
    assert set(out) == {"grid_chant_combos_per_sec",
                        "grid_2400_combos_per_sec"}
    assert set(tb.METRICS) == set(out)
    assert _positive(*tb.METRICS.values())
    ocr = "".join(c.char for c in tb.expand_abbreviations(list(to[:40])))
    rows = tb.scoring_grid()
    assert len(out["grid_chant_combos_per_sec"]) == len(rows) == 729
    for row, got in zip(rows, out["grid_chant_combos_per_sec"]):
        assert got == jax_perform_alignment(
            list(tp.transcript[:40]), list(ocr),
            scoring_system=list(map(int, row)), backend="host"), row
    big_t, big_o = (x[:-1] for x in tb.stress_pair(40))
    for row, got in list(zip(rows, out["grid_2400_combos_per_sec"]))[::27]:
        assert got == jax_perform_alignment(
            big_t, big_o, scoring_system=list(map(int, row)),
            backend="host"), row


def test_cc_metric_on_cpu_cleans_as_the_host_oracle(pages, monkeypatch):
    jp, tp, _, _ = pages
    monkeypatch.setattr(tb, "METRICS", {})
    got = tb.cc_pallas_metric([None, tp], device="cpu")
    assert _positive(tb.METRICS["cc_pallas_clean_ms"])
    img = jax_oracle.to_onebit(jp.image)
    want = jax_oracle.despeckle(img, 100)
    want = ~jax_oracle.despeckle(~want, 100)
    want = jax_oracle.remove_tall_ccs(want, 150)
    assert np.array_equal(got, want)


def test_train_metric_on_cpu(monkeypatch):
    monkeypatch.setattr(tb, "METRICS", {})
    loss = tb.train_metric(B=2, T=32, S=8, K=1, device="cpu")
    assert math.isfinite(loss)
    assert set(tb.METRICS) == {"train_line_updates_per_sec"}
    assert _positive(tb.METRICS["train_line_updates_per_sec"])


def test_batch_guard_refuses_a_different_folio():
    seq = [tb._json_text({"a": 1}), tb._json_text({"a": 2})]
    ok = [types.SimpleNamespace(json_dict={"a": 1}),
          types.SimpleNamespace(json_dict={"a": 2})]
    tb.check_batch(ok, seq)
    with pytest.raises(tb.BenchError, match=r"folios \[2\]"):
        tb.check_batch([ok[0], types.SimpleNamespace(json_dict={"a": 3})],
                       seq)
    with pytest.raises(tb.BenchError, match=r"folios \[1\]"):
        tb.check_batch([None, ok[1]], seq)
    with pytest.raises(tb.BenchError):
        tb.check_batch(ok[:1], seq)


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tb.main(["--out", str(tmp_path)])
    assert not (tmp_path / "bench_last.json").exists()


def _switches(path):
    return {n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and re.fullmatch(r"TEXT_ALIGNMENT_TPU_[A-Z0-9_]+", n.value)}


def test_bench_reads_no_fallback_switch():
    jax_switches = _switches(_REPO / "bench.py")
    assert {"TEXT_ALIGNMENT_TPU_BENCH_FORCE_CPU",
            "TEXT_ALIGNMENT_TPU_BENCH_NO_PROBE",
            "TEXT_ALIGNMENT_TPU_BENCH_BACKEND"} <= jax_switches
    assert _switches(pathlib.Path(tb.__file__)) == {
        "TEXT_ALIGNMENT_TPU_BENCH_BACKEND"}
