"""What every cell of the benchmark shares: the spec (``BENCHMARK.json``),
the cell's configuration, traffic mix and limits found by name, seeds,
and the pages."""

from __future__ import annotations

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_parts(spec, cell_name, data_dir=HERE):
    """(cell, config, traffic, limits) of one cell of ``spec``; traffic
    mixes and limits are found by name under ``data_dir``."""
    cell = find(spec["workloads"], cell_name, "workload")
    entry = find(spec["configs"], cell["config"], "config")
    config = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(data_dir, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(data_dir, "limits", cell_name + ".json"))
    return cell, config, traffic, limits


def cell_metrics(spec, cell_name):
    """(end-to-end metrics, per-layer metrics) that ``cell_name`` reports:
    those that list it, and those that list no cells (every cell)."""
    def mine(m):
        return cell_name in m.get("workloads", [cell_name])

    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from the run's ``--seed`` and ``tags``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def make_pages(config, seed: int, n: int, tag: int = 2):
    """``n`` pages of the configuration's geometry, page i from its own
    seed (the run's seed, ``tag``, i)."""
    from .gen.synth import make_page

    return [make_page(rng(seed, tag, i), **config["page"]) for i in range(n)]


def injected_ocr(page, generator, sub_rate, del_rate):
    """An OCR stream of ``page`` with substitutions and deletions, spaces
    at the word gaps (the evaluation harness's injected OCR)."""
    from .gen.synth import corrupt_ocr, ocr_with_spaces

    return ocr_with_spaces(corrupt_ocr(generator, page.char_boxes,
                                       sub_rate=sub_rate, del_rate=del_rate))
