"""Checks of ``BENCHMARK.json`` that need no card: names and units in the
allowed characters, the keys of each
entry, every file a cell needs found by name, every per-layer metric's
``moves`` reported by each cell that reports it, every configuration
used by a cell. ``problems(spec)`` lists what is wrong."""

from __future__ import annotations

import os
import re

from . import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def problems(spec, root=common.ROOT):
    out = []
    if set(spec) != TOP:
        out.append(f"top-level keys {sorted(spec)}")
    if not (1 <= len(spec["paths"]) <= 16
            and all(PATH.match(p) and ".." not in p.split("/")
                    for p in spec["paths"])):
        out.append("paths")
    if not (1 <= len(spec["command"]) <= 32
            and all(_line(w) and not w.startswith("/")
                    for w in spec["command"])):
        out.append("command")
    if not (isinstance(spec["run_seconds"], int)
            and 1 <= spec["run_seconds"] <= 51):
        out.append("run_seconds")
    for group, keys in KEYS.items():
        names = [e.get("name") for e in spec[group]]
        if len(set(names)) != len(names):
            out.append(f"{group}: a name twice")
        for e in spec[group]:
            extra = set(e) - keys - ({"workloads"} if group in (
                "end_to_end", "per_layer") else set())
            if set(e) < keys or extra:
                out.append(f"{group} {e.get('name')}: keys {sorted(e)}")
            if not NAME.match(str(e.get("name", ""))):
                out.append(f"{group} {e.get('name')!r}: name")
    configs = {c["name"]: c for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    for c in spec["configs"]:
        if not (_line(c["source"]) and _line(c["why"])):
            out.append(f"config {c['name']}: source or why")
        if not c["file"].startswith(tuple(p + "/" for p in spec["paths"])):
            out.append(f"config {c['name']}: file outside paths")
        if not os.path.isfile(os.path.join(root, c["file"])):
            out.append(f"config {c['name']}: no file {c['file']}")
        if len(c["reduced"]) > 16 or not all(NAME.match(k)
                                             for k in c["reduced"]):
            out.append(f"config {c['name']}: reduced")
        if not any(w["config"] == c["name"] for w in spec["workloads"]):
            out.append(f"config {c['name']}: no cell uses it")
    pairs = set()
    here = os.path.join(root, "benchmark")
    for w in spec["workloads"]:
        if w["config"] not in configs or w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: config or chips")
        if not (NAME.match(w["traffic"]) and _line(w["why"])):
            out.append(f"cell {w['name']}: traffic or why")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"cell {w['name']}: config and traffic twice")
        pairs.add((w["config"], w["traffic"]))
        for sub in (f"traffic/{w['traffic']}.json",
                    f"limits/{w['name']}.json"):
            if not os.path.isfile(os.path.join(here, sub)):
                out.append(f"cell {w['name']}: no benchmark/{sub}")
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    if four > max(1, len(spec["workloads"]) // 4):
        out.append("too many cells on four chips")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                            "higher"):
            out.append(f"metric {m['name']}: unit or better")
        if m["source"] not in SOURCES:
            out.append(f"metric {m['name']}: source")
        if not all(x in cells for x in m.get("workloads", [])):
            out.append(f"metric {m['name']}: an unknown cell")
    for m in spec["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"metric {m['name']}: end-to-end source")
        if not (0 < m["bound"] <= 0.25):
            out.append(f"metric {m['name']}: bound")

    def reports(m, cell):
        return cell in m.get("workloads", list(cells))

    for m in spec["per_layer"]:
        if not _line(m["layer"]) or m["moves"] not in e2e:
            out.append(f"metric {m['name']}: layer or moves")
            continue
        for cell in cells:
            if reports(m, cell) and not reports(e2e[m["moves"]], cell):
                out.append(f"metric {m['name']}: cell {cell} does not "
                           f"report {m['moves']}")
        if not os.path.isfile(os.path.join(here, "layer_metrics",
                                           m["name"] + ".py")):
            out.append(f"metric {m['name']}: no reader")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            if m["unit"] != "%":
                out.append(f"metric {m['name']}: a share in %")
    for cell in cells:
        mine = [m for m in spec["end_to_end"] if reports(m, cell)]
        if len(mine) < 2 or not any(reports(m, cell)
                                    for m in spec["per_layer"]):
            out.append(f"cell {cell}: too few metrics")
    return out
