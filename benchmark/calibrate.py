"""The readings that the limits of a cell are set from: the program's
numbers on many seeds, and the control's (the reference in the program's
place, one precision down) on the same, at the cell's own size, in one
process.

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...]
        [--items N]

Each seed builds the cell anew, runs ``--items`` items of its traffic
(default: the traced run's count) and prints one JSON line with the seed,
the program's numbers and the control's. The benchmark's own runs never
run it."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--items", type=int, default=None)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import importlib

    import torch

    from . import common, run

    run.cache_dirs()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = common.load_spec()
    cell, config, traffic, limits = common.cell_parts(spec, args.workload)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    print(f"# card: {run.card_line()}", file=sys.stderr, flush=True)
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="bench-")
        try:
            t0 = time.perf_counter()
            c = kind.Cell(config, traffic, seed, device, workdir, False)
            c.setup()
            n = args.items or c.trace_items()
            records = [dict(c.step(i), ok=True) for i in range(n)]
            torch.cuda.synchronize(device)
            c.free()
            prog = c.check(records)
            ctrl = c.control()
            print(json.dumps({"seed": seed, "program": prog,
                              "control": ctrl, "limits": limits,
                              "seconds": time.perf_counter() - t0,
                              "notes": c.notes(),
                              "log": getattr(c, "log", [])}), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
