"""One run of one cell of the benchmark of ``text_alignment_tpu_torch`` on
the CUDA cards of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``benchmark/configs/``) and a traffic
mix (``benchmark/traffic/<mix>.json``, whose ``kind`` names the generator
in ``benchmark/kinds/``); its limits are ``benchmark/limits/<cell>.json``
and each per-layer metric is read by ``benchmark/layer_metrics/<name>.py``.

Set-up makes the inputs and the weights from ``--seed``, builds the
program's objects and runs every shape of the cell once. The window then
runs the traffic for ``--seconds``; with ``--trace 1`` ``torch.profiler``
records the traced items (the card's events and the host's, the program's
``ta.`` spans among them), run just before the window, each ended by a
sync. No run turns the program's stage timer on.
After the window the check compares what the window produced with the
plain reference (``benchmark/reference/``), and the last line of standard
output is the result's JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

if __name__ == "__main__":
    # the host's numeric libraries on one thread, set before they load:
    # the windows time one process's dispatch and replay, and spare
    # threads only compete with it for the host's cores
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from . import common  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "text_alignment_tpu")


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    base = os.path.join(common.ROOT, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no card line"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_reader(name):
    path = os.path.join(common.HERE, "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.layer_metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(args, device, spec=None, t_process=None, data_dir=None):
    """Set up, run the window, check, read: the result's dict."""
    import torch

    from . import program
    from . import trace as tr

    t_process = T_PROCESS if t_process is None else t_process
    spec = spec or common.load_spec()
    cell, config, traffic, limits = common.cell_parts(
        spec, args.workload, data_dir or common.HERE)
    e2e_specs, layer_specs = common.cell_metrics(spec, args.workload)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        c = kind.Cell(config, traffic, args.seed, device, workdir,
                      bool(args.trace))
        c.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_process
        built = program.build_seconds()
        log(f"# cell {args.workload}: config {cell['config']}, traffic "
            f"{cell['traffic']} ({traffic['kind']}), seed {args.seed}, "
            f"device {device}; set-up {setup_s:.3f} s"
            + (f", of it the kernels' nvcc build {built:.1f} s"
               if built is not None else ""))
        for line in getattr(c, "notes", lambda: [])():
            log("# " + line)

        records, failed, first_error = [], 0, None

        def item(i):
            nonlocal failed, first_error
            t0 = time.perf_counter()
            try:
                rec, ok = c.step(i), True
            except Exception:  # counted as failed; the run goes on
                rec, ok = {"units": 0}, False
                failed += 1
                if first_error is None:
                    first_error = traceback.format_exc()
            rec.update(t0=t0, t1=time.perf_counter(), ok=ok, i=i)
            records.append(rec)

        n_trace = c.trace_items() if args.trace else 0
        if n_trace:
            # the traced items come first, each ended by a sync; the
            # profiler's own work at its end falls before the window
            with tr.profiled(device) as prof:
                traced_at = time.perf_counter()
                for i in range(n_trace):
                    item(i)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                traced_until = time.perf_counter()
        t_start = time.perf_counter()
        t_end = t_start + args.seconds
        i = n_trace
        while time.perf_counter() < t_end:
            item(i)
            i += 1
        window = records[n_trace:]
        t_last = max((r["t1"] for r in window), default=t_start)
        if window:
            q = [1e3 * v for v in np.quantile(
                [r["t1"] - r["t0"] for r in window], [0.1, 0.5, 0.9])]
            log(f"# window: {len(window)} items, ms an item p10 {q[0]:.3f}"
                f" p50 {q[1]:.3f} p90 {q[2]:.3f}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            peak = int(torch.cuda.max_memory_allocated(device))
        else:
            peak = 0
        if first_error:
            log(f"# {failed} of {len(records)} items failed; the first:\n"
                + first_error)
        c.free()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        numbers = c.check([r for r in records if r["ok"]])
        check_s = time.perf_counter() - t_check
        for line in getattr(c, "log", []):
            log("# check detail: " + line)
        log(f"# check: {check_s:.3f} s for {len(records)} items")

        result = {"correct": None, "attempted": len(records),
                  "failed": failed}
        if args.trace:
            dev_ev, host_ev = tr.events(prof)
            window_s = traced_until - traced_at
            busy_s = tr.busy_us(dev_ev) * 1e-6
            traced = records[:n_trace]
            ctx = SimpleNamespace(
                dev=dev_ev, host=host_ev, window_s=window_s,
                busy_s=busy_s, traced=traced, records=records,
                spans=c.spans(), work=c.work(traced))
            metrics = {}
            for m in layer_specs:
                value = load_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
            t0_us = dev_ev[0][1] if dev_ev else 0.0
            starts = [s for _, s, _ in host_ev]
            t0_us = min(starts) if starts else t0_us
            t1_us = max((e for _, _, e in host_ev), default=t0_us)
            result["breakdown"] = {
                "device_ops": tr.top_ops(dev_ev),
                "idle_gaps": tr.idle_gaps(dev_ev, host_ev, t0_us, t1_us)}
        else:
            values = c.e2e(window, t_start, t_last)
            values["setup_s"] = setup_s
            metrics = {m["name"]: {"value": float(values[m["name"]]),
                                   "unit": m["unit"]} for m in e2e_specs}
        result["metrics"] = metrics
        dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                    "kind": (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu"),
                    "count": int(cell["chips"]),
                    "memory_peak_bytes": peak}
        if args.trace:
            dev_info.update(busy_s=busy_s, window_s=window_s)
        result["device"] = dev_info
        checks = {name: {"value": numbers[name], "limit": limits[name]}
                  for name in limits}
        result["correct"] = bool(
            failed == 0 and records
            and all(v["value"] <= v["limit"] for v in checks.values()))
        result["limits"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    cache_dirs()
    import torch

    torch.set_num_threads(1)
    spec = common.load_spec()
    cell = common.find(spec["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is false")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"the cell asks for {cell['chips']} cards, this machine has "
            f"{torch.cuda.device_count()}")
        return 2
    log(f"# card: {card_line()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    result = run_cell(args, torch.device("cuda", 0), spec)
    bad = forbidden_modules()
    if bad:
        log(f"the process holds {bad} after the window: the benchmark "
            f"drives the port alone")
        return 3
    for name, v in result["limits"].items():
        log(f"check {name}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
