#!/usr/bin/env python3
"""The benchmark of solver2d_tpu_torch: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The cell
is an entry of BENCHMARK.json's "workloads", with its traffic in
benchmark/workloads/<cell>.json and its configuration in
benchmark/configs/<config>.json; each metric is read by
benchmark/metrics/<metric>.py. With --trace 0 the run reports the cell's
end-to-end metrics, with --trace 1 its per-layer ones (a profiled window
and a window of synced spans follow the measured one). The last line of
standard output is the result; the numbers compared with the plain
reference, each beside its limit, are the last lines of standard error.
Without a card, or without the program beside the benchmark, it exits
non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
# every build and kernel cache of a run stays in the checkout, at fixed paths
CACHE = os.path.join(REPO, ".bench_cache")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "solver2d_tpu")
CPU_THREADS = 4


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules, each name
    compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path[:0] = [BENCH, REPO]
    marks = [("harness start", T0)]
    import torch

    marks.append(("import torch", time.perf_counter()))
    from harness import cells, core

    doc = cells.benchmark_doc()
    entry = cells.cell_entry(doc, args.workload)
    wl = cells.workload(args.workload)
    if wl["config"] != entry["config"]:
        log(f"cell {args.workload}: its file names config {wl['config']}, BENCHMARK.json {entry['config']}")
        return 2
    cfg_doc = cells.config(entry["config"])
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"no result: the cell needs {chips} CUDA card(s), this machine has {n}")
        return 3
    marks.append(("find the card", time.perf_counter()))
    try:
        import solver2d_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"no result: the program under test is not beside the benchmark: {e}")
        return 4
    marks.append(("import the program", time.perf_counter()))
    log("set-up: " + "; ".join(f"{name} {t - marks[i][1]!r} s" for i, (name, t) in enumerate(marks[1:])))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = cells.metrics_of(doc, args.workload, kind)
    readers = {m["name"]: cells.load_metric(m["name"]) for m in metrics}
    torch.set_num_threads(CPU_THREADS)
    if args.trace:
        log(f"card: {power_limit()}")
    result = core.run(wl, cfg_doc, metrics, readers, args.seed, args.seconds, bool(args.trace), "cuda:0", log, T0)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process loaded {', '.join(bad)}")
        return 5
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                        **result["device"]}
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
