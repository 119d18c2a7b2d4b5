#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 101,102,103] [--seconds 2] [--out readings.jsonl]

Runs the cell at its own size in one process, once a seed: the program
(the lower readings: the largest over a dozen seeds or more), then the
control, the plain reference in the program's place with its state
rounded to bfloat16 (`harness.subject.control`; the upper readings: the
smallest over three seeds or more). Each run is the benchmark's own run
with a short window; the control's warm-up holds only the steps compared.
Prints one JSON line a run: subject, seed, correct, and each number
compared. Needs an NVIDIA card.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(cell: str, program_seeds, control_seeds, seconds: float, device="cuda:0", log=None):
    """Yields (subject, seed, result) for each run."""
    import torch

    from harness import cells, core

    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    wl = cells.workload(cell)
    cfg_doc = cells.config(wl["config"])
    for name, ss in (("program", program_seeds), ("control", control_seeds)):
        warmup = core.WARMUP_STEPS if name == "program" else int(wl["steps_compared"])
        for seed in ss:
            res = core.run(wl, cfg_doc, [], {}, seed, seconds, False, device, log, time.perf_counter(),
                           subject_name=name, warmup_steps=warmup)
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            yield name, seed, res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs an NVIDIA card", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    try:
        for name, seed, res in readings(args.workload, args.seeds, args.control_seeds, args.seconds):
            line = json.dumps({"cell": args.workload, "subject": name, "seed": seed, "correct": res["correct"],
                               **{k: c["value"] for k, c in res["checks"].items()}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
