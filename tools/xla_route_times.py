"""ms/step of the per-world step's XLA route on the card, with its solve
replayed from CUDA graphs (`solvers/graphs.py`) and eagerly, side by side
in one process: paths (b) and (a) of `chip_smoke.py` under the given
solvers, and catalog scenes at their published size (4 worlds).

Each case: 3 untimed steps, then STEPS timed steps, host clock around a
device synchronisation. Prints one line a case and the card's name and
power limit.

Usage: python3 tools/xla_route_times.py [SOLVER,SOLVER,...] [STEPS]
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from solver2d_tpu_torch import SolverType, _nvcc, batched_step, replicate  # noqa: E402
from solver2d_tpu_torch.models import SCENES  # noqa: E402
from solver2d_tpu_torch.ops import narrow_cuda  # noqa: E402
from solver2d_tpu_torch.solvers import fused_cuda, graphs  # noqa: E402

CATALOG = (("Contact", "Single Box"), ("Contact", "Pyramid"), ("Contact", "Confined"), ("Contact", "Card House"),
           ("Joints", "Ragdoll Stress"), ("Joints", "Joint Grid"))


def time_steps(state, cfg, worlds, steps):
    step = batched_step(cfg)
    batch = replicate(state, worlds)
    for _ in range(3):
        batch = step(batch, 1.0 / 60.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        batch = step(batch, 1.0 / 60.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def main(solvers, steps):
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    _nvcc.build([narrow_cuda._SOURCE, fused_cuda._SOURCE])
    narrow_cuda.load()
    fused_cuda.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cases = []
    for solver in solvers:
        cases.append((f"(b) {solver}", *chip_smoke.pyramid_b(dev, solver, use_fused_solver=False), chip_smoke.W_B))
        cases.append((f"(a) {solver}", *chip_smoke.bridge_a(dev, solver, use_fused_solver=False), chip_smoke.W_A))
        for key in CATALOG:
            state, cfg = SCENES[key](SolverType[solver]).freeze(device=dev, use_fused_solver=False)
            cases.append((f"{key[1]} {solver}", state, cfg, chip_smoke.CATALOG_WORLDS))
    for label, state, cfg, worlds in cases:
        ms = {}
        for mode in ("graphs", "eager"):
            graphs.ENABLED = mode == "graphs"
            graphs.clear()
            ms[mode] = time_steps(state, cfg, worlds, steps)
        graphs.ENABLED = True
        print(f"{label}, {worlds} worlds: XLA route {ms['graphs']:.2f} ms/step from CUDA graphs, {ms['eager']:.2f} "
              f"eager on {card}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1].split(",") if len(sys.argv) > 1 else ["TGS_SOFT", "PGS_NGS_BLOCK"],
         int(sys.argv[2]) if len(sys.argv) > 2 else 10)
