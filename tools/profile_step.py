"""Where the time of the port's steps goes, on the card.

Runs one path of chip_smoke.py at its configuration, then times each stage
of the step with the device synchronised around it (stage times add up to a
slower step than the pipelined one), and traces a few steps with
torch.profiler for the kernel time by name and the device's busy share.
Prints the report, and writes it to `out` when one is given.

Paths: `lane` (512 worlds x base-62 pyramid, `step_batch`), `b` (64 worlds x
base-20 pyramid, the per-world `batched_step`), `a` (32 worlds x Bridge,
per-world).

Usage (on a machine with a card):
    python3 tools/profile_step.py [path] [steps] [out]
"""

import collections
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from solver2d_tpu_torch import SolverType, batched_step, pyramid_world, replicate, step_batch  # noqa: E402
from solver2d_tpu_torch import step as step_mod  # noqa: E402
from solver2d_tpu_torch.ops import broadphase, coloring  # noqa: E402
from solver2d_tpu_torch.solvers import lane_solve as lane_mod  # noqa: E402
from solver2d_tpu_torch.solvers import loops as loops_mod  # noqa: E402

STAGES = {
    "lane": [
        (broadphase, "find_pairs_grid"),
        (broadphase, "match_contacts_lane"),
        (step_mod, "collide"),
        (step_mod, "_apply_manifolds"),
        (step_mod, "build_lane_structure"),
        (lane_mod, "prepare_contacts"),
        (lane_mod, "_lane_warm_start"),
        (lane_mod, "_lane_gs_sweep"),
        (lane_mod, "_store_impulses_lane"),
        (step_mod, "_post_solve"),
    ],
    "world": [
        (broadphase, "find_pairs_grid"),
        (broadphase, "match_contacts"),
        (step_mod, "collide"),
        (step_mod, "_apply_manifolds"),
        (coloring, "assign_colors"),
        (step_mod, "make_body_map"),
        (loops_mod, "prepare_contacts"),
        (loops_mod.jk, "prepare_joints"),
        (loops_mod, "fused_inputs"),
        (loops_mod, "fused_solve"),
        (loops_mod, "_finish"),
        (step_mod, "_post_solve"),
    ],
}


def setup(path, dev):
    """(batch, step, label) of a path at chip_smoke's configuration."""
    if path == "lane":
        world, ids = pyramid_world(SolverType.TGS_SOFT, chip_smoke.BASE)
        state, cfg = world.freeze(device=dev, **chip_smoke.bench_config(((4 * len(ids) + 127) // 128) * 128))
        return replicate(state, chip_smoke.W), lambda b: step_batch(b, 1 / 60, cfg), f"{chip_smoke.W} worlds x {len(ids) + 1} bodies (lane)"
    if path == "b":
        state, cfg = chip_smoke.pyramid_b(dev)
        step, W = batched_step(cfg), chip_smoke.W_B
        label = f"{W} worlds x base-{chip_smoke.BASE_B} pyramid (per-world, b)"
    else:
        state, cfg = chip_smoke.bridge_a(dev)
        step, W = batched_step(cfg), chip_smoke.W_A
        label = f"{W} worlds x Bridge (per-world, a)"
    return replicate(state, W), lambda b: step(b, 1 / 60), label


def main(path="lane", steps=5, out=None):
    dev = torch.device("cuda", 0)
    batch, step, label = setup(path, dev)
    for _ in range(3):
        batch = step(batch)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(steps):
        batch = step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3

    totals = collections.defaultdict(float)
    originals = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t
            return out
        return wrapper

    for mod, name in STAGES["lane" if path == "lane" else "world"]:
        originals[(mod, name)] = getattr(mod, name)
        setattr(mod, name, timed(name, getattr(mod, name)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        batch = step(batch)
    torch.cuda.synchronize()
    synced_ms = (time.perf_counter() - t0) / steps * 1e3
    for (mod, name), fn in originals.items():
        setattr(mod, name, fn)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            batch = step(batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: an operator's row repeats the time of its kernels
    dev_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    table = events.table(sort_by="self_cuda_time_total", row_limit=25)

    lines = [
        f"card: {torch.cuda.get_device_name(0)}; {label}",
        f"step: {step_ms:.2f} ms pipelined, {synced_ms:.2f} ms with a sync around each stage",
        "stage times (ms per step, synchronised):",
    ]
    for name, tot in sorted(totals.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:24s} {tot / steps * 1e3:9.2f}")
    lines.append(
        f"profiled 2 steps: wall {prof_wall * 1e3:.1f} ms, device busy {dev_us / 1e3:.1f} ms "
        f"({dev_us / 1e6 / prof_wall * 100:.1f}% busy, under the profiler)"
    )
    report = "\n".join(lines) + "\n\n" + table + "\n"
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(report)
    print(report)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0] if a else "lane", int(a[1]) if len(a) > 1 else 5, a[2] if len(a) > 2 else None)
