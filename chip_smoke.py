#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs a CUDA
card, nvcc and the `solver2d_tpu_torch` package beside this file; without
them it exits non-zero and prints no result. Phases (any failure exits 1):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every kernel from the sources in the checkout (one nvcc per
   source, all started together);
3. hold each kernel against its plain PyTorch twin on the card at the
   shapes its path gives it: K2 on the contact table after the first step
   of the 512-world base-62 pyramid (7936 contacts per world); K1, in each
   of its scripts (TGS_Soft, SoftStep, PGS_Soft), on the per-world step's
   solve after 2 steps of 64 base-20 pyramids (211 bodies, 896 contacts),
   of 32 Bridges (161 bodies, 161 revolute joints) with a mouse joint on
   plank 80 held from the ground, and of 32 Bridges whose mouse joint's
   body A is plank 79, a dynamic body. Integer outputs must be equal, K2's
   floats within K2_ATOL, K1's equal (K1_ATOL = 0). Each kernel's
   registers, shared memory and resident blocks an SM are printed, K2's
   share of SAT slots, of warps that mix SAT with the other paths and its
   GJK trips on the lane scene, K2's time and bound also at the flattened
   shapes of paths (b) and (a), and K1's barrier count and time a barrier.
   A kernel's time is that of its launches replayed back to back from a
   CUDA graph (`kernel_ms`), printed beside the time a call by CUDA
   events, which also holds the wrapper's host work. At the catalog's
   shapes: K2 on the contact tables of Confined, Ragdoll Stress, Far
   Stack, Card House and Far Recovery after K2_CATALOG_STEPS steps of
   CATALOG_WORLDS worlds (circles, capsules, segments, far origins, thin
   boxes), and K1 in each script on Ragdoll Stress after K1_CATALOG_STEPS
   steps, when live contacts, limits and motors share a launch; each with
   its time and its bound on that data;
4. the lane path: `step_batch` on 512 worlds x 1954 bodies at the bench
   configuration (TGS_Soft, 4 substeps + relax, 9 colors, bucket cap 896,
   GJK 10), WARMUP + STEPS steps with every launch counter reset first;
   the state must stay finite, without color or pair overflow, the pyramid
   must stand (largest box displacement below MAX_DRIFT), and K2 must have
   launched once a step;
5. the same steps on the card and on the CPU (plain twins) for small
   scenes of both paths must agree: the lane path under TGS_Soft and
   SoftStep, the per-world path under each fused solver;
6. path (b) of the per-world step (`batched_step`): 64 base-20 pyramids
   (4 iterations + relax, 10 colors, GJK 10), WARMUP + STEPS steps under
   each fused solver: finite, no color overflow, the pyramid stands
   (MAX_DRIFT_B), K1 and K2 once a step;
7. path (a): 32 Bridges (8 colors), WARMUP + STEPS steps under each fused
   solver: finite, no color overflow, joints hold (joint_error below
   MAX_JOINT_ERROR_A), K1 once a step;
8. the catalog: every registered scene at its published size,
   CATALOG_WORLDS worlds with jittered velocities, TGS_Soft with the
   scene's hooks, on the route `World.freeze` picks (K1, but the XLA
   solvers for the 100 x 100 Joint Grid, above K1's body cap); Ragdoll
   Stress, Confined and Rush also under SoftStep and PGS_Soft. The first
   CATALOG_CHECK steps must equal the plain twins' on the CPU (positions
   within phase 5's tolerance, colors and diagnostics equal; the Joint Grid
   on its world 0); then each scene runs on to its length (CATALOG_RUN):
   finite, K2 once a step, K1 once a step on the fused route and never on
   the XLA route, no pair overflow in world 0 (the unjittered scene)
   outside PAIR_OVERFLOW_SCENES, Warm Start Energy's step-120 event fired,
   and CATALOG_BOUNDS met (Vertical Stack stands, Overlap Recovery
   separates, Ragdoll Stress and the Joint Grid hold their joints). Every
   scene also runs under each solver only the XLA route runs (XLA_ONLY,
   TGS_Sticky and XPBD among them) for CATALOG_CHECK + XLA_ONLY_STEPS
   steps: finite, K2 once a step, K1 never; and every other scene under
   SoftStep and PGS_Soft for as many steps, on the route `World.freeze`
   picks, held card to twin (not to the CPU, for the script's time):
   finite, K2 once a step, K1 once a step on the fused route and equal to
   its twin on the card on the inputs of the run's last solve, no pair
   overflow in world 0 outside PAIR_OVERFLOW_SCENES;
   Pyramid, Ragdoll Stress and Confined (XLA_CHECK_SCENES) also held to
   the CPU for their first CATALOG_CHECK steps (where the solver blows a
   scene up, within the CPU's own spread under a 1-ulp change of the
   initial velocities, if that exceeds the tolerance). Each run's ms/step,
   world-steps/s and pair and color overflow. The XLA-only runs time
   XLA_ONLY_STEPS steps after their first CATALOG_CHECK;
9. the XLA route (`use_fused_solver=False`) on paths (b) and (a), under
   each of its ten solvers on the dense layout (TGS_Sticky and XPBD
   among them), and under XLA_BUCKETED on the bucketed one
   (`contact_bucket_cap=-1`, `joint_bucket_cap=-1`): the first 3 steps of
   XLA_CHECK_WORLDS jittered worlds on the card equal the CPU's (phase 5's
   tolerance, colors and diagnostics equal); then WARMUP + STEPS steps of
   the path's worlds: finite, no color overflow, the pyramid stands and
   the bridge holds within XLA_BOUNDS (twice the JAX package's XLA solver
   on the CPU), K2 once a step, K1 never. Under TGS_Sticky on (b), the
   share of live contacts whose friction anchors persisted must be above 0;
10. the secondary paths on (b) under PGS_NGS_Block, the JAX package's
   default solver, on the XLA route: the sweep-and-prune broadphase
   (`SAP_KW`) and the per-step MIS coloring (`incremental_coloring=False`),
   each checked as in phase 9 against SECONDARY_BOUNDS; the sweep and
   prune without pair overflow;
11. interaction on the card (`run_interaction`): path (b) under TGS_Soft
   on the fused route with spare joint slots, INTERACT_WARMUP steps; then
   in world 0 and in world INTERACT_WORLD: `pick_body` at the top box's
   center finds it; `attach_mouse_joint` in every world, INTERACT_DRAG
   steps with `move_mouse_target`, `detach_mouse_joint`; `raycast_world`
   of a horizontal ray through the pyramid, culled (S > 64 shape slots)
   equal to brute force; `query_aabb` and `test_point`; one of each runtime
   edit of `utils/runtime.py`, then INTERACT_AFTER steps; `gjk_stats` warm
   and cold; `validate_state` empty; `world_health` and
   `reset_unhealthy_worlds` on a batch with one world blown up by
   `set_linear_velocity`; a `save_npz` / `load_npz` round trip equal bit
   for bit; `StepTimer` ms/step and `stage_times`. The same sequence on
   the CPU (INTERACT_CPU_WORLDS worlds, through the plain twins) up to
   INTERACT_DRAG steps after the attach equals the card's (phase 5's
   tolerance, colors and diagnostics equal); K1 and K2 once a step, each
   equal to its twin on a step's inputs with the mouse joint live; finite,
   no color overflow, the dragged box nearer its target. If matplotlib
   imports, one frame through `render_states` and a 4-frame
   `InteractiveTestbed.record_gif` on the card; if not, one line says so
   (an optional dependency, outside every check);
12. the world batch split over mesh entries (`parallel.sharding`), on
   `make_mesh()` (the one card) and on a mesh that lists the card twice
   (two shards, each on its own stream): the lane path at phase 4's width
   and configuration, 3 steps equal to `step_batch` bit for bit, K2 once a
   shard a step; path (b) under TGS_Soft (fused route) and PGS_NGS_Block
   (XLA route): 3 steps of jittered worlds equal to `batched_step` bit for
   bit, then WARMUP + STEPS steps gated as in phase 6 (phase 9's bound on
   the XLA route), K1 once a shard a step on the fused route and never on
   the XLA route, K2 once a shard a step, ms/step of one shard against two;
   one NCCL rank (`distributed.initialize`, a file:// store): the mesh
   holds its group, `global_batch` equals `replicate`, the all_reduce of
   `metrics_psum_example` equals the local sum; `ops/manifold.collide` on
   [2, C] first-step pairs of the lane scene, K2 against its twin on the
   CPU (integers equal, floats within K2_ATOL).
Each phase's seconds are printed.

The line before the last is a JSON object with each kernel's numbers; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

W = 512
BASE = 62
WARMUP = 3
STEPS = 20
DT = 1.0 / 60.0
K2_ATOL = 1e-5
# K1 rounds as its twin does (csrc/fused_solve.cu, "Numbers")
K1_ATOL = 0.0
# the per-world path's scenes: (b) base-20 pyramids, (a) Bridges
W_B, BASE_B = 64, 20
W_A = 32
# the fused solvers of the per-world step, each a script of K1
FUSED = ("TGS_SOFT", "SOFT_STEP", "PGS_SOFT")
# the solvers of the per-world step's XLA route, and those only it runs
XLA = ("JACOBI", "PGS", "PGS_NGS", "PGS_NGS_BLOCK", "PGS_SOFT", "SOFT_STEP", "TGS_SOFT", "TGS_NGS", "TGS_STICKY",
       "XPBD")
XLA_ONLY = ("PGS", "PGS_NGS", "PGS_NGS_BLOCK", "JACOBI", "TGS_NGS", "TGS_STICKY", "XPBD")
# phase 9: the solvers also run on the bucketed layout, and the worlds held
# to the CPU for the first 3 steps
XLA_BUCKETED = ("TGS_SOFT", "PGS_NGS_BLOCK", "XPBD")
XLA_CHECK_WORLDS = 4
# Largest box displacement of path (b) after WARMUP + STEPS steps, per
# solver: twice the JAX package's on the CPU at this configuration and step
# count (tools/jax_world_bounds.py pyramid 23 SOLVER): 0.026405 (TGS_Soft),
# 0.026405 (SoftStep), 0.051025 (PGS_Soft).
MAX_DRIFT_B = {"TGS_SOFT": 0.053, "SOFT_STEP": 2 * 0.026405, "PGS_SOFT": 2 * 0.051025}
# Largest revolute joint separation of path (a) after WARMUP + STEPS
# steps: twice the JAX package's on the CPU (tools/jax_world_bounds.py
# bridge 23 SOLVER): 0.004900 (TGS_Soft), 0.002153 (SoftStep), 0.007671
# (PGS_Soft).
MAX_JOINT_ERROR_A = {"TGS_SOFT": 0.0098, "SOFT_STEP": 2 * 0.002153, "PGS_SOFT": 2 * 0.007671}
# Phase 9's bounds after WARMUP + STEPS steps on the XLA route, per path,
# solver and layout: twice the JAX package's (its XLA solver) on the CPU
# (tools/jax_world_bounds.py pyramid|bridge 23 SOLVER --xla [--bucketed]):
# the largest box displacement of path (b), the joint separation of (a).
# Jacobi's base-20 pyramid does not stand in the JAX package either (426.4
# after 23 steps, its pair table overflowing): its bound only keeps it
# finite and near the reference's.
JAX_XLA = {
    ("b", "dense"): {"TGS_SOFT": 0.026405, "SOFT_STEP": 0.026405, "PGS_SOFT": 0.051025, "PGS": 0.066842,
                     "PGS_NGS": 0.043601, "PGS_NGS_BLOCK": 0.052260, "JACOBI": 426.438171, "TGS_NGS": 0.014633,
                     "TGS_STICKY": 0.026233, "XPBD": 0.056199},
    ("b", "bucketed"): {"TGS_SOFT": 0.026405, "PGS_NGS_BLOCK": 0.052260, "XPBD": 0.056199},
    ("a", "dense"): {"TGS_SOFT": 0.004900, "SOFT_STEP": 0.002153, "PGS_SOFT": 0.007671, "PGS": 0.007452,
                     "PGS_NGS": 0.010953, "PGS_NGS_BLOCK": 0.010953, "JACOBI": 0.007671, "TGS_NGS": 0.004349,
                     "TGS_STICKY": 0.011419, "XPBD": 0.008430},
    ("a", "bucketed"): {"TGS_SOFT": 0.004920, "PGS_NGS_BLOCK": 0.010994, "XPBD": 0.010611},
}
XLA_BOUNDS = {k: {solver: 2 * v for solver, v in d.items()} for k, d in JAX_XLA.items()}
# Phase 10, the secondary paths on (b) under PGS_NGS_Block. The sweep and
# prune takes a window of 48 successors (a box of the base-20 pyramid
# overlaps some 30 others on the sweep axis: the default 16 overflows) and
# as many shape slots as shapes: the JAX package's window test reads the
# low bound of a dead slot, 0, as a successor's and flags an overflow on
# every scene with dead slots (mirrored by the port). Bounds: twice the
# JAX package's largest box displacement on the CPU after WARMUP + STEPS
# steps (tools/jax_world_bounds.py pyramid 23 PGS_NGS_BLOCK --xla --sap |
# --mis).
SAP_KW = dict(broadphase="sap", sap_window=48)
SECONDARY = {"sap": SAP_KW, "mis": dict(incremental_coloring=False)}
JAX_SECONDARY = {"sap": 0.052260, "mis": 0.050111}
SECONDARY_BOUNDS = {k: 2 * v for k, v in JAX_SECONDARY.items()}
# Largest box displacement allowed after WARMUP + STEPS steps. The JAX
# package on the CPU moves the boxes of a base-20 pyramid by at most 0.0264
# after 23 steps at this configuration (tools/jax_pyramid_drift.py 20 23).
# Each row sinks under the weight above it, so the sink grows with the
# square of the base: (62/20)^2 x 0.0264 = 0.254 for the bench pyramid. The
# bound is twice that; a collapsing pyramid moves boxes by a box size (1.0)
# or more.
MAX_DRIFT = 0.5
# Phase 8, the catalog: every registered scene at its published size,
# CATALOG_WORLDS worlds with velocities
# jittered by world index x JITTER, the first CATALOG_CHECK steps compared
# with the plain twins on the CPU, then the card alone to CATALOG_RUN steps
# (CATALOG_CHECK + STEPS unless listed)
CATALOG_WORLDS = 4
JITTER = 0.05
CATALOG_CHECK = 3
# the timed steps of the XLA-only sweep, after its CATALOG_CHECK steps
XLA_ONLY_STEPS = 10
CATALOG_RUN = {
    ("Contact", "Vertical Stack"): 240, ("Contact", "Overlap Recovery"): 120,
    ("Contact", "Warm Start Energy"): 125, ("Joints", "Ragdoll Stress"): 60,
}
# the scenes also run under the other fused solvers
CATALOG_ALL_SOLVERS = (("Joints", "Ragdoll Stress"), ("Contact", "Confined"), ("Contact", "Rush"))
# under the XLA_ONLY solvers, the scenes also held to the CPU
XLA_CHECK_SCENES = (("Contact", "Pyramid"), ("Joints", "Ragdoll Stress"), ("Contact", "Confined"))
# scenes whose pair table overflows at default capacities in the JAX package
# too (TESTLOG_r05.txt:29-30): gated on equality with the CPU twins only.
# The other scenes must not overflow in world 0, the unjittered scene (a
# jittered Vertical Stack may topple, and its tilted boxes overflow the
# big-shape list sized for the upright stack)
PAIR_OVERFLOW_SCENES = (("Contact", "Card House"), ("Far", "Ragdoll Pile"), ("Joints", "Ragdoll Stress"))
# 4 float32 ulps of a coordinate: the card-vs-CPU tolerance's share on the
# Far scenes, whose coordinates reach 1e5 (ulp 0.0078)
FAR_RTOL = 4 * 2.0**-23
# Bounds of world 0 (the unjittered scene) at the end of its run: twice the
# JAX package's on the CPU at the same configuration and step count
# (tools/jax_world_bounds.py "Category/Name" STEPS TGS_SOFT): Vertical
# Stack after 240 steps, max penetration 0.009975 and kinetic energy
# 0.002514; Overlap Recovery after 120 steps, max penetration 0.002330;
# Ragdoll Stress, the largest joint_error over 60 steps, 0.625976; the
# 100 x 100 Joint Grid (XLA route), the largest joint_error over 23 steps,
# 0.244524
CATALOG_BOUNDS = {
    (("Contact", "Vertical Stack"), "TGS_SOFT"): dict(max_penetration=2 * 0.009975, kinetic_energy=2 * 0.002514),
    (("Contact", "Overlap Recovery"), "TGS_SOFT"): dict(max_penetration=2 * 0.002330),
    (("Joints", "Ragdoll Stress"), "TGS_SOFT"): dict(joint_error=2 * 0.625976),
    (("Joints", "Joint Grid"), "TGS_SOFT"): dict(joint_error=2 * 0.244524),
}
# phase 3's catalog inputs: K2 after K2_CATALOG_STEPS steps of these scenes
# (Confined's circles reach its capsule walls at step 5); K1 in each script
# after K1_CATALOG_STEPS steps of K1_CATALOG
K2_CATALOG = (("Contact", "Confined"), ("Joints", "Ragdoll Stress"), ("Far", "Stack"), ("Contact", "Card House"),
              ("Far", "Recovery"))
K2_CATALOG_STEPS = 6
K1_CATALOG, K1_CATALOG_STEPS = ("Joints", "Ragdoll Stress"), 40
# Phase 11, interaction on path (b): steps before the pick, dragging steps
# (held to the CPU on INTERACT_CPU_WORLDS worlds), steps after the runtime
# edits; the second world whose queries are checked; the world blown up
# for the health check
INTERACT_WARMUP, INTERACT_DRAG, INTERACT_AFTER = 3, 3, 2
INTERACT_CPU_WORLDS = 4
INTERACT_WORLD = 5
BLOWN_WORLD = 7
# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s, fp32 67 TFLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def bench_config(max_contacts):
    """The configuration `bench.py` runs by default (bench.py:56-83)."""
    return dict(max_contacts=max_contacts, max_colors=9, gjk_iters=10, contact_bucket_cap=896)


def pyramid_b(dev, solver, **kw):
    """Path (b): the base-20 pyramid of the JAX package's K1 chip runs
    (exp/step_variants.py:16-18,38,44-49); `kw` more freeze settings."""
    from solver2d_tpu_torch import SolverType, pyramid_world

    world, _ = pyramid_world(SolverType[solver], BASE_B)
    if kw.get("broadphase") == "sap":
        kw = dict(kw, max_shapes=len(world.shapes))  # no dead slots (see SAP_KW)
    return world.freeze(device=dev, lane_solve=False, max_contacts=896, max_colors=10, gjk_iters=10, **kw)


def bridge_a(dev, solver, mouse=None, **kw):
    """Path (a): the catalog Bridge (exp/chip_joint_pallas.py:26-35), with a
    mouse joint dragging plank 80 when asked: held from the ground
    (mouse="ground") or from plank 79, a dynamic body ("plank"); `kw` more
    freeze settings."""
    from solver2d_tpu_torch import SolverType, bridge

    world, planks = bridge(SolverType[solver])
    if mouse:
        x, y = world.bodies[planks[80]].def_.position
        body_a = 0 if mouse == "ground" else planks[79]
        world.create_mouse_joint(body_a, planks[80], (x + 0.5, y + 2.0), 5.0, 0.7)
    return world.freeze(device=dev, lane_solve=False, max_colors=8, **kw)


def time_cuda(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """ms a call of fn's launches replayed back to back from a CUDA graph
    (no host work between them), by CUDA events around the replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def kernel_ms(fn, reps=20):
    """(kernel ms, ms a call): the time a call of fn's kernel launches
    replayed back to back from a CUDA graph (`graph_ms`), and the time a
    call by CUDA events around back-to-back calls, which also holds the
    wrapper's host work (its checks and allocations). When a kernel takes
    less than that host work, the second times the host, not the kernel."""
    call = time_cuda(fn, reps)
    return graph_ms(fn, reps), call


def count_float_ops(fn):
    """Elements produced by float arithmetic ops while fn runs (one operation
    each): the work of the plain twin on these inputs."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {
        "add", "sub", "mul", "div", "neg", "sqrt", "reciprocal", "minimum", "maximum",
        "clamp", "clamp_min", "clamp_max", "pow", "rsub",
    }

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0].rstrip("_")
            if name in arith and isinstance(out, torch.Tensor) and out.dtype.is_floating_point:
                Count.ops += out.numel()
            return out

    with Count():
        res = fn()
    return res, Count.ops


def k2_work(args, gjk_iters):
    """What each (world, slot) of K2 does on these inputs, from the twin's
    own GJK: its GJK trips (it runs trips until its simplex stops changing,
    and one more to see it, at most gjk_iters), its manifold path, and its
    shapes' vertex counts. Returns a dict of [W, C] tensors: trips, ca, cb,
    and the path masks sat, vv (vertex-vertex), ev (edge-vertex clip),
    cc (two circles), pc (polygon and circle)."""
    import torch

    from solver2d_tpu_torch.config import LINEAR_SLOP
    from solver2d_tpu_torch.ops.narrow_lanes import gjk_lanes

    geom, sa, sb, pa, pb, cache = args
    W, _, C = pa.shape
    ga, gb = geom[sa].t()[:, None, :], geom[sb].t()[:, None, :]
    ca, cb = ga[32:33].to(torch.int32), gb[32:33].to(torch.int32)

    def gjk(w0, w1, iters):
        a = pa[w0:w1].transpose(0, 1)
        b = pb[w0:w1].transpose(0, 1)
        k = cache[w0:w1].transpose(0, 1)
        qas, qac, qbs, qbc = a[2:3], a[3:4], b[2:3], b[3:4]
        xqs, xqc = qac * qbs - qas * qbc, qac * qbc + qas * qbs
        dxp, dyp = b[0:1] - a[0:1], b[1:2] - a[1:2]
        xpx, xpy = qac * dxp + qas * dyp, -qas * dxp + qac * dyp
        vbx, vby = gb[0:8], gb[8:16]
        return gjk_lanes(ga[0:8], ga[8:16], ca, xpx + (xqc * vbx - xqs * vby), xpy + (xqs * vbx + xqc * vby), cb,
                         k[0:1], (k[1:2], k[2:3], k[3:4]), (k[4:5], k[5:6], k[6:7]), iters)

    def key(g):
        return torch.cat([g.count, *g.ia, *g.ib])

    trips, dist, count = [], [], []
    for w0 in range(0, W, 64):
        w1 = min(W, w0 + 64)
        final = gjk(w0, w1, gjk_iters)
        want = key(final)
        settled = torch.full((w1 - w0, C), gjk_iters, dtype=torch.int32, device=pa.device)
        for k in range(gjk_iters - 1, -1, -1):
            same = (key(gjk(w0, w1, k)) == want).all(0)
            settled = torch.where(same, torch.full_like(settled, k), settled)
        trips.append(torch.clamp(settled + 1, max=gjk_iters))
        dist.append(final.distance[0])
        count.append(final.count[0])
    trips, dist, count = torch.cat(trips), torch.cat(dist), torch.cat(count)
    ca, cb = ca[0].expand(W, C), cb[0].expand(W, C)
    circle_a, circle_b = ca == 1, cb == 1
    poly = ~circle_a & ~circle_b
    sat = poly & (dist < 0.1 * LINEAR_SLOP)
    vv = poly & ~sat & (count == 1)
    return dict(trips=trips, ca=ca, cb=cb, sat=sat, vv=vv, ev=poly & ~sat & ~vv, cc=circle_a & circle_b,
                pc=circle_a ^ circle_b)


def k2_ops(work):
    """The float operations K2's function needs on these inputs, at most:
    each operation of the kernel's own code (csrc/narrow.cu) counted once,
    for the GJK trips a slot runs (each charged a 3-point simplex solve) and
    the one manifold path it takes, its scans over its shapes' own vertex
    counts. The twin runs every trip, scans 8 rows and computes every path,
    so its count is not the function's."""
    import torch

    ca, cb, trips = work["ca"].double(), work["cb"].double(), work["trips"].double()
    solve = 54.0  # w = B - A (6), the 3-point barycentric solve (48)
    trip = solve + 15.0 + 2.0 + 3.0 * (ca + cb)  # solve, search direction, two support scans
    clip = 63.0  # clip_polygons
    ev = 28.0 + clip  # reference and incident edges from the GJK features; every non-SAT path fills its second point
    path = (work["sat"] * (7.0 * (ca + cb) + 10.0 * ca * cb + clip)  # two max-separation scans, incident edges
            + work["vv"] * (ev + 21.0) + work["ev"] * ev + work["cc"] * (ev + 23.0)
            + work["pc"] * (ev + 69.0 + 5.0 * torch.where(work["ca"] == 1, cb, ca)))
    # B into A's frame (15) and B's vertices and normals (14 each), the
    # closing solve, the witness points and distance (42), the outputs (25)
    per_slot = 15.0 + 14.0 * cb + trips * trip + solve + 42.0 + path + 25.0
    return float(per_slot.sum())


def k2_bound(args, ops):
    """K2's least time on these inputs: the bytes its function must move
    (per slot two poses and the cache in, 12 floats and 10 ints out; the
    shape indices and rows once) over the memory rate, or `ops` float
    operations (`k2_ops`) over the fp32 rate, whichever is larger. Returns
    (ms, bytes ms, ops ms, bytes)."""
    geom, _, _, pa, _, _ = args
    W, _, C = pa.shape
    nbytes = W * C * (2 * 16 + 28) + W * C * 88 + C * 8 + geom.shape[0] * 34 * 4
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_F32_S * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms, nbytes


def k2_paths(work):
    """The share of slots that take SAT, the share of warps (32 neighbouring
    slots of one world, as the kernel maps them) that mix SAT with another
    path, and the mean and largest GJK trips a slot."""
    import torch

    sat = work["sat"]
    W, C = sat.shape
    pad = (-C) % 32
    u = torch.nn.functional.pad(sat, (0, pad)).reshape(W, -1, 32)
    o = torch.nn.functional.pad(~sat, (0, pad)).reshape(W, -1, 32)
    mixed = float((u.any(-1) & o.any(-1)).float().mean())
    trips = work["trips"].float()
    return float(sat.float().mean()), mixed, float(trips.mean()), int(trips.max())


def k1_contact_columns(script, warm_start):
    """The float columns of a contact row that K1's script reads
    (fused_solve.pack_cons_fields): TGS_Soft all but r_a0, r_b0 and the
    separation (15-24); SoftStep all but the separation (23-24); PGS_Soft
    all but the adjusted separation (25-26), and without the warm start
    not the local anchors (7-14) either, which only its warm start
    rotates."""
    if script.mode.current_vel_anchors:
        return 37 - 10
    if script.mode.sep_from_delta:
        return 37 - 2
    return 37 - 2 - (0 if warm_start else 8)


def k1_bytes(x, script, warm_start):
    """The bytes K1's function must move on these inputs: the int row of
    every contact and joint slot (to find the live ones); for each active
    contact the float columns the script reads (`k1_contact_columns`) and
    its 4 impulses in and out; for each live joint its 23 float columns and
    5 impulses in and out; the body state in and out and the body
    constants; h and 1/h. The port's warm-start plans (c_off, c_ent, j_off,
    j_ent) and delta scratch belong to its design, not to the function, and
    are left out."""
    from solver2d_tpu_torch.solvers.fused_solve import C_ACTIVE, J_ACTIVE

    n_c = int(((x.cint[..., 3] & C_ACTIVE) != 0).sum())
    n_j = int(((x.jint[..., 3] & J_ACTIVE) != 0).sum())
    slots = (x.cint.numel() + x.jint.numel()) * 4
    contacts = n_c * (k1_contact_columns(script, warm_start) + 2 * 4) * 4
    joints_ = n_j * (23 + 2 * 5) * 4
    bodies = (2 * x.bs.numel() + x.body_const.numel()) * 4
    return slots + contacts + joints_ + bodies + x.scal.numel() * 4


def check_k2_world(name, batch, cfg, card):
    """K2 against its twin on the per-world step's narrowphase inputs of
    `batch` (its worlds flattened into one lane batch), timed, with its
    bound on this data. Returns (max abs err, kernel ms, twin ms, bound ms,
    bound_by)."""
    import torch

    from solver2d_tpu_torch.ops import narrow_cuda
    from solver2d_tpu_torch.ops.narrow_lanes import collide_lanes_plain
    from solver2d_tpu_torch.step import world_narrow_inputs

    args = world_narrow_inputs(batch, batch.contacts)
    k2 = narrow_cuda.collide(*args, cfg.gjk_iters)
    want2 = collide_lanes_plain(*args, cfg.gjk_iters)
    work = k2_work(args, cfg.gjk_iters)
    ops2 = k2_ops(work)
    torch.cuda.synchronize()
    err = float((k2[0] - want2[0]).abs().max()) if k2[0].numel() else 0.0
    if not (torch.equal(k2[1], want2[1]) and torch.equal(k2[2], want2[2]) and err <= K2_ATOL):
        fail(f"K2 disagrees with its plain twin at {name}")
    k2_ms, k2_call = kernel_ms(lambda: narrow_cuda.collide(*args, cfg.gjk_iters))
    p_ms = time_cuda(lambda: collide_lanes_plain(*args, cfg.gjk_iters), 2)
    k2_b, k2_bb, k2_bo, k2_nb = k2_bound(args, ops2)
    kinds = {1: "circle", 2: "capsule/segment"}
    pairs = {}
    live = (want2[1][0, 2] > 0) & batch.contacts.alive.reshape(-1)
    for a, b in zip(work["ca"].reshape(-1)[live].tolist(), work["cb"].reshape(-1)[live].tolist()):
        k = "-".join(sorted((kinds.get(a, "polygon"), kinds.get(b, "polygon"))))
        pairs[k] = pairs.get(k, 0) + 1
    print(f"[3] K2 at {name}'s flattened shape W={args[3].shape[0]} C={args[3].shape[2]}: within {err:.3e} of its "
          f"twin (tol {K2_ATOL}), ids and caches equal; touching pairs by shapes {pairs}; {k2_ms:.4f} ms "
          f"({k2_call:.4f} ms a call), plain twin {p_ms:.3f} ms; bound {k2_b:.5f} ms ({k2_nb / 1e6:.2f} MB -> "
          f"{k2_bb:.5f} ms; at most {ops2 / 1e9:.4f} GFLOP -> {k2_bo:.5f} ms), {k2_b / k2_ms:.1%} of bound on {card}",
          flush=True)
    return err, k2_ms, p_ms, k2_b, "bytes" if k2_bb >= k2_bo else "operations"


def check_k1(name, state, cfg, W, dev, card, timed=True, steps=2, scene=None, k2=True, mixed=False):
    """K1 against its twin on the inputs the per-world step hands it after
    `steps` steps of W worlds under cfg.solver (`state` one world, or a
    batch of W if `scene` is given, stepped with the scene's hooks), and, if
    `timed` and `k2`, K2 against its twin on the path's flattened
    narrowphase inputs. With `mixed`, the launch must hold live contacts,
    limits and motors. Returns (max abs error, kernel ms, twin ms, bound
    ms, bound_by, extras); the times, the bound and the extras (K1's
    barriers, attributes and staging; K2's time and bound at this shape)
    only if `timed`."""
    import torch

    from solver2d_tpu_torch import batched_step, replicate
    from solver2d_tpu_torch.solvers import contact_kernels as ck
    from solver2d_tpu_torch.solvers import fused_cuda, joints
    from solver2d_tpu_torch.solvers.fused_solve import unpack_cons, unpack_joints, fused_solve_plain
    from solver2d_tpu_torch.solvers.loops import fused_static
    from solver2d_tpu_torch.step import prepare

    step = batched_step(cfg)
    batch = state if scene is not None else replicate(state, W)
    for i in range(steps):
        batch = frame(scene, step, batch, i) if scene is not None else step(batch, DT)
    x = prepare(batch, DT, cfg).x
    static = fused_static(cfg)
    script = static["script"]
    got = fused_cuda.fused_solve(x, **static)
    torch.cuda.synchronize()
    want = fused_solve_plain(x, **static)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(g).all()) for g in got):
        fail(f"K1 ({name}): non-finite outputs")
    errs = [float((g - w).abs().max()) if g.numel() else 0.0 for g, w in zip(got, want)]
    err = max(errs)
    flags = x.cint[..., 3]
    jflags = x.jint[..., 3]
    n_c = int(((flags & 4) != 0).sum())
    n_j = int(((jflags & 2) != 0).sum())
    j = batch.joints
    n_lim, n_mot = int((j.alive & j.enable_limit).sum()), int((j.alive & j.enable_motor).sum())
    n_eng = int((j.alive & ((j.lower_impulse != 0) | (j.upper_impulse != 0))).sum())
    print(f"[{_PHASE.get('name', '3')}] K1 vs twin, {cfg.solver.name}, {name}: W={W} B={x.bs.shape[1]} "
          f"C={x.cint.shape[1]} "
          f"J={x.jint.shape[1]}, {n_c} active contacts, {n_j} live joints ({n_lim} limited, {n_eng} of them with a "
          f"limit engaged last step, {n_mot} motored); max abs err bodies {errs[0]:.3e}, "
          f"normal impulses {errs[1]:.3e}, tangent impulses {errs[2]:.3e}, joint impulses {errs[3]:.3e} "
          f"(tol {K1_ATOL})", flush=True)
    if not err <= K1_ATOL:
        fail(f"K1 disagrees with its plain twin ({cfg.solver.name}, {name})")
    if mixed and not (n_c and n_lim and n_mot):
        fail(f"K1 ({name}): the launch lacks live contacts, limits or motors")
    if not timed:
        return err, None, None, None, None, {}
    k_ms, call_ms = kernel_ms(lambda: fused_cuda.fused_solve(x, **static))
    p_ms = time_cuda(lambda: fused_solve_plain(x, **static), 2)
    phases = torch.empty(W, dtype=torch.int32, device=dev)
    fused_cuda.fused_solve(x, **static, phases=phases)
    phases = phases.cpu()
    B, C, J = x.bs.shape[1], x.cint.shape[1], x.jint.shape[1]
    stage = fused_cuda.stage_bytes_default(script, B, C, J, W, dev)
    attrs = fused_cuda.attributes(script, stage, B)
    n_ph = int(phases.max())
    print(f"[3] K1 {cfg.solver.name} {name}: {int(phases.min())}-{n_ph} barriers a world, "
          f"{k_ms * 1e3 / n_ph:.3f} us a barrier; {attrs['registers']} registers, {attrs['spill_bytes']} spill bytes, "
          f"{attrs['smem_bytes']} B dynamic shared memory ({stage} staging), {attrs['blocks_per_sm']} block(s) an SM",
          flush=True)
    extras = dict(call_ms=call_ms, phases=n_ph, us_per_phase=k_ms * 1e3 / n_ph, registers=attrs["registers"],
                  spill_bytes=attrs["spill_bytes"], smem_bytes=attrs["smem_bytes"], stage_bytes=stage,
                  blocks_per_sm=attrs["blocks_per_sm"])

    if k2:  # K2 at this path's shape (its worlds flattened into one lane batch)
        _, k2_ms, _, k2_b, k2_by = check_k2_world(name, batch, cfg, card)
        extras.update(k2_ms=k2_ms, k2_bound_ms=k2_b, k2_bound_by=k2_by)

    # the bound: the bytes this run's data needs moved once, and the
    # operations of the constraint solves it needs (each active winner
    # solved once a pass)
    nbytes = k1_bytes(x, script, static["warm_start"])
    solved_c = int((((flags & 4) != 0) & ((flags & 32) != 0) & (x.cint[..., 2] >= 0)).sum())
    solved_j = int((((jflags & 2) != 0) & ((jflags & 64) != 0) & (x.jint[..., 2] >= 0)).sum())
    w0 = lambda t: t[0]  # noqa: E731
    cons = unpack_cons(x.cfields[0], flags[0])
    jc = unpack_joints(x.jfields[0], jflags[0])
    C, J = x.cint.shape[1], x.jint.shape[1]
    rc = [torch.zeros((C, 2), device=dev), torch.zeros(C, device=dev)] * 2
    q = torch.zeros((C, 2), device=dev)
    _, ops_c = count_float_ops(lambda: ck.solve_contact_core(
        cons, rc[0], rc[1], rc[2], rc[3], q, q, q, q, w0(x.n_imp), w0(x.t_imp), script.mode, x.scal[1], True))
    rj = [torch.zeros((J, 2), device=dev), torch.zeros(J, device=dev)] * 2
    qj = torch.zeros((J, 2), device=dev)
    imp = joints.JointImp(x.jimp[0, :, 0:2], x.jimp[0, :, 2], x.jimp[0, :, 3], x.jimp[0, :, 4])
    _, ops_j = count_float_ops(lambda: joints.solve_joint_core(
        jc, rj[0], rj[1], rj[2], rj[3], qj, qj, qj, qj, imp, x.scal[0], x.scal[1], True, True))
    if script.loop == "substep":
        passes = static["substeps"] * (1 + static["relax"])
    else:
        passes = static["substeps"] + static["relax"]
    ops = passes * (solved_c * ops_c / C + solved_j * ops_j / J)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_F32_S * 1e3
    bound = max(bytes_ms, ops_ms)
    print(f"[3] K1 {cfg.solver.name} {name}: {k_ms:.4f} ms ({call_ms:.4f} ms a call), plain twin {p_ms:.3f} ms; "
          f"bound {bound:.5f} ms "
          f"({nbytes / 1e6:.3f} MB -> {bytes_ms:.5f} ms; {ops / 1e9:.5f} GFLOP in {passes} passes -> "
          f"{ops_ms:.5f} ms), {bound / k_ms:.1%} of bound on {card}", flush=True)
    return err, k_ms, p_ms, bound, "bytes" if bytes_ms >= ops_ms else "operations", extras


def catalog_scene(key, solver):
    """A registered scene at its published size."""
    from solver2d_tpu_torch import SolverType
    from solver2d_tpu_torch.models import SCENES

    return SCENES[key](SolverType[solver])


def jittered(batch, seed=0):
    """The batch with world i's dynamic bodies' velocities jittered by
    i * JITTER * N(0, 1) from a seeded generator (on the CPU)."""
    import torch

    from solver2d_tpu_torch.parallel import apply_velocity_deltas

    g = torch.Generator().manual_seed(seed)
    b = batch.bodies
    scale = JITTER * torch.arange(b.v.shape[0], dtype=torch.float32)
    dv = torch.randn(b.v.shape, generator=g) * scale[:, None, None]
    dw = torch.randn(b.w.shape, generator=g) * scale[:, None]
    return apply_velocity_deltas(batch, dv, dw)


def catalog_batch(scene, dev, worlds=CATALOG_WORLDS):
    """(batch on dev, the same batch on the CPU, config): `worlds` copies of
    the frozen scene, world i's dynamic bodies' velocities jittered by
    i * JITTER * N(0, 1) from a seeded generator."""
    from solver2d_tpu_torch import replicate

    state, cfg = scene.freeze(device="cpu")
    batch = jittered(replicate(state, worlds))
    return batch.to(dev), batch, cfg


def hooked(scene, batch, i):
    """Frame i of a scene up to its step: its pre_step and on_step hooks."""
    if scene.pre_step is not None:
        batch = scene.pre_step(batch)
    if scene.on_step is not None:
        new = scene.on_step(batch, i)
        if new is not None:
            batch = new
    return batch


def frame(scene, step, batch, i):
    """Frame i of a scene: its hooks, then one step."""
    return step(hooked(scene, batch, i), DT)


def card_vs_cpu(gpu, cpu, far):
    """(largest position difference, within tolerance, colors equal,
    diagnostics equal) of a batch stepped on the card against the same
    steps through the plain twins on the CPU. The position tolerance is
    phase 5's 1e-4, plus FAR_RTOL of the coordinate on the Far scenes."""
    import torch

    g, c = gpu.bodies.position.cpu(), cpu.bodies.position
    diff = (g - c).abs()
    close = bool((diff <= 1e-4 + (FAR_RTOL * c.abs() if far else 0.0)).all())
    colors = bool(torch.equal(gpu.contacts.color.cpu(), cpu.contacts.color)
                  and torch.equal(gpu.joints.color.cpu(), cpu.joints.color))
    diag = all(torch.equal(getattr(gpu.diag, k).cpu(), getattr(cpu.diag, k))
               for k in ("color_overflow", "pair_overflow", "contact_count", "pair_count"))
    return float(diff.max()), close, colors, diag


def run_catalog_scene(key, solver, dev, card, counters, compare=True, short=False):
    """Phase 8 for one scene under one solver: CATALOG_WORLDS worlds, the
    first CATALOG_CHECK steps on the card and, if `compare`, through the
    twins on the CPU, compared (the Joint Grid's world 0 only); then the
    card alone to the scene's run length (a solver only the XLA route runs,
    or a `short` run of a fused solver: CATALOG_CHECK + XLA_ONLY_STEPS),
    timed after those steps; launches, finiteness and the scene's bounds. A
    `short` run on the fused route also holds K1 to its twin on the card on
    the inputs of its last solve. Returns a dict of its figures."""
    import torch

    from solver2d_tpu_torch import batched_step
    from solver2d_tpu_torch.solvers import graphs
    from solver2d_tpu_torch.utils.metrics import joint_error, kinetic_energy

    scene = catalog_scene(key, solver)
    gpu, cpu, cfg = catalog_batch(scene, dev)
    if key == ("Joints", "Joint Grid"):
        cpu = cpu.map(lambda x: x[:1])
    fused = bool(cfg.use_fused_solver)
    step = batched_step(cfg)
    n = (CATALOG_RUN.get(key, CATALOG_CHECK + STEPS) if solver in FUSED and not short
         else CATALOG_CHECK + XLA_ONLY_STEPS)
    cpu0 = cpu.map(lambda x: x.clone())
    if compare:
        for i in range(CATALOG_CHECK):
            cpu = frame(scene, step, cpu, i)
    for c in counters:
        c.launches = 0
    worst_joint = torch.zeros(CATALOG_WORLDS, device=dev)
    for i in range(CATALOG_CHECK):
        gpu = frame(scene, step, gpu, i)
        worst_joint = torch.maximum(worst_joint, joint_error(gpu))
    err, close, colors, diag = (card_vs_cpu(gpu.map(lambda x: x[:cpu.bodies.type.shape[0]]), cpu, "origin" in scene.meta)
                                if compare else (float("nan"), True, True, True))
    spread = None
    if compare and not close and solver in XLA_ONLY:
        # a scene that the solver blows up (Jacobi on Ragdoll Stress) turns
        # the round-off of its first step into position differences of
        # order 1 by the third: hold the card to the CPU's own spread
        # under a change of the initial velocities by one ulp
        bumped = cpu0.map(lambda x: x.clone())
        bumped.bodies.v = torch.nextafter(bumped.bodies.v, torch.full_like(bumped.bodies.v, float("inf")))
        for i in range(CATALOG_CHECK):
            bumped = frame(scene, step, bumped, i)
        spread = float((bumped.bodies.position - cpu.bodies.position).abs().max())
        close = err <= 1e-4 + spread
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CATALOG_CHECK, n):
        last = hooked(scene, gpu, i)  # the last step's input
        gpu = step(last, DT)
        worst_joint = torch.maximum(worst_joint, joint_error(gpu))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (n - CATALOG_CHECK) * 1e3
    launches = [c.launches for c in counters]
    k1_err = None
    if short and fused:  # after the launches are read: these launches compare
        k1_err = check_k1(f"{key[0]}/{key[1]}, the last of {n} steps", last, cfg, CATALOG_WORLDS, dev, card,
                          timed=False, steps=0, scene=scene, k2=False)[0]
    del last
    d = gpu.diag
    b = gpu.bodies
    out = dict(
        scene=f"{key[0]}/{key[1]}", solver=solver, route="fused" if fused else "XLA", bodies=int(b.alive[0].sum()),
        shapes=int(gpu.shapes.alive[0].sum()), joints=int(gpu.joints.alive[0].sum()), steps=n, ms_per_step=ms,
        world_steps_per_s=CATALOG_WORLDS / ms * 1e3, err=err, colors_equal=colors, diag_equal=diag,
        k1_launches=launches[0], k2_launches=launches[1], contacts=int(d.contact_count[0]),
        color_overflow=int(d.color_overflow.max()), pair_overflow=bool(d.pair_overflow.any()),
        pair_overflow_0=bool(d.pair_overflow[0]), max_penetration=float(d.max_penetration[0]),
        kinetic_energy=float(kinetic_energy(gpu)[0]), joint_error=float(worst_joint[0]),
        joint_error_all=float(worst_joint.max()), k1_err=k1_err,
    )
    checked = (f"{CATALOG_CHECK} steps card vs CPU twins{' (world 0)' if cpu.bodies.type.shape[0] == 1 else ''}: "
               f"position err {err:.3e}" + (f" (the CPU's spread under a 1-ulp change of the initial velocities "
                                            f"{spread:.3e})" if spread is not None else "")
               + f", colors equal {colors}, diagnostics equal {diag}; " if compare else "")
    print(f"[8] {out['scene']} {solver} ({out['route']} route): {out['bodies']} bodies, {out['shapes']} shapes, "
          f"{out['joints']} joints, {CATALOG_WORLDS} worlds; {checked}after {n} steps: contacts {out['contacts']}, "
          f"world 0 max penetration {out['max_penetration']:.6f}, kinetic energy {out['kinetic_energy']:.6f}, "
          f"largest joint_error world 0 {out['joint_error']:.6f}, any world {out['joint_error_all']:.6f}; K1 "
          f"{launches[0]}, K2 {launches[1]} launches; {ms:.2f} ms/step, {out['world_steps_per_s']:.1f} world-steps/s, "
          f"pair overflow world 0 {out['pair_overflow_0']} / any {out['pair_overflow']}, color overflow max "
          f"{out['color_overflow']} on {card}", flush=True)
    graphs.clear()
    if not finite(b):
        fail(f"{out['scene']} {solver}: non-finite body state")
    if not (close and colors and diag):
        fail(f"{out['scene']} {solver}: the card disagrees with the CPU twins")
    if launches != [n if fused else 0, n]:
        fail(f"{out['scene']} {solver}: K1 launched {launches[0]}, K2 {launches[1]} times in {n} steps "
             f"({out['route']} route)")
    if solver in FUSED and bool(d.pair_overflow[0]) and key not in PAIR_OVERFLOW_SCENES:
        fail(f"{out['scene']} {solver}: pair table overflow in world 0")
    for metric, bound in CATALOG_BOUNDS.get((key, solver), {}).items():
        if not out[metric] < bound:
            fail(f"{out['scene']} {solver}: {metric} {out[metric]} >= its bound {bound}")
    if (key == ("Contact", "Warm Start Energy") and n >= CATALOG_RUN[key]
            and bool(b.alive[:, scene.meta["top"]].any())):
        fail("Warm Start Energy: the top circle outlived its step-120 event")
    return out


def run_xla_path(path, solver, layout, dev, card, counters, secondary=None):
    """Phase 9 for one path, solver and layout (phase 10 for one of the
    SECONDARY settings of path (b)): the first 3 steps of XLA_CHECK_WORLDS
    jittered worlds on the card and on the CPU, compared; then WARMUP +
    STEPS steps of the path's worlds on the card, gated. Returns a dict of
    its figures."""
    import torch

    from solver2d_tpu_torch import batched_step, replicate
    from solver2d_tpu_torch.solvers import graphs
    from solver2d_tpu_torch.utils.metrics import joint_error

    kw = dict(use_fused_solver=False, **SECONDARY.get(secondary, {}))
    if layout == "bucketed":
        kw.update(contact_bucket_cap=-1, joint_bucket_cap=-1)
    state, cfg = (pyramid_b if path == "b" else bridge_a)("cpu", solver, **kw)
    W = W_B if path == "b" else W_A
    step = batched_step(cfg)
    cpu = jittered(replicate(state, XLA_CHECK_WORLDS))
    gpu = cpu.to(dev)
    for _ in range(3):
        cpu, gpu = step(cpu, DT), step(gpu, DT)
    err, close, colors, diag = card_vs_cpu(gpu, cpu, False)
    del gpu
    batch = replicate(state.to(dev), W)
    init_pos = batch.bodies.position.clone()
    tag = "10" if secondary else "9"
    what = f"{solver} {layout}" + (f" {secondary}" if secondary else "")
    label = (f"[{tag}] XLA route {what}, path ({path}): {W} worlds x "
             + (f"base-{BASE_B} pyramid" if path == "b" else "Bridge") + f" (buckets {cfg.contact_bucket_cap} contacts, "
             f"{cfg.joint_bucket_cap} joints a color; broadphase {cfg.broadphase}, incremental coloring "
             f"{cfg.incremental_coloring})")
    batch, ms, launches = run_path(label, lambda b: step(b, DT), batch, W, card, counters)
    b, c, d = batch.bodies, batch.contacts, batch.diag
    if path == "b":
        dyn = (b.type[0] == 2) & b.alive[0]
        metric, value = "largest box displacement", float((b.position - init_pos)[:, dyn].norm(dim=-1).max())
    else:
        metric, value = "joint_error max", float(joint_error(batch).max())
    bound = SECONDARY_BOUNDS[secondary] if secondary else XLA_BOUNDS[(path, layout)][solver]
    out = dict(path=path, solver=solver, layout=layout, secondary=secondary, ms_per_step=ms,
               world_steps_per_s=W / ms * 1e3, err=err, value=value, bound=bound, k1_launches=launches[0],
               k2_launches=launches[1], color_overflow=int(d.color_overflow.max()),
               pair_overflow=bool(d.pair_overflow.any()), contacts=int(d.contact_count[0]))
    persisted = ""
    if solver == "TGS_STICKY":
        # the share of live contacts whose friction anchors held this step
        touching = c.alive & (c.point_count > 0)
        out["persisted_share"] = float((c.friction_persisted & touching).sum()) / max(int(touching.sum()), 1)
        persisted = f", friction anchors persisted on {out['persisted_share']:.1%} of the live contacts"
    print(f"[{tag}] {what} ({path}): 3 steps of {XLA_CHECK_WORLDS} worlds card vs CPU: position err "
          f"{err:.3e}, colors equal {colors}, diagnostics equal {diag}; after {WARMUP + STEPS} steps: {metric} "
          f"{value:.6f} (bound {bound:.6f}), contacts {out['contacts']}, color overflow max {out['color_overflow']}, "
          f"pair overflow any {out['pair_overflow']}{persisted}; K1 {launches[0]}, K2 {launches[1]} launches",
          flush=True)
    graphs.clear()
    if not (close and colors and diag):
        fail(f"XLA route {what} ({path}): the card disagrees with the CPU")
    if not finite(b):
        fail(f"XLA route {what} ({path}): non-finite body state")
    if out["color_overflow"] != 0:
        fail(f"XLA route {what} ({path}): color overflow")
    if secondary == "sap" and out["pair_overflow"]:
        fail(f"XLA route {what} ({path}): pair overflow")
    if not value < bound:
        fail(f"XLA route {what} ({path}): {metric} {value} >= {bound}")
    if launches != [0, WARMUP + STEPS]:
        fail(f"XLA route {what} ({path}): K1 launched {launches[0]}, K2 {launches[1]} times in "
             f"{WARMUP + STEPS} steps")
    if solver == "TGS_STICKY" and path == "b" and not out["persisted_share"] > 0:
        fail(f"XLA route {what} ({path}): no friction anchor persisted")
    del batch, init_pos
    torch.cuda.empty_cache()
    return out


def run_interaction(dev, card, counters):
    """Phase 11: picking, dragging, raycasts, queries, runtime edits and the
    utility modules on path (b) on the card, with the first steps after the
    attach held to the CPU, and K1 and K2 held to their twins with the
    mouse joint live. Returns a dict of its figures."""
    import tempfile

    import torch

    from solver2d_tpu_torch import batched_step, pyramid_world, replicate, queries, SolverType
    from solver2d_tpu_torch.solvers import fused_cuda
    from solver2d_tpu_torch.solvers.fused_solve import fused_solve_plain
    from solver2d_tpu_torch.solvers.loops import fused_static
    from solver2d_tpu_torch.step import prepare
    from solver2d_tpu_torch.utils import checkpoint, checks, profiling, runtime
    from solver2d_tpu_torch.utils.metrics import gjk_stats

    _, ids = pyramid_world(SolverType.TGS_SOFT, BASE_B)
    top = ids[-1]
    state, cfg = pyramid_b("cpu", "TGS_SOFT", max_joints=16)
    if not cfg.use_fused_solver:
        fail("phase 11: path (b) under TGS_Soft is not on the fused route")
    step = batched_step(cfg)
    # worlds w and w + 8 alike, jittered by (w mod 8) * JITTER
    host = jittered(replicate(state, 8)).map(lambda x: x.repeat((W_B // 8,) + (1,) * (x.dim() - 1)))
    gpu = host.to(dev)
    cpu = host.map(lambda x: x[:INTERACT_CPU_WORLDS].clone())
    S = int(cfg.max_shapes)
    worlds = (0, INTERACT_WORLD)
    slot = 0

    for c in counters:
        c.launches = 0
    steps = 0
    for _ in range(INTERACT_WARMUP):
        gpu, cpu = step(gpu, DT), step(cpu, DT)
        steps += 1

    # pick the top box at its center in two worlds, attach in every world
    center = gpu.bodies.position[:, top].clone()  # [W, 2]
    picks = {}
    for w in worlds:
        found, body = queries.pick_body(gpu, center[w], world=w)
        picks[w] = (bool(found), int(body))
    if any(p != (True, top) for p in picks.values()):
        fail(f"phase 11: pick_body at the top box's center found {picks}, not body {top}")
    goal = center + torch.tensor([1.0, 1.0], device=dev)  # the last drag target
    gpu = queries.attach_mouse_joint(gpu, slot, top, center, hertz=5.0)
    cpu = queries.attach_mouse_joint(cpu, slot, top, center[:INTERACT_CPU_WORLDS].cpu(), hertz=5.0)
    dist0 = float((gpu.bodies.position[:, top] - goal).norm(dim=-1).max())
    held = None
    for i in range(INTERACT_DRAG):
        target = center + (i + 1) / INTERACT_DRAG * torch.tensor([1.0, 1.0], device=dev)
        gpu = queries.move_mouse_target(gpu, slot, target)
        cpu = queries.move_mouse_target(cpu, slot, target[:INTERACT_CPU_WORLDS].cpu())
        if i == 0:
            held = gpu  # a step's input with the mouse joint live
        gpu, cpu = step(gpu, DT), step(cpu, DT)
        steps += 1
    dist1 = float((gpu.bodies.position[:, top] - goal).norm(dim=-1).max())
    err, close, colors, diag = card_vs_cpu(gpu.map(lambda x: x[:INTERACT_CPU_WORLDS]), cpu, False)
    gpu = queries.detach_mouse_joint(gpu, slot)

    # raycasts, culled against brute force; AABB query and point test
    rays = {}
    for w in worlds:
        y = float(center[w, 1]) - 4.0
        p1, p2 = (-30.0, y), (30.0, y)
        culled = queries.raycast_world(gpu, p1, p2, world=w)
        brute = queries.raycast_world(gpu, p1, p2, max_candidates=S, world=w)
        same = all(torch.equal(a, b) for a, b in zip(culled, brute))
        rays[w] = dict(hit=bool(culled.hit), shape=int(culled.shape), fraction=float(culled.fraction), same=same)
        if not (same and bool(culled.hit)):
            fail(f"phase 11: raycast_world in world {w}: culled {culled} against brute force {brute}")
        top_shape = int(torch.nonzero(gpu.shapes.body[w] == top)[0, 0])
        c = gpu.bodies.position[w, top]
        boxed = queries.query_aabb(gpu, c - 0.1, c + 0.1, world=w)
        inside = queries.test_point(gpu, c, world=w)
        if not (bool(boxed[top_shape]) and bool(inside[top_shape]) and int(inside.sum()) == 1):
            fail(f"phase 11: query_aabb / test_point at the top box in world {w}")

    # one of each runtime edit, then steps
    alive_before = gpu.bodies.alive.clone()
    gpu = queries.attach_mouse_joint(gpu, slot + 1, ids[-3], gpu.bodies.position[:, ids[-3]], hertz=5.0)
    gpu = runtime.destroy_joint(gpu, slot + 1)
    gpu = runtime.set_bodies_alive(gpu, [ids[-2]], False)
    gpu = runtime.teleport_bodies(gpu, [ids[-4]], [[40.0, 2.0]])
    gpu = runtime.set_linear_velocity(gpu, ids[-5], (0.5, 0.0))
    gpu = runtime.set_angular_velocity(gpu, ids[-5], 0.2)
    gpu = runtime.apply_force_to_center(gpu, ids[-6], (5.0, 0.0))
    gpu = runtime.apply_linear_impulse(gpu, ids[-6], (0.2, 0.0), gpu.bodies.position[:, ids[-6]])
    gpu = runtime.set_transform(gpu, ids[-7], (50.0, 2.0), 0.3)
    gpu = runtime.destroy_shape(gpu, int(torch.nonzero(gpu.shapes.body[0] == ids[-8])[0, 0]))
    for _ in range(INTERACT_AFTER):
        gpu = step(gpu, DT)
        steps += 1
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    print(f"[11] interaction on path (b): {W_B} worlds, TGS_Soft on the fused route; picks {picks}; drag: the top "
          f"box's largest distance to its goal {dist0:.4f} -> {dist1:.4f}; card vs CPU ({INTERACT_CPU_WORLDS} worlds, "
          f"{INTERACT_DRAG} steps after the attach): position err {err:.3e}, colors equal {colors}, diagnostics "
          f"equal {diag}; raycasts {rays}; K1 {launches[0]}, K2 {launches[1]} launches in {steps} steps on {card}",
          flush=True)
    if not (close and colors and diag):
        fail("phase 11: the card disagrees with the CPU after the attach")
    if not dist1 < dist0:
        fail(f"phase 11: the dragged box did not near its target ({dist0} -> {dist1})")
    if launches != [steps, steps]:
        fail(f"phase 11: K1 launched {launches[0]}, K2 {launches[1]} times in {steps} steps")
    d = gpu.diag
    if not finite(gpu.bodies) or int(d.color_overflow.max()) != 0:
        fail("phase 11: non-finite state or color overflow after the edits")
    if bool(gpu.bodies.alive[:, ids[-2]].any()) or not torch.equal(gpu.bodies.alive[:, :ids[-2]],
                                                                       alive_before[:, :ids[-2]]):
        fail("phase 11: set_bodies_alive changed other bodies")

    # K1 and K2 against their twins on a step's inputs with the mouse joint live
    x = prepare(held, DT, cfg).x
    static = fused_static(cfg)
    got = fused_cuda.fused_solve(x, **static)
    want = fused_solve_plain(x, **static)
    k1_err = max(float((g - w).abs().max()) if g.numel() else 0.0 for g, w in zip(got, want))
    if not k1_err <= K1_ATOL:
        fail(f"phase 11: K1 disagrees with its twin with the mouse joint live ({k1_err})")
    mouse_rows = int(((x.jint[..., 3] & 2) != 0).sum())
    k2 = check_k2_world("phase 11 (b) with a mouse joint", held, cfg, card)
    print(f"[11] K1 equals its twin with the mouse joint live ({mouse_rows} live joint rows, err {k1_err:.1e}); "
          f"K2 within {k2[0]:.3e}", flush=True)

    # the GJK counters, the structure check, health and reset, checkpoints
    warm = gjk_stats(gpu, gjk_iters=cfg.gjk_iters)
    cold = gjk_stats(gpu, gjk_iters=cfg.gjk_iters, cold=True)
    if not (warm.calls > 0 and cold.cache_hits == 0 and cold.max_iters <= cfg.gjk_iters
            and cold.iters >= warm.iters):
        fail(f"phase 11: gjk_stats warm {warm}, cold {cold}")
    problems = [checks.validate_state(gpu, cfg, world=w) for w in worlds]
    if any(problems):
        fail(f"phase 11: validate_state: {problems}")
    v = gpu.bodies.v[:, top].clone()
    v[BLOWN_WORLD] = 1e6
    blown = runtime.set_linear_velocity(gpu, top, v)
    health = checks.world_health(blown)
    fixed = checks.reset_unhealthy_worlds(blown, gpu)
    if torch.nonzero(~health).flatten().tolist() != [BLOWN_WORLD] or not bool(checks.world_health(fixed).all()):
        fail(f"phase 11: world_health {health.tolist()}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        checkpoint.save_npz(path, gpu)
        back = checkpoint.load_npz(path, device=dev)
    pairs = list(zip(leaves(gpu), leaves(back)))
    if not all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        fail("phase 11: save_npz / load_npz is not equal bit for bit")

    # timing
    timer = profiling.StepTimer()
    batch = gpu
    for _ in range(6):
        batch = timer.timed(step, batch, DT)
    stages = profiling.stage_times(gpu, cfg, repeats=3)
    print(f"[11] gjk_stats warm {warm}, cold {cold}; validate_state []; world_health flags world {BLOWN_WORLD} and "
          f"the reset heals it; save_npz/load_npz equal; StepTimer {timer.ms_per_step:.2f} ms/step (first "
          f"{timer.compile_s * 1e3:.1f} ms); stage_times ms " + ", ".join(f"{k} {t:.2f}" for k, t in stages.items())
          + f" on {card}", flush=True)

    rendered = render_interaction(gpu, dev)
    return dict(steps=steps, k1_launches=launches[0], k2_launches=launches[1], err=err, dist0=dist0, dist1=dist1,
                k1_err=k1_err, k2_err=k2[0], ms_per_step=timer.ms_per_step, stages=stages, rendered=rendered,
                gjk_warm=dataclasses.asdict(warm), gjk_cold=dataclasses.asdict(cold))


def leaves(tree):
    """The tensors of a state, field by field."""
    out = []
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        out += leaves(v) if dataclasses.is_dataclass(v) else [v]
    return out


def same_state(a, b):
    """Every tensor of two states equal, bit for bit."""
    import torch

    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def run_split(dev, card, lane_state, lane_cfg, counters):
    """Phase 12: the world batch split over mesh entries on the card
    (`parallel.sharding`), on `make_mesh()` (the one card) and on a mesh
    that lists the card twice (two shards, each on its own stream): the lane
    path at full width and path (b) under TGS_Soft (fused route) and
    PGS_NGS_Block (XLA route), each equal to the unsharded step bit for bit
    for 3 steps, then gated over WARMUP + STEPS steps; one NCCL rank through
    `distributed`; `ops/manifold.collide` (K2) against its twin on the CPU.
    Returns a dict of its figures."""
    import tempfile

    import torch

    from solver2d_tpu_torch import batched_step, make_mesh, replicate, sharded_step, step_batch
    from solver2d_tpu_torch.ops import manifold
    from solver2d_tpu_torch.parallel import metrics_psum_example
    from solver2d_tpu_torch.parallel.distributed import global_batch, initialize
    from solver2d_tpu_torch.solvers import graphs

    meshes = {"1 shard": make_mesh(), "2 shards": make_mesh([dev, dev])}
    if meshes["1 shard"].size != 1:
        fail(f"phase 12: make_mesh() holds {meshes['1 shard'].size} entries on a one-card machine")
    out = dict(launches={}, ms={}, steps=WARMUP + STEPS)

    # the lane path at the bench configuration: 3 steps against step_batch
    batch = replicate(lane_state, W)
    want = batch
    for _ in range(3):
        want = step_batch(want, DT, lane_cfg)
    for label, mesh in meshes.items():
        for c in counters:
            c.launches = 0
        got = batch
        stepf = sharded_step(lane_cfg, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            got = stepf(got, DT)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        launches = [c.launches for c in counters]
        equal = same_state(got.gather(dev), want)
        out["launches"][f"lane {label}"] = launches
        out["ms"][f"lane {label}"] = ms
        print(f"[12] lane path {W} worlds x base-{BASE} on {label}: 3 steps equal to step_batch bit for bit "
              f"{equal}; K1 {launches[0]}, K2 {launches[1]} launches; {ms:.2f} ms/step on {card}", flush=True)
        if not equal:
            fail(f"phase 12: the lane path on {label} differs from step_batch")
        if launches != [0, 3 * mesh.size]:
            fail(f"phase 12: the lane path on {label}: K1 launched {launches[0]}, K2 {launches[1]} times in 3 steps")
        del got
    # the manifold of the first-step pairs of two lane worlds, as
    # `ops/manifold.collide` takes them (per pair, a [2, C] batch)
    del batch, want
    s1 = step_batch(replicate(lane_state, 2), DT, lane_cfg)
    c, sh, bo = s1.contacts, s1.shapes, s1.bodies
    worlds = torch.arange(2, device=dev)[:, None]
    sa, sb = c.shape_a.long(), c.shape_b.long()
    args = (sh.verts[worlds, sa], sh.normals[worlds, sa], sh.count[worlds, sa], sh.radius[worlds, sa],
            sh.verts[worlds, sb], sh.normals[worlds, sb], sh.count[worlds, sb], sh.radius[worlds, sb],
            bo.origin[worlds, c.body_a.long()], bo.rot[worlds, c.body_a.long()],
            bo.origin[worlds, c.body_b.long()], bo.rot[worlds, c.body_b.long()],
            c.cache_count, c.cache_index_a, c.cache_index_b)
    k0 = counters[1].launches
    on_card = manifold.collide(*args, gjk_iters=lane_cfg.gjk_iters)
    torch.cuda.synchronize()
    k2_manifold = counters[1].launches - k0
    on_cpu = manifold.collide(*(a.cpu() for a in args), gjk_iters=lane_cfg.gjk_iters)
    ints = all(torch.equal(g.cpu(), w) for g, w in zip(on_card, on_cpu) if not g.dtype.is_floating_point)
    m_err = max(float((g.cpu() - w).abs().max()) for g, w in zip(on_card, on_cpu) if g.dtype.is_floating_point)
    n_pts = int((on_cpu.point_count > 0).sum())
    print(f"[12] ops/manifold.collide on [2, {c.key.shape[1]}] first-step pairs of the lane scene ({n_pts} with "
          f"points): K2 {k2_manifold} launch; card vs CPU twin: integers equal {ints}, floats max abs err "
          f"{m_err:.3e} (tol {K2_ATOL})", flush=True)
    if not (ints and m_err <= K2_ATOL and k2_manifold == 1 and n_pts > 0):
        fail("phase 12: ops/manifold.collide on the card disagrees with its twin")
    out["manifold_err"] = m_err
    del s1, args, on_card, on_cpu
    torch.cuda.empty_cache()

    # path (b): 3 steps of jittered worlds against batched_step, then the
    # gated run of phase 6 (phase 9's bound on the XLA route)
    for solver in ("TGS_SOFT", "PGS_NGS_BLOCK"):
        state_b, cfg_b = pyramid_b(dev, solver)
        fused = bool(cfg_b.use_fused_solver)
        if fused != (solver == "TGS_SOFT"):
            fail(f"phase 12: path (b) {solver} is not on the route expected")
        step = batched_step(cfg_b)
        start = jittered(replicate(state_b.to("cpu"), W_B)).to(dev)
        want = start
        for _ in range(3):
            want = step(want, DT)
        bound = MAX_DRIFT_B[solver] if fused else XLA_BOUNDS[("b", "dense")][solver]
        for label, mesh in meshes.items():
            stepf = sharded_step(cfg_b, mesh)
            got = start
            for _ in range(3):
                got = stepf(got, DT)
            equal = same_state(got.gather(dev), want)
            batch = replicate(state_b, W_B)
            init_pos = batch.bodies.position.clone()
            batch, ms, launches = run_path(f"[12] path (b) {solver} on {label}", lambda b: stepf(b, DT), batch, W_B,
                                           card, counters)
            batch = batch.gather(dev)
            b, d = batch.bodies, batch.diag
            dyn = (b.type[0] == 2) & b.alive[0]
            drift = float((b.position - init_pos)[:, dyn].norm(dim=-1).max())
            out["launches"][f"(b) {solver} {label}"] = launches
            out["ms"][f"(b) {solver} {label}"] = ms
            n = WARMUP + STEPS
            print(f"[12] path (b) {solver} ({'fused' if fused else 'XLA'} route) on {label}: 3 steps of jittered "
                  f"worlds equal to batched_step bit for bit {equal}; after {n} steps: largest box displacement "
                  f"{drift:.6f} (bound {bound:.6f}), color overflow max {int(d.color_overflow.max())}; K1 "
                  f"{launches[0]}, K2 {launches[1]} launches", flush=True)
            if not equal:
                fail(f"phase 12: path (b) {solver} on {label} differs from batched_step")
            if not finite(b) or int(d.color_overflow.max()) != 0:
                fail(f"phase 12: path (b) {solver} on {label}: non-finite state or color overflow")
            if not drift < bound:
                fail(f"phase 12: path (b) {solver} on {label}: the pyramid does not stand ({drift} >= {bound})")
            if launches != [n * mesh.size if fused else 0, n * mesh.size]:
                fail(f"phase 12: path (b) {solver} on {label}: K1 launched {launches[0]}, K2 {launches[1]} times "
                     f"in {n} steps")
            del got, batch, init_pos
        graphs.clear()
        torch.cuda.empty_cache()
    print("[12] ms/step, 1 shard against 2 on the one card: " + "; ".join(
        f"{what} {out['ms'][what + ' 1 shard']:.2f} / {out['ms'][what + ' 2 shards']:.2f}"
        for what in ("lane", "(b) TGS_SOFT", "(b) PGS_NGS_BLOCK")) + f" on {card}", flush=True)

    # one NCCL rank: the mesh takes its group in; global_batch and the
    # all_reduce of metrics_psum_example
    state_b, cfg_b = pyramid_b(dev, "TGS_SOFT")
    with tempfile.TemporaryDirectory() as tmp:
        initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0)
        try:
            backend = torch.distributed.get_backend()
            mesh = make_mesh()
            gb = global_batch(state_b, W_B, mesh)
            made = same_state(gb.gather(dev), replicate(state_b, W_B))
            gb = sharded_step(cfg_b, mesh)(gb, DT)
            local = gb.gather(dev)
            ke = metrics_psum_example(gb, mesh)
            want_ke = 0.5 * torch.sum(local.bodies.v ** 2)
            torch.cuda.synchronize()
            reduced = bool(torch.equal(ke, want_ke))
        finally:
            torch.distributed.destroy_process_group()
    print(f"[12] one {backend} rank: group in the mesh {mesh.group is not None}, global_batch equal to replicate "
          f"{made} (worlds {gb.offset}-{gb.offset + gb.local_worlds - 1} of {gb.global_worlds}); all_reduce of "
          f"metrics_psum_example {float(ke):.6f} equal to the local sum {reduced}", flush=True)
    if not (backend == "nccl" and mesh.group is not None and made and reduced):
        fail("phase 12: the one-rank NCCL run")
    torch.cuda.empty_cache()
    return out


def render_interaction(batch, dev):
    """One frame of the batch's world 0 through `render_states`, and a
    4-frame `InteractiveTestbed.record_gif` of Single Box on the card, when
    matplotlib imports; else a line that says so. Returns whether it
    rendered."""
    import tempfile

    try:
        import matplotlib
    except ImportError:
        print("[11] matplotlib is not installed here: rendering skipped (an optional dependency)", flush=True)
        return False
    matplotlib.use("Agg")
    from solver2d_tpu_torch import SolverType
    from solver2d_tpu_torch.interactive import InteractiveTestbed
    from solver2d_tpu_torch.utils.draw import render_states

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        render_states({"TGS_SOFT": batch}, path=png, title="phase 11")
        tb = InteractiveTestbed([SolverType.TGS_SOFT], scene="Contact/Single Box", device=dev)
        gif = tb.record_gif(os.path.join(tmp, "itb.gif"), frames=4, every=1)
        sizes = os.path.getsize(png), os.path.getsize(gif)
    if not all(sizes):
        fail("phase 11: an empty image")
    print(f"[11] rendered a frame ({sizes[0]} bytes) and a 4-frame interactive GIF ({sizes[1]} bytes)", flush=True)
    return True


def run_path(label, step, batch, n_worlds, card, counters):
    """WARMUP + STEPS steps with every launch counter set to 0 first.
    Returns (batch, ms/step, launches)."""
    import torch

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        batch = step(batch)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(STEPS):
        batch = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    launches = [c.launches for c in counters]
    print(f"{label}: {WARMUP} warm-up steps in {t_warm:.2f} s, {STEPS} timed steps: {ms:.2f} ms/step, "
          f"{n_worlds / (ms / 1e3):.1f} world-steps/s on {card}", flush=True)
    return batch, ms, launches


_PHASE = {}


def phase(n: str):
    """Print the seconds since the previous phase began (the first call
    starts the clock), and start phase n's."""
    now = time.perf_counter()
    if _PHASE:
        print(f"[{_PHASE['name']}] phase took {now - _PHASE['t']:.1f} s", flush=True)
    _PHASE.update(name=n, t=now)


def finite(bodies):
    import torch

    return all(bool(torch.isfinite(x).all()) for x in (bodies.position, bodies.v, bodies.w, bodies.rot, bodies.origin))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "solver2d_tpu_torch")):
        fail("run from the root of a checkout: solver2d_tpu_torch/ is missing")
    sys.path.insert(0, here)
    dev = torch.device("cuda", 0)
    # the CPU runs of the plain twins (phases 5 and 8) are thousands of ops
    # on small tensors: one thread each is several times faster than a pool
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    phase("1")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 2. build
    phase("2")
    from solver2d_tpu_torch import _nvcc
    from solver2d_tpu_torch.ops import narrow_cuda
    from solver2d_tpu_torch.solvers import fused_cuda

    t0 = time.perf_counter()
    _nvcc.build([narrow_cuda._SOURCE, fused_cuda._SOURCE])
    narrow_cuda.load()
    fused_cuda.load()
    print(f"[2] built {list(_nvcc.build_log) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in _nvcc.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {src}: {line.strip()}", flush=True)
    k2_attrs = {shape: narrow_cuda.attributes(w) for shape, w in (("lane", W), ("per-world", 1))}
    for shape, at in k2_attrs.items():
        print(f"[2] K2 ({shape} tile {at['tile'][0]} slots x {at['tile'][1]} worlds): {at['registers']} registers, "
              f"{at['spill_bytes']} spill bytes, {at['smem_bytes']} B shared memory, {at['blocks_per_sm']} blocks "
              f"({at['blocks_per_sm'] * at['tile'][0] * at['tile'][1] // 32} warps) an SM", flush=True)

    from solver2d_tpu_torch import SolverType, batched_step, pyramid_world, replicate, step_batch
    from solver2d_tpu_torch.ops.narrow_lanes import collide_lanes_plain
    from solver2d_tpu_torch.step import narrow_inputs
    from solver2d_tpu_torch.utils.metrics import joint_error

    # ---- 3. kernels against their twins at their paths' shapes
    phase("3")
    t0 = time.perf_counter()
    world, ids = pyramid_world(SolverType.TGS_SOFT, BASE)
    max_contacts = ((4 * len(ids) + 127) // 128) * 128
    state0, cfg = world.freeze(device=dev, **bench_config(max_contacts))
    print(f"[3] scene: {len(ids) + 1} bodies, C={cfg.max_contacts}, colors={cfg.max_colors}, "
          f"cap={cfg.contact_bucket_cap}, frozen in {time.perf_counter() - t0:.1f} s", flush=True)
    s1 = step_batch(replicate(state0, W), DT, cfg)
    args = narrow_inputs(s1, s1.contacts)
    C = args[1].shape[0]
    k_out = narrow_cuda.collide(*args, cfg.gjk_iters)
    torch.cuda.synchronize()
    p_out = collide_lanes_plain(*args, cfg.gjk_iters)
    torch.cuda.synchronize()
    fk, ik, ck = k_out
    fp, ip, cp = p_out
    if not torch.isfinite(fk).all():
        fail("K2: non-finite float outputs")
    n_id = int((ik != ip).sum())
    n_cache = int((ck != cp).sum())
    max_abs = float((fk - fp).abs().max())
    live = int((ik[:, 2] > 0).sum())
    print(f"[3] K2 vs twin at W={W} C={C}: {live} slots with points, id/count mismatches {n_id}, "
          f"cache mismatches {n_cache}, float max abs err {max_abs:.3e} (tol {K2_ATOL})", flush=True)
    if n_id or n_cache or not max_abs <= K2_ATOL:
        fail("K2 disagrees with its plain twin")
    k2_ms, k2_call = kernel_ms(lambda: narrow_cuda.collide(*args, cfg.gjk_iters))
    plain_ms = time_cuda(lambda: collide_lanes_plain(*args, cfg.gjk_iters), 3)
    work = k2_work(args, cfg.gjk_iters)
    k2_flops = k2_ops(work)
    k2_lane_bound, bytes_ms, ops_ms, k2_bytes = k2_bound(args, k2_flops)
    print(f"[3] K2 {k2_ms:.4f} ms ({k2_call:.4f} ms a call), plain twin {plain_ms:.3f} ms; "
          f"bound {k2_lane_bound:.3f} ms "
          f"({k2_bytes / 1e9:.3f} GB -> {bytes_ms:.3f} ms; at most {k2_flops / 1e9:.2f} GFLOP "
          f"-> {ops_ms:.3f} ms), {k2_lane_bound / k2_ms:.1%} of bound on {card}", flush=True)
    sat_share, mixed_share, trips_mean, trips_max = k2_paths(work)
    print(f"[3] K2 on the lane scene: {sat_share:.1%} of slots take SAT, {mixed_share:.1%} of warps mix SAT with "
          f"another path; GJK trips a slot mean {trips_mean:.2f}, max {trips_max} of {cfg.gjk_iters}",
          flush=True)
    del s1, args, k_out, p_out, fk, ik, ck, fp, ip, cp, work
    torch.cuda.empty_cache()

    # K1 in each script: at (b), timed; at (a) with a mouse joint held from
    # the ground, and with one held from a dynamic plank
    k1 = {}
    for solver in FUSED:
        k1[solver] = [
            check_k1(f"(b) {W_B} x base-{BASE_B} pyramid", *pyramid_b(dev, solver), W_B, dev, card),
            check_k1(f"(a) {W_A} x Bridge + mouse joint", *bridge_a(dev, solver, "ground"), W_A, dev, card),
            check_k1(f"(a) {W_A} x Bridge + mouse joint on dynamic plank 79", *bridge_a(dev, solver, "plank"),
                     W_A, dev, card, timed=False),
        ]
    torch.cuda.empty_cache()

    # the catalog's shapes: K2 on the contact tables of catalog scenes after
    # a few steps (circles and capsules, segments, far origins, thin boxes);
    # K1 in each script on Ragdoll Stress once its humans reach the paddles
    k2_catalog, k1_catalog = {}, {}
    for key in K2_CATALOG:
        scene = catalog_scene(key, "TGS_SOFT")
        batch, _, cfg_c = catalog_batch(scene, dev)
        step_c = batched_step(cfg_c)
        for i in range(K2_CATALOG_STEPS):
            batch = frame(scene, step_c, batch, i)
        k2_catalog[key] = check_k2_world(f"{key[0]}/{key[1]} ({CATALOG_WORLDS} worlds, {K2_CATALOG_STEPS} steps)",
                                         batch, cfg_c, card)
    for solver in FUSED:
        scene = catalog_scene(K1_CATALOG, solver)
        batch, _, cfg_c = catalog_batch(scene, dev)
        k1_catalog[solver] = check_k1(f"{K1_CATALOG[1]} after {K1_CATALOG_STEPS} steps", batch, cfg_c,
                                      CATALOG_WORLDS, dev, card, steps=K1_CATALOG_STEPS, scene=scene, k2=False,
                                      mixed=True)
    del batch
    torch.cuda.empty_cache()

    # ---- 4. the lane path
    phase("4")
    batch = replicate(state0, W)
    init_pos = batch.bodies.position.clone()
    batch, ms_step, (launches,) = run_path(
        f"[4] lane path: {W} worlds x {len(ids) + 1} bodies", lambda b: step_batch(b, DT, cfg), batch, W, card,
        [narrow_cuda.collide],
    )
    b = batch.bodies
    d = batch.diag
    dyn = (b.type[0] == 2) & b.alive[0]
    drift = float((b.position - init_pos)[:, dyn].norm(dim=-1).max())
    print(f"[4] contacts {int(d.contact_count[0])}, pairs {int(d.pair_count[0])}, "
          f"color_overflow max {int(d.color_overflow.max())}, pair_overflow any {bool(d.pair_overflow.any())}, "
          f"max penetration {float(d.max_penetration.max()):.5f}, largest box displacement {drift:.5f} "
          f"(bound {MAX_DRIFT}), K2 launches {launches}", flush=True)
    if not finite(b):
        fail("non-finite body state on the lane path")
    if int(d.color_overflow.max()) != 0 or bool(d.pair_overflow.any()):
        fail("overflow on the lane path")
    if not drift < MAX_DRIFT:
        fail(f"the pyramid does not stand: displacement {drift} >= {MAX_DRIFT}")
    if launches != WARMUP + STEPS:
        fail(f"K2 launched {launches} times in {WARMUP + STEPS} steps")
    del batch, init_pos
    torch.cuda.empty_cache()

    # ---- 5. card against CPU on small inputs of both paths
    phase("5")
    w8, _ = pyramid_world(SolverType.TGS_SOFT, 8)
    kw = dict(max_colors=9, gjk_iters=10, contact_bucket_cap=-1)
    sc, cfg8 = w8.freeze(device="cpu", **kw)
    bc, bg = replicate(sc, 4), replicate(sc, 4).to(dev)
    for _ in range(3):
        bc = step_batch(bc, DT, cfg8)
        bg = step_batch(bg, DT, cfg8)
    pos_err = float((bg.bodies.position.cpu() - bc.bodies.position).abs().max())
    same_counts = bool((bg.contacts.point_count.cpu() == bc.contacts.point_count).all())
    print(f"[5] lane path, base-8 pyramid, 4 worlds, 3 steps, card vs CPU: position max abs err {pos_err:.3e}, "
          f"point counts equal {same_counts}", flush=True)
    if not (pos_err < 1e-4 and same_counts):
        fail("the card's lane step disagrees with the CPU's on a small input")
    # the lane path's SoftStep script, on the same small batch
    sc, cfg8s = w8.freeze(device="cpu", solver=SolverType.SOFT_STEP, **kw)
    bc, bg = replicate(sc, 4), replicate(sc, 4).to(dev)
    for _ in range(3):
        bc = step_batch(bc, DT, cfg8s)
        bg = step_batch(bg, DT, cfg8s)
    pos_err = float((bg.bodies.position.cpu() - bc.bodies.position).abs().max())
    same_counts = bool((bg.contacts.point_count.cpu() == bc.contacts.point_count).all())
    print(f"[5] lane path SoftStep, base-8 pyramid, 4 worlds, 3 steps, card vs CPU: position max abs err "
          f"{pos_err:.3e}, point counts equal {same_counts}", flush=True)
    if not (pos_err < 1e-4 and same_counts):
        fail("the card's lane SoftStep step disagrees with the CPU's on a small input")
    from solver2d_tpu_torch import bridge

    for solver in FUSED:
        b4 = bridge(SolverType[solver], 4)[0]
        x, y = b4.bodies[3].def_.position
        b4.create_mouse_joint(1, 3, (x + 0.3, y + 1.0), 5.0, 0.7)
        for label, (sw, cw) in (
            ("base-4 pyramid", pyramid_world(SolverType[solver], 4)[0].freeze(device="cpu", lane_solve=False)),
            ("4-plank Bridge + mouse joint on plank 1", b4.freeze(device="cpu", lane_solve=False)),
        ):
            step = batched_step(cw)
            bc, bg = replicate(sw, 2), replicate(sw, 2).to(dev)
            for _ in range(3):
                bc, bg = step(bc, DT), step(bg, DT)
            pos_err = float((bg.bodies.position.cpu() - bc.bodies.position).abs().max())
            same = bool((bg.contacts.color.cpu() == bc.contacts.color).all()
                        and (bg.joints.color.cpu() == bc.joints.color).all())
            print(f"[5] per-world path {solver}, {label}, 2 worlds, 3 steps, card vs CPU: position max abs err "
                  f"{pos_err:.3e}, colors equal {same}", flush=True)
            if not (pos_err < 1e-4 and same):
                fail(f"the card's per-world step disagrees with the CPU's ({solver}, {label})")

    # ---- 6. path (b): 64 x base-20 pyramid, and 7. path (a): 32 x Bridge,
    phase("6-7")
    # under each fused solver
    ms_b, ms_a, k1_launches = {}, {}, {}
    for solver in FUSED:
        state_b, cfg_b = pyramid_b(dev, solver)
        step_b = batched_step(cfg_b)
        batch = replicate(state_b, W_B)
        init_pos = batch.bodies.position.clone()
        batch, ms_b[solver], (k1_launches[solver], k2_b) = run_path(
            f"[6] path (b) {solver}: {W_B} worlds x base-{BASE_B} pyramid "
            f"({int(state_b.bodies.alive.sum())} bodies)",
            lambda b: step_b(b, DT), batch, W_B, card, [fused_cuda.fused_solve, narrow_cuda.collide],
        )
        b, d = batch.bodies, batch.diag
        dyn = (b.type[0] == 2) & b.alive[0]
        drift = float((b.position - init_pos)[:, dyn].norm(dim=-1).max())
        print(f"[6] {solver}: contacts {int(d.contact_count[0])}, color_overflow max {int(d.color_overflow.max())}, "
              f"pair_overflow any {bool(d.pair_overflow.any())}, largest box displacement {drift:.6f} "
              f"(bound {MAX_DRIFT_B[solver]:.6f}), K1 launches {k1_launches[solver]}, K2 launches {k2_b}",
              flush=True)
        if not finite(b):
            fail(f"non-finite body state on path (b), {solver}")
        if int(d.color_overflow.max()) != 0:
            fail(f"color overflow on path (b), {solver}")
        if not drift < MAX_DRIFT_B[solver]:
            fail(f"path (b), {solver}: the pyramid does not stand: displacement {drift} >= {MAX_DRIFT_B[solver]}")
        if (k1_launches[solver], k2_b) != (WARMUP + STEPS, WARMUP + STEPS):
            fail(f"path (b), {solver}: K1 launched {k1_launches[solver]}, K2 {k2_b} times in {WARMUP + STEPS} steps")
        del batch, init_pos
        torch.cuda.empty_cache()

        state_a, cfg_a = bridge_a(dev, solver)
        step_a = batched_step(cfg_a)
        batch, ms_a[solver], (k1_a_launches,) = run_path(
            f"[7] path (a) {solver}: {W_A} worlds x Bridge ({int(state_a.bodies.alive.sum())} bodies, "
            f"{int(state_a.joints.alive.sum())} joints)",
            lambda b: step_a(b, DT), replicate(state_a, W_A), W_A, card, [fused_cuda.fused_solve],
        )
        jerr = float(joint_error(batch).max())
        print(f"[7] {solver}: joint_error max {jerr:.6f} (bound {MAX_JOINT_ERROR_A[solver]:.6f}), color_overflow max "
              f"{int(batch.diag.color_overflow.max())}, K1 launches {k1_a_launches}", flush=True)
        if not finite(batch.bodies):
            fail(f"non-finite body state on path (a), {solver}")
        if int(batch.diag.color_overflow.max()) != 0:
            fail(f"color overflow on path (a), {solver}")
        if not jerr < MAX_JOINT_ERROR_A[solver]:
            fail(f"path (a), {solver}: the bridge's joints come apart: {jerr} >= {MAX_JOINT_ERROR_A[solver]}")
        if k1_a_launches != WARMUP + STEPS:
            fail(f"path (a), {solver}: K1 launched {k1_a_launches} times in {WARMUP + STEPS} steps")
        del batch
        torch.cuda.empty_cache()
    print(f"[4-7] ms/step: lane path {ms_step:.2f}; " + "; ".join(
        f"{solver} path (b) {ms_b[solver]:.2f}, path (a) {ms_a[solver]:.2f}" for solver in FUSED) + f" on {card}",
        flush=True)

    # ---- 8. the catalog
    phase("8")
    from solver2d_tpu_torch import scene_names

    catalog = []
    for key in scene_names():
        # (solver, short): the scenes outside CATALOG_ALL_SOLVERS run the
        # other fused solvers short, held card to twin (K1 on the last solve)
        runs = [(solver, key not in CATALOG_ALL_SOLVERS and solver != "TGS_SOFT") for solver in FUSED]
        for solver, short in runs + [(solver, False) for solver in XLA_ONLY]:
            compare = not short and (solver in FUSED or key in XLA_CHECK_SCENES)
            catalog.append(run_catalog_scene(key, solver, dev, card, [fused_cuda.fused_solve, narrow_cuda.collide],
                                             compare, short))
            torch.cuda.empty_cache()
    k1_short = [r["k1_err"] for r in catalog if r["k1_err"] is not None]
    print(f"[8] catalog: {len(catalog)} scene runs, every check passed ({len(k1_short)} short fused runs with K1 "
          f"equal to its twin on their last solve); ms/step " + "; ".join(
              f"{r['scene']} {r['solver']} {r['ms_per_step']:.2f}" for r in catalog) + f" on {card}", flush=True)

    # ---- 9. the XLA route on paths (b) and (a)
    phase("9")
    xla_runs = []
    for path in ("b", "a"):
        for solver in XLA:
            for layout in ("dense", "bucketed") if solver in XLA_BUCKETED else ("dense",):
                xla_runs.append(run_xla_path(path, solver, layout, dev, card,
                                             [fused_cuda.fused_solve, narrow_cuda.collide]))
    print("[9] XLA route, every check passed; ms/step " + "; ".join(
        f"({r['path']}) {r['solver']} {r['layout']} {r['ms_per_step']:.2f}" for r in xla_runs) + f" on {card}",
        flush=True)

    # ---- 10. the secondary paths on (b)
    phase("10")
    secondary = [run_xla_path("b", "PGS_NGS_BLOCK", "dense", dev, card, [fused_cuda.fused_solve, narrow_cuda.collide],
                              name) for name in SECONDARY]
    print("[10] secondary paths, every check passed; ms/step " + "; ".join(
        f"{r['secondary']} {r['ms_per_step']:.2f}" for r in secondary) + f" on {card}", flush=True)
    # ---- 11. interaction on path (b)
    phase("11")
    interaction = run_interaction(dev, card, [fused_cuda.fused_solve, narrow_cuda.collide])
    # ---- 12. the world batch split over mesh entries
    phase("12")
    split = run_split(dev, card, state0, cfg, [fused_cuda.fused_solve, narrow_cuda.collide])
    phase("end")

    k2_err = max([max_abs] + [r[0] for r in k2_catalog.values()] + [interaction["k2_err"], split["manifold_err"]])
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {
            "name": "K2 narrowphase", "route": "cuda",
            "source": "solver2d_tpu_torch/csrc/narrow.cu",
            "replaces": "solver2d_tpu/ops/narrow_pallas.py:33",
            "launches": launches, "max_abs_err": k2_err,
            "ms": k2_ms, "plain_ms": plain_ms, "bound_ms": k2_lane_bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "call_ms": k2_call,
            "registers": k2_attrs["lane"]["registers"], "spill_bytes": k2_attrs["lane"]["spill_bytes"],
            "smem_bytes": k2_attrs["lane"]["smem_bytes"], "blocks_per_sm": k2_attrs["lane"]["blocks_per_sm"],
            "sat_share": sat_share, "sat_mixed_warps": mixed_share, "gjk_trips_mean": trips_mean,
            "ms_b": k1["TGS_SOFT"][0][5]["k2_ms"], "bound_ms_b": k1["TGS_SOFT"][0][5]["k2_bound_ms"],
            "bound_by_b": k1["TGS_SOFT"][0][5]["k2_bound_by"],
            "ms_a": k1["TGS_SOFT"][1][5]["k2_ms"], "bound_ms_a": k1["TGS_SOFT"][1][5]["k2_bound_ms"],
            "bound_by_a": k1["TGS_SOFT"][1][5]["k2_bound_by"],
            "catalog": {f"{k[0]}/{k[1]}": dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"), r))
                        for k, r in k2_catalog.items()},
            "launches_phase11": interaction["k2_launches"], "steps_phase11": interaction["steps"],
            "launches_phase12": {k: v[1] for k, v in split["launches"].items()}, "steps_phase12": split["steps"],
        },
    ] + [
        {
            "name": f"K1 fused soft solve ({label})", "route": "cuda",
            "source": "solver2d_tpu_torch/csrc/fused_solve.cu",
            "replaces": "solver2d_tpu/solvers/pallas_solver.py:53",
            "launches": k1_launches[solver],
            "max_abs_err": max([r[0] for r in k1[solver] + [k1_catalog[solver]]]
                               + ([interaction["k1_err"]] if solver == "TGS_SOFT" else [])
                               + [r["k1_err"] for r in catalog if r["k1_err"] is not None and r["solver"] == solver]),
            "ms": k1[solver][0][1], "plain_ms": k1[solver][0][2], "bound_ms": k1[solver][0][3],
            "bound_by": k1[solver][0][4], "library_ms": None,
            **{k: k1[solver][0][5][k] for k in ("call_ms", "phases", "us_per_phase", "registers", "spill_bytes",
                                                 "smem_bytes", "stage_bytes", "blocks_per_sm")},
            "ms_a": k1[solver][1][1], "bound_ms_a": k1[solver][1][3], "phases_a": k1[solver][1][5]["phases"],
            "ms_ragdoll_stress": k1_catalog[solver][1], "plain_ms_ragdoll_stress": k1_catalog[solver][2],
            "bound_ms_ragdoll_stress": k1_catalog[solver][3], "bound_by_ragdoll_stress": k1_catalog[solver][4],
            **({"launches_phase11": interaction["k1_launches"], "steps_phase11": interaction["steps"],
                "launches_phase12": {k: v[0] for k, v in split["launches"].items() if "TGS_SOFT" in k},
                "steps_phase12": split["steps"]}
               if solver == "TGS_SOFT" else {}),
            "checked_phase8_short": sum(r["k1_err"] is not None and r["solver"] == solver for r in catalog),
        }
        for solver, label in zip(FUSED, ("TGS_Soft", "SoftStep", "PGS_Soft"))
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
