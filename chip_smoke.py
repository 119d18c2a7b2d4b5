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
   of the 512-world base-62 pyramid (7936 contacts per world); K1 on the
   per-world step's solve after 2 steps of 64 base-20 pyramids (211 bodies,
   896 contacts) and of 32 Bridges (161 bodies, 161 revolute joints) with
   a mouse joint on plank 80. Integer outputs must be equal, floats within
   K2_ATOL / K1_ATOL;
4. the lane path: `step_batch` on 512 worlds x 1954 bodies at the bench
   configuration (TGS_Soft, 4 substeps + relax, 9 colors, bucket cap 896,
   GJK 10), WARMUP + STEPS steps with every launch counter reset first;
   the state must stay finite, without color or pair overflow, the pyramid
   must stand (largest box displacement below MAX_DRIFT), and K2 must have
   launched once a step;
5. the same steps on the card and on the CPU (plain twins) for small
   scenes of both paths must agree;
6. path (b) of the per-world step (`batched_step`): 64 base-20 pyramids
   (TGS_Soft, 4 substeps + relax, 10 colors, GJK 10), WARMUP + STEPS
   steps: finite, no color overflow, the pyramid stands (MAX_DRIFT_B), K1
   and K2 once a step;
7. path (a): 32 Bridges (8 colors), WARMUP + STEPS steps: finite, joints
   hold (joint_error below MAX_JOINT_ERROR_A), K1 once a step.

The line before the last is a JSON object with each kernel's numbers; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

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
K1_ATOL = 1e-5
# the per-world path's scenes: (b) base-20 pyramids, (a) Bridges
W_B, BASE_B = 64, 20
W_A = 32
# Largest box displacement of path (b) after WARMUP + STEPS steps: twice
# the JAX package's 0.026405 on the CPU at this configuration and step
# count (tools/jax_world_bounds.py pyramid 23).
MAX_DRIFT_B = 0.053
# Largest revolute joint separation of path (a) after WARMUP + STEPS
# steps: twice the JAX package's 0.004900 on the CPU
# (tools/jax_world_bounds.py bridge 23).
MAX_JOINT_ERROR_A = 0.0098
# Largest box displacement allowed after WARMUP + STEPS steps. The JAX
# package on the CPU moves the boxes of a base-20 pyramid by at most 0.0264
# after 23 steps at this configuration (tools/jax_pyramid_drift.py 20 23).
# Each row sinks under the weight above it, so the sink grows with the
# square of the base: (62/20)^2 x 0.0264 = 0.254 for the bench pyramid. The
# bound is twice that; a collapsing pyramid moves boxes by a box size (1.0)
# or more.
MAX_DRIFT = 0.5
# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s, fp32 67 TFLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def bench_config(max_contacts):
    """The configuration `bench.py` runs by default (bench.py:56-83)."""
    return dict(max_contacts=max_contacts, max_colors=9, gjk_iters=10, contact_bucket_cap=896)


def pyramid_b(dev):
    """Path (b): the base-20 pyramid of the JAX package's K1 chip runs
    (exp/step_variants.py:16-18,38,44-49)."""
    from solver2d_tpu_torch import SolverType, pyramid_world

    world, _ = pyramid_world(SolverType.TGS_SOFT, BASE_B)
    return world.freeze(device=dev, lane_solve=False, max_contacts=896, max_colors=10, gjk_iters=10)


def bridge_a(dev, mouse=False):
    """Path (a): the catalog Bridge (exp/chip_joint_pallas.py:26-35), with a
    mouse joint dragging plank 80 when asked."""
    from solver2d_tpu_torch import SolverType, bridge

    world, planks = bridge(SolverType.TGS_SOFT)
    if mouse:
        x, y = world.bodies[planks[80]].def_.position
        world.create_mouse_joint(0, planks[80], (x + 0.5, y + 2.0), 5.0, 0.7)
    return world.freeze(device=dev, lane_solve=False, max_colors=8)


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


def k1_bytes(x):
    """The bytes K1's function must move on these inputs: the int row of
    every contact and joint slot (to find the live ones); for each active
    contact the 27 float columns the solve reads (not r_a0, r_b0 and
    separation, columns 15-24) and its 4 impulses in and out; for each live
    joint its 23 float columns and 5 impulses in and out; the body state in
    and out and the body constants; h and 1/h. The port's warm-start plans
    (c_off, c_ent, j_off, j_ent) and delta scratch belong to its design, not
    to the function, and are left out."""
    from solver2d_tpu_torch.solvers.fused_solve import C_ACTIVE, J_ACTIVE

    n_c = int(((x.cint[..., 3] & C_ACTIVE) != 0).sum())
    n_j = int(((x.jint[..., 3] & J_ACTIVE) != 0).sum())
    slots = (x.cint.numel() + x.jint.numel()) * 4
    contacts = n_c * (27 + 2 * 4) * 4
    joints_ = n_j * (23 + 2 * 5) * 4
    bodies = (2 * x.bs.numel() + x.body_const.numel()) * 4
    return slots + contacts + joints_ + bodies + x.scal.numel() * 4


def check_k1(name, state, cfg, W, dev):
    """K1 against its twin on the inputs the per-world step hands it after 2
    steps of W worlds. Returns (max abs error, kernel ms, twin ms, bound ms,
    bound_by)."""
    import torch

    from solver2d_tpu_torch import batched_step, replicate
    from solver2d_tpu_torch.solvers import contact_kernels as ck
    from solver2d_tpu_torch.solvers import fused_cuda, joints
    from solver2d_tpu_torch.solvers.fused_solve import unpack_cons, unpack_joints, fused_solve_plain
    from solver2d_tpu_torch.solvers.loops import fused_static
    from solver2d_tpu_torch.step import prepare

    step = batched_step(cfg)
    batch = replicate(state, W)
    for _ in range(2):
        batch = step(batch, DT)
    x = prepare(batch, DT, cfg).x
    static = fused_static(cfg)
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
    print(f"[3] K1 vs twin, {name}: W={W} B={x.bs.shape[1]} C={x.cint.shape[1]} J={x.jint.shape[1]}, "
          f"{n_c} active contacts, {n_j} live joints; max abs err bodies {errs[0]:.3e}, normal impulses "
          f"{errs[1]:.3e}, tangent impulses {errs[2]:.3e}, joint impulses {errs[3]:.3e} (tol {K1_ATOL})",
          flush=True)
    if not err <= K1_ATOL:
        fail(f"K1 disagrees with its plain twin ({name})")
    k_ms = time_cuda(lambda: fused_cuda.fused_solve(x, **static), 20)
    p_ms = time_cuda(lambda: fused_solve_plain(x, **static), 2)

    # the bound: the bytes this run's data needs moved once, and the
    # operations of the constraint solves it needs (each active winner
    # solved once a pass, 2 passes a substep)
    nbytes = k1_bytes(x)
    solved_c = int((((flags & 4) != 0) & ((flags & 32) != 0) & (x.cint[..., 2] >= 0)).sum())
    solved_j = int((((jflags & 2) != 0) & ((jflags & 64) != 0) & (x.jint[..., 2] >= 0)).sum())
    w0 = lambda t: t[0]  # noqa: E731
    cons = unpack_cons(x.cfields[0], flags[0])
    jc = unpack_joints(x.jfields[0], jflags[0])
    C, J = x.cint.shape[1], x.jint.shape[1]
    rc = [torch.zeros((C, 2), device=dev), torch.zeros(C, device=dev)] * 2
    q = torch.zeros((C, 2), device=dev)
    _, ops_c = count_float_ops(lambda: ck.solve_contact_core(
        cons, rc[0], rc[1], rc[2], rc[3], q, q, q, q, w0(x.n_imp), w0(x.t_imp), ck.TGS_SOFT, x.scal[1], True))
    rj = [torch.zeros((J, 2), device=dev), torch.zeros(J, device=dev)] * 2
    qj = torch.zeros((J, 2), device=dev)
    imp = joints.JointImp(x.jimp[0, :, 0:2], x.jimp[0, :, 2], x.jimp[0, :, 3], x.jimp[0, :, 4])
    _, ops_j = count_float_ops(lambda: joints.solve_joint_core(
        jc, rj[0], rj[1], rj[2], rj[3], qj, qj, qj, qj, imp, x.scal[0], x.scal[1], True, True))
    ops = static["substeps"] * 2 * (solved_c * ops_c / C + solved_j * ops_j / J)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_F32_S * 1e3
    bound = max(bytes_ms, ops_ms)
    print(f"[3] K1 {name}: {k_ms:.3f} ms, plain twin {p_ms:.3f} ms; bound {bound:.4f} ms "
          f"({nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms; {ops / 1e9:.4f} GFLOP -> {ops_ms:.4f} ms)", flush=True)
    return err, k_ms, p_ms, bound, "bytes" if bytes_ms >= ops_ms else "operations"


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 2. build
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

    from solver2d_tpu_torch import SolverType, batched_step, pyramid_world, replicate, step_batch
    from solver2d_tpu_torch.ops.narrow_lanes import collide_lanes_plain
    from solver2d_tpu_torch.step import narrow_inputs
    from solver2d_tpu_torch.utils.metrics import joint_error

    # ---- 3. kernels against their twins at their paths' shapes
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
    p_out, twin_ops = count_float_ops(lambda: collide_lanes_plain(*args, cfg.gjk_iters))
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
    k2_ms = time_cuda(lambda: narrow_cuda.collide(*args, cfg.gjk_iters), 20)
    plain_ms = time_cuda(lambda: collide_lanes_plain(*args, cfg.gjk_iters), 3)
    S = args[0].shape[0]
    k2_bytes = W * C * (2 * 16 + 28) + W * C * 88 + C * 8 + S * 34 * 4
    bytes_ms = k2_bytes / PEAK_BYTES_S * 1e3
    ops_ms = twin_ops / PEAK_F32_S * 1e3
    k2_bound = max(bytes_ms, ops_ms)
    print(f"[3] K2 {k2_ms:.3f} ms, plain twin {plain_ms:.3f} ms; bound {k2_bound:.3f} ms "
          f"({k2_bytes / 1e9:.3f} GB -> {bytes_ms:.3f} ms; {twin_ops / 1e9:.2f} GFLOP of the twin "
          f"-> {ops_ms:.3f} ms)", flush=True)
    del s1, args, k_out, p_out, fk, ik, ck, fp, ip, cp
    torch.cuda.empty_cache()

    state_b, cfg_b = pyramid_b(dev)
    state_a, cfg_a = bridge_a(dev)
    k1_b = check_k1("(b) 64 x base-20 pyramid", state_b, cfg_b, W_B, dev)
    k1_a = check_k1("(a) 32 x Bridge + mouse joint", *bridge_a(dev, mouse=True), W_A, dev)
    torch.cuda.empty_cache()

    # ---- 4. the lane path
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
    del batch, state0, init_pos
    torch.cuda.empty_cache()

    # ---- 5. card against CPU on small inputs of both paths
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
    from solver2d_tpu_torch import bridge

    for label, (sw, cw) in (
        ("base-4 pyramid", pyramid_world(SolverType.TGS_SOFT, 4)[0].freeze(device="cpu", lane_solve=False)),
        ("4-plank Bridge", bridge(SolverType.TGS_SOFT, 4)[0].freeze(device="cpu", lane_solve=False)),
    ):
        step = batched_step(cw)
        bc, bg = replicate(sw, 2), replicate(sw, 2).to(dev)
        for _ in range(3):
            bc, bg = step(bc, DT), step(bg, DT)
        pos_err = float((bg.bodies.position.cpu() - bc.bodies.position).abs().max())
        same = bool((bg.contacts.color.cpu() == bc.contacts.color).all() and (bg.joints.color.cpu() == bc.joints.color).all())
        print(f"[5] per-world path, {label}, 2 worlds, 3 steps, card vs CPU: position max abs err {pos_err:.3e}, "
              f"colors equal {same}", flush=True)
        if not (pos_err < 1e-4 and same):
            fail(f"the card's per-world step disagrees with the CPU's ({label})")

    # ---- 6. path (b): 64 x base-20 pyramid
    step_b = batched_step(cfg_b)
    batch = replicate(state_b, W_B)
    init_pos = batch.bodies.position.clone()
    batch, ms_b, (k1_launches, k2_b) = run_path(
        f"[6] path (b): {W_B} worlds x base-{BASE_B} pyramid ({int(state_b.bodies.alive.sum())} bodies)",
        lambda b: step_b(b, DT), batch, W_B, card, [fused_cuda.fused_solve, narrow_cuda.collide],
    )
    b, d = batch.bodies, batch.diag
    dyn = (b.type[0] == 2) & b.alive[0]
    drift = float((b.position - init_pos)[:, dyn].norm(dim=-1).max())
    print(f"[6] contacts {int(d.contact_count[0])}, color_overflow max {int(d.color_overflow.max())}, "
          f"pair_overflow any {bool(d.pair_overflow.any())}, largest box displacement {drift:.6f} "
          f"(bound {MAX_DRIFT_B}), K1 launches {k1_launches}, K2 launches {k2_b}", flush=True)
    if not finite(b):
        fail("non-finite body state on path (b)")
    if int(d.color_overflow.max()) != 0:
        fail("color overflow on path (b)")
    if not drift < MAX_DRIFT_B:
        fail(f"path (b): the pyramid does not stand: displacement {drift} >= {MAX_DRIFT_B}")
    if (k1_launches, k2_b) != (WARMUP + STEPS, WARMUP + STEPS):
        fail(f"path (b): K1 launched {k1_launches}, K2 {k2_b} times in {WARMUP + STEPS} steps")
    del batch, init_pos
    torch.cuda.empty_cache()

    # ---- 7. path (a): 32 x Bridge
    step_a = batched_step(cfg_a)
    batch, ms_a, (k1_a_launches,) = run_path(
        f"[7] path (a): {W_A} worlds x Bridge ({int(state_a.bodies.alive.sum())} bodies, "
        f"{int(state_a.joints.alive.sum())} joints)",
        lambda b: step_a(b, DT), replicate(state_a, W_A), W_A, card, [fused_cuda.fused_solve],
    )
    jerr = float(joint_error(batch).max())
    print(f"[7] joint_error max {jerr:.6f} (bound {MAX_JOINT_ERROR_A}), color_overflow max "
          f"{int(batch.diag.color_overflow.max())}, K1 launches {k1_a_launches}", flush=True)
    if not finite(batch.bodies):
        fail("non-finite body state on path (a)")
    if not jerr < MAX_JOINT_ERROR_A:
        fail(f"path (a): the bridge's joints come apart: {jerr} >= {MAX_JOINT_ERROR_A}")
    if k1_a_launches != WARMUP + STEPS:
        fail(f"path (a): K1 launched {k1_a_launches} times in {WARMUP + STEPS} steps")
    print(f"[8] ms/step: lane path {ms_step:.2f}, path (b) {ms_b:.2f}, path (a) {ms_a:.2f} on {card}", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {
            "name": "K2 narrowphase", "route": "cuda",
            "source": "solver2d_tpu_torch/csrc/narrow.cu",
            "replaces": "solver2d_tpu/ops/narrow_pallas.py:33",
            "launches": launches, "max_abs_err": max_abs,
            "ms": k2_ms, "plain_ms": plain_ms, "bound_ms": k2_bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        },
        {
            "name": "K1 fused soft solve (TGS_Soft)", "route": "cuda",
            "source": "solver2d_tpu_torch/csrc/fused_solve.cu",
            "replaces": "solver2d_tpu/solvers/pallas_solver.py:53",
            "launches": k1_launches, "max_abs_err": max(k1_b[0], k1_a[0]),
            "ms": k1_b[1], "plain_ms": k1_b[2], "bound_ms": k1_b[3], "bound_by": k1_b[4],
            "library_ms": None,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
