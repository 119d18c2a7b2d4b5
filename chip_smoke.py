#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs a CUDA
card, nvcc and the `solver2d_tpu_torch` package beside this file; without
them it exits non-zero and prints no result. Phases (any failure exits 1):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every kernel from the sources in the checkout (nvcc, in parallel);
3. hold each kernel against its plain PyTorch twin on the card at the main
   path's shapes: K2 on the contact table after the first step of the
   512-world base-62 pyramid (7936 contacts per world); integer outputs
   must be equal, floats within K2_ATOL;
4. the main path: `step_batch` on 512 worlds x 1954 bodies at the bench
   configuration (TGS_Soft, 4 substeps + relax, 9 colors, bucket cap 896,
   GJK 10), WARMUP + STEPS steps with every launch counter reset first;
   the state must stay finite, without color or pair overflow, the pyramid
   must stand (largest box displacement below MAX_DRIFT), and every kernel
   must have launched in that run;
5. the same step on the card and on the CPU (plain twins) for a small
   pyramid must agree.

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

    t0 = time.perf_counter()
    narrow_cuda.load()
    print(f"[2] built {list(_nvcc.build_log) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in _nvcc.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {src}: {line.strip()}", flush=True)

    from solver2d_tpu_torch import SolverType, pyramid_world, replicate, step_batch
    from solver2d_tpu_torch.ops.narrow_lanes import collide_lanes_plain
    from solver2d_tpu_torch.step import narrow_inputs

    # ---- 3. kernels against their twins at the main path's shapes
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

    # ---- 4. the main path
    batch = replicate(state0, W)
    init_pos = batch.bodies.position.clone()
    narrow_cuda.collide.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        batch = step_batch(batch, DT, cfg)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(STEPS):
        batch = step_batch(batch, DT, cfg)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = narrow_cuda.collide.launches
    ms_step = elapsed / STEPS * 1e3
    b = batch.bodies
    finite = all(bool(torch.isfinite(x).all()) for x in (b.position, b.v, b.w, b.rot, b.origin))
    d = batch.diag
    dyn = (b.type[0] == 2) & b.alive[0]
    drift = float((b.position - init_pos)[:, dyn].norm(dim=-1).max())
    print(f"[4] main path: {W} worlds x {len(ids) + 1} bodies, {WARMUP} warm-up steps in {t_warm:.2f} s, "
          f"{STEPS} timed steps: {ms_step:.2f} ms/step, {W / (ms_step / 1e3):.1f} world-steps/s "
          f"on {card}", flush=True)
    print(f"[4] contacts {int(d.contact_count[0])}, pairs {int(d.pair_count[0])}, "
          f"color_overflow max {int(d.color_overflow.max())}, pair_overflow any {bool(d.pair_overflow.any())}, "
          f"max penetration {float(d.max_penetration.max()):.5f}, largest box displacement {drift:.5f} "
          f"(bound {MAX_DRIFT}), K2 launches {launches}", flush=True)
    print('kernels: ["K2 narrowphase"]', flush=True)
    if not finite:
        fail("non-finite body state")
    if int(d.color_overflow.max()) != 0 or bool(d.pair_overflow.any()):
        fail("overflow on the main path")
    if not drift < MAX_DRIFT:
        fail(f"the pyramid does not stand: displacement {drift} >= {MAX_DRIFT}")
    if launches != WARMUP + STEPS:
        fail(f"K2 launched {launches} times in {WARMUP + STEPS} steps")
    del batch, state0, init_pos
    torch.cuda.empty_cache()

    # ---- 5. card against CPU on a small input
    w8, _ = pyramid_world(SolverType.TGS_SOFT, 8)
    kw = dict(max_colors=9, gjk_iters=10, contact_bucket_cap=-1)
    sc, cfg8 = w8.freeze(device="cpu", **kw)
    bc, bg = replicate(sc, 4), replicate(sc, 4).to(dev)
    for _ in range(3):
        bc = step_batch(bc, DT, cfg8)
        bg = step_batch(bg, DT, cfg8)
    pos_err = float((bg.bodies.position.cpu() - bc.bodies.position).abs().max())
    same_counts = bool((bg.contacts.point_count.cpu() == bc.contacts.point_count).all())
    print(f"[5] base-8 pyramid, 4 worlds, 3 steps, card vs CPU: position max abs err {pos_err:.3e}, "
          f"point counts equal {same_counts}", flush=True)
    if not (pos_err < 1e-4 and same_counts):
        fail("the card's step disagrees with the CPU's on a small input")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "K2 narrowphase", "route": "cuda",
        "source": "solver2d_tpu_torch/csrc/narrow.cu",
        "replaces": "solver2d_tpu/ops/narrow_pallas.py:33",
        "launches": launches, "max_abs_err": max_abs,
        "ms": k2_ms, "plain_ms": plain_ms, "bound_ms": k2_bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
