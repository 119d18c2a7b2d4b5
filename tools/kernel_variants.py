"""Time the port's two kernels against a parent checkout's on the card, and
K1 at several staging capacities, all in one process.

- K2 (csrc/narrow.cu) on the lane path's inputs (512 worlds x base-62
  pyramid after one step): this tree's kernel and, with `--parent DIR`,
  the kernel built from DIR's sources, its outputs checked bit for bit
  against this tree's.
- K1 (csrc/fused_solve.cu) at path (b) (64 x base-20 pyramid after 2
  steps), in each script, at staging capacities from none to all
  (`stage_bytes`), each checked against the plain twin, and the parent's.
- K1 at many worlds: (b)'s inputs repeated to 512 and 4096 worlds, at the
  wrapper's default capacity, at all, at the largest capacity that lets 2
  or 3 blocks share an SM (`fused_cuda.stage_bytes_for`), at none, and the
  parent's; each checked against this tree's kernel on (b), repeated.

Variants are timed in turns (the list, then the list reversed), each time
the kernel's launches replayed back to back from a CUDA graph
(chip_smoke.graph_ms), with the card's name and power limit printed
beside them. DIR is a checkout of an earlier commit (`git archive <commit>
| tar -x -C DIR`, in a git-ignored directory).

Usage (on a machine with a card):
    python3 tools/kernel_variants.py [--parent DIR] [out.json]
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from solver2d_tpu_torch import SolverType, batched_step, pyramid_world, replicate, step_batch  # noqa: E402
from solver2d_tpu_torch import _nvcc  # noqa: E402
from solver2d_tpu_torch.ops import narrow_cuda  # noqa: E402
from solver2d_tpu_torch.solvers import fused_cuda  # noqa: E402
from solver2d_tpu_torch.solvers.fused_solve import fused_solve_plain  # noqa: E402
from solver2d_tpu_torch.solvers.loops import fused_static  # noqa: E402
from solver2d_tpu_torch.solvers.scripts import SCRIPTS  # noqa: E402
from solver2d_tpu_torch.step import narrow_inputs, prepare  # noqa: E402

WIDE = (512, 4096)


def parent_lib(parent, source):
    """Build `source` of the checkout at `parent` with this tree's flags."""
    out = os.path.join(_nvcc.BUILD, f"parent_{os.path.splitext(source)[0]}.so")
    os.makedirs(_nvcc.BUILD, exist_ok=True)
    subprocess.run([_nvcc.nvcc_path(), *_nvcc.FLAGS, "-o", out,
                    os.path.join(parent, "solver2d_tpu_torch", "csrc", source)], check=True, capture_output=True)
    return ctypes.CDLL(out)


def k1_parent_call(lib, x, static):
    """The parent's K1 (no staging argument, no barrier count)."""
    W, B = x.bs.shape[:2]
    C, J = x.cint.shape[1], x.jint.shape[1]
    outs = [torch.empty_like(t) for t in (x.bs, x.n_imp, x.t_imp, x.jimp)]
    scratch = [torch.empty((W, 2 * n, 3), device=x.bs.device) for n in (C, J)]
    ins = [x.body_const, x.bs, x.cfields, x.cint, x.n_imp, x.t_imp, x.jfields, x.jint, x.jimp, x.c_off, x.c_ent,
           x.j_off, x.j_ent, x.scal]
    rc = lib.s2t_fused_solve(*(t.data_ptr() for t in (*ins, *outs, *scratch)), W, B, C, J, static["n_colors"],
                             static["n_joint_colors"], SCRIPTS.index(static["script"]), static["substeps"],
                             int(static["relax"]), int(static["warm_start"]), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cudaError {rc}")
    return outs


def k2_parent_call(lib, args, iters):
    geom, sa, sb, pa, pb, cache = args
    W, _, C = pa.shape
    outs = (torch.empty((W, 12, C), device=pa.device), torch.empty((W, 3, C), dtype=torch.int32, device=pa.device),
            torch.empty((W, 7, C), dtype=torch.int32, device=pa.device))
    rc = lib.s2t_collide_lanes(*(t.data_ptr() for t in (*args, *outs)), W, C, iters,
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cudaError {rc}")
    return outs


def in_turns(calls, want, what):
    """Time each call, the list then the list reversed, after checking its
    outputs equal `want`. Returns {name: [ms, ms]}."""
    times = {name: [] for name in calls}
    for turn in (list(calls), list(calls)[::-1]):
        for name in turn:
            got = calls[name]()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                sys.exit(f"{what}: {name!r} differs")
            times[name].append(chip_smoke.graph_ms(calls[name]))
    return times


def widen(x, reps):
    """x with its worlds repeated `reps` times (h and 1/h kept)."""
    return x._replace(**{f: getattr(x, f).repeat(reps, *[1] * (getattr(x, f).dim() - 1))
                         for f in x._fields if f != "scal"})


def main():
    argv = sys.argv[1:]
    parent = None
    if argv[:1] == ["--parent"]:
        parent, argv = os.path.abspath(argv[1]), argv[2:]
    out_path = argv[0] if argv else None
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"card: {card}, {sms} SMs", flush=True)
    report = {"card": card, "sms": sms, "k2": {}, "k1": {}, "k1_wide": {}}

    # K2 at the lane shape
    world, ids = pyramid_world(SolverType.TGS_SOFT, chip_smoke.BASE)
    max_contacts = ((4 * len(ids) + 127) // 128) * 128
    state0, cfg = world.freeze(device=dev, **chip_smoke.bench_config(max_contacts))
    s1 = step_batch(replicate(state0, chip_smoke.W), chip_smoke.DT, cfg)
    args = narrow_inputs(s1, s1.contacts)
    calls = {"this tree": lambda: narrow_cuda.collide(*args, cfg.gjk_iters)}
    if parent:
        k2p = parent_lib(parent, narrow_cuda._SOURCE)
        k2p.s2t_collide_lanes.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        calls = {"parent": lambda: k2_parent_call(k2p, args, cfg.gjk_iters), **calls}
    at = narrow_cuda.attributes(chip_smoke.W)
    times = in_turns(calls, calls["this tree"](), "K2")
    for name, ms in times.items():
        report["k2"][name] = dict(ms=ms, **(at if name == "this tree" else {}))
        print(f"K2 {name:9s} {' '.join(f'{t:.4f}' for t in ms)} ms"
              + (f"; {at['registers']} registers, {at['spill_bytes']} spill bytes, {at['smem_bytes']} B shared, "
                 f"{at['blocks_per_sm']} blocks an SM, tile {at['tile'][0]} x {at['tile'][1]}"
                 if name == "this tree" else ""), flush=True)
    del s1, args
    torch.cuda.empty_cache()

    k1p = None
    if parent:
        k1p = parent_lib(parent, fused_cuda._SOURCE)
        k1p.s2t_fused_solve.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    for solver in chip_smoke.FUSED:
        state, cfg_b = chip_smoke.pyramid_b(dev, solver)
        step = batched_step(cfg_b)
        batch = replicate(state, chip_smoke.W_B)
        for _ in range(2):
            batch = step(batch, chip_smoke.DT)
        x = prepare(batch, chip_smoke.DT, cfg_b).x
        static = fused_static(cfg_b)
        script = static["script"]
        B, C, J = x.bs.shape[1], x.cint.shape[1], x.jint.shape[1]

        # K1 staging capacities at (b)
        full = fused_cuda.stage_bytes_default(script, B, C, J)
        # the group tables and the lists, which K1 carves first
        lists = 4 * 128 + (4 * C + 15) // 16 * 16 + (4 * J + 15) // 16 * 16
        caps = {"none": 0, "lists only": lists, "half": full // 32 * 16, "all": full}
        want = fused_solve_plain(x, **static)
        calls = {name: (lambda cap=cap: fused_cuda.fused_solve(x, **static, stage_bytes=cap))
                 for name, cap in caps.items()}
        if k1p:
            calls = {"parent": lambda: k1_parent_call(k1p, x, static), **calls}
        ktimes = in_turns(calls, want, f"K1 {solver} at (b)")
        phases = torch.empty(chip_smoke.W_B, dtype=torch.int32, device=dev)
        fused_cuda.fused_solve(x, **static, phases=phases)
        n_ph = int(phases.max())
        report["k1"][solver] = {name: dict(stage_bytes=caps.get(name), ms=ktimes[name]) for name in calls}
        report["k1"][solver]["phases"] = n_ph
        for name in calls:
            what = f"staging {name:10s} ({caps[name]:6d} B)" if name in caps else "the parent's kernel     "
            print(f"K1 {solver:9s} (b) {what}: {' '.join(f'{t:.4f}' for t in ktimes[name])} ms, "
                  f"{n_ph if name in caps else 'its own'} barriers", flush=True)

        # K1 at many worlds: (b)'s worlds repeated
        want = fused_cuda.fused_solve(x, **static)
        for wide in WIDE:
            reps = wide // chip_smoke.W_B
            xw = widen(x, reps)
            want_w = [w.repeat(reps, *[1] * (w.dim() - 1)) for w in want]
            caps = {"default": None, "all": full, "none": 0}
            for k in (2, 3):
                cap = fused_cuda.stage_bytes_for(script, B, k)
                if cap is not None:
                    caps[f"{k} blocks an SM"] = min(cap, full)
            calls = {name: (lambda cap=cap: fused_cuda.fused_solve(xw, **static, stage_bytes=cap))
                     for name, cap in caps.items()}
            if k1p:
                calls = {"parent": lambda: k1_parent_call(k1p, xw, static), **calls}
            wtimes = in_turns(calls, want_w, f"K1 {solver} at {wide} worlds")
            caps["default"] = fused_cuda.stage_bytes_default(script, B, C, J, wide, dev)
            rows = {}
            for name in calls:
                ms = " ".join(f"{t:.4f}" for t in wtimes[name])
                if name == "parent":
                    rows[name] = dict(ms=wtimes[name])
                    print(f"K1 {solver:9s} {wide:4d} worlds, the parent's kernel: {ms} ms", flush=True)
                    continue
                n_sm = fused_cuda.attributes(script, caps[name], B)["blocks_per_sm"]
                rows[name] = dict(stage_bytes=caps[name], ms=wtimes[name], blocks_per_sm=n_sm)
                print(f"K1 {solver:9s} {wide:4d} worlds, {name:15s} ({caps[name]:6d} B staged, {n_sm} block(s) an "
                      f"SM): {ms} ms", flush=True)
            report["k1_wide"].setdefault(solver, {})[wide] = rows
            del xw, want_w
            torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
