"""Where the port's per-world step on the card first parts from the same
step on the CPU.

Steps one world of a chip_smoke.py per-world scene on the card (kernels K1
and K2) and on the CPU (their plain twins) side by side. Each step it
compares, in pipeline order, the contact table after the narrowphase, the
fused solve's packed inputs, the solve's outputs and the stepped bodies,
and prints every tensor that differs with its largest absolute difference,
then the scene's metric on both sides (largest box displacement for the
pyramid, `joint_error` for the Bridge). Each side steps its own state, so
a difference, once there, carries on. The warm-start plans' entries past
the kept ones (`x.c_ent`, `x.j_ent`) are the sort's order of equal keys,
which differs between devices; K1 and its twin never read them.

Usage (on a machine with a card):
    python3 tools/card_vs_cpu.py pyramid|bridge [solver] [steps]
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from solver2d_tpu_torch import replicate  # noqa: E402
from solver2d_tpu_torch.solvers.loops import fused_static, solve_prepared  # noqa: E402
from solver2d_tpu_torch.solvers.fused_cuda import fused_solve  # noqa: E402
from solver2d_tpu_torch.step import _post_solve, prepare  # noqa: E402
from solver2d_tpu_torch.utils.metrics import joint_error  # noqa: E402


def leaves(prefix, obj):
    """(name, tensor) of every tensor of a dataclass, NamedTuple or tuple."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif hasattr(obj, "_fields") or not isinstance(obj, tuple):
        for k in obj._fields if hasattr(obj, "_fields") else vars(obj):
            yield from leaves(f"{prefix}.{k}", getattr(obj, k))
    else:
        for k, v in enumerate(obj):
            yield from leaves(f"{prefix}[{k}]", v)


def differ(label, got, want):
    """Print the tensors of `got` (card) that differ from `want` (CPU)."""
    n = 0
    for (name, g), (_, w) in zip(leaves(label, got), leaves(label, want)):
        g = g.cpu()
        if g.shape != w.shape or not torch.equal(g, w):
            d = float((g.double() - w.double()).abs().max()) if g.shape == w.shape else float("nan")
            print(f"  {name}: max abs difference {d:.3e}", flush=True)
            n += 1
    return n


def main(scene="pyramid", solver="PGS_SOFT", steps=23):
    dev = torch.device("cuda", 0)
    if scene == "pyramid":
        state, cfg = chip_smoke.pyramid_b("cpu", solver)
    else:
        state, cfg = chip_smoke.bridge_a("cpu", solver)
    cpu = replicate(state, 1)
    card = cpu.to(dev)
    p0 = cpu.bodies.position.clone()
    dyn = (cpu.bodies.type[0] == 2) & cpu.bodies.alive[0]
    dt = chip_smoke.DT
    for i in range(steps):
        print(f"step {i + 1}:", flush=True)
        pc, pg = prepare(cpu, dt, cfg), prepare(card, dt, cfg)
        n = differ("contacts", pg.contacts, pc.contacts)
        n += differ("x", pg.x, pc.x)
        n += differ("solve", fused_solve(pg.x, **fused_static(cfg)), fused_solve(pc.x, **fused_static(cfg)))
        outs = []
        for b, p in ((cpu, pc), (card, pg)):
            bodies, contacts, joints = solve_prepared(b.bodies, p.contacts, p.joints, p.x, p.cons, p.jcons, cfg)
            outs.append(_post_solve(b, bodies, contacts, joints, p.pairs.count, p.pairs.overflow, p.sbt,
                                    p.touching, p.overflow))
        cpu, card = outs
        n += differ("bodies", card.bodies, cpu.bodies)
        if scene == "pyramid":
            m = [float((b.bodies.position.cpu() - p0)[:, dyn].norm(dim=-1).max()) for b in (cpu, card)]
            what = "largest box displacement"
        else:
            m = [float(joint_error(b).max()) for b in (cpu, card)]
            what = "joint_error"
        print(f"  {n} tensors differ; {what} CPU {m[0]:.6f}, card {m[1]:.6f}", flush=True)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main(sys.argv[1] if len(sys.argv) > 1 else "pyramid", sys.argv[2] if len(sys.argv) > 2 else "PGS_SOFT",
         int(sys.argv[3]) if len(sys.argv) > 3 else 23)
