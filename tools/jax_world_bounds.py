"""How the JAX package's per-world step moves the scenes of the port's
per-world path, and how far the port is from it.

Steps the reference package (`solver2d_tpu`: `step.step` with the XLA
solver, which runs the same per-constraint code as its fused TPU kernel, on
the CPU, op by op) and the PyTorch port (`solver2d_tpu_torch.step`, on the
CPU, through the plain twins of K1 and K2) from the same frozen world at
the configurations of `chip_smoke.py`:

- pyramid: the base-20 pyramid (211 bodies; 896 contacts, 10 colors,
  GJK 10): the largest displacement of a box from its start;
- bridge: the 160-plank Bridge (161 revolute joints, 8 colors): the largest
  joint separation (`joint_error`);
- catalog scenes at their published size and configuration (phase 8 of
  `chip_smoke.py`): "Contact/Vertical Stack" and "Contact/Overlap Recovery"
  (the deepest contact penetration and the kinetic energy), "Joints/Ragdoll
  Stress" (`joint_error`, and its largest value over the run).

Both run the solver given (TGS_SOFT by default, or any of the ten solvers
of the port's per-world step); the JAX package always with its XLA solver
(`use_pallas_solver=False`), the port on the route its `freeze` picks (K1
for the soft solvers where a world fits it), or on its XLA route with
`--xla`. `--bucketed` runs both on the color-bucketed layout
(`contact_bucket_cap=-1`, `joint_bucket_cap=-1`, sized by the JAX
`freeze`); `--sap` with the sweep-and-prune broadphase at chip_smoke's
settings (`SAP_KW`: a window of 48, and as many shape slots as shapes);
`--mis` with the per-step MIS coloring (`incremental_coloring=False`).
Prints both after every step, and the largest position difference between
the two. The JAX figures, doubled, set chip_smoke's MAX_DRIFT_B,
MAX_JOINT_ERROR_A, CATALOG_BOUNDS, XLA_BOUNDS and SECONDARY_BOUNDS.

Usage: python tools/jax_world_bounds.py pyramid|bridge|"Category/Name" [steps] [solver] [--xla] [--bucketed]
       [--sap] [--mis]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from solver2d_tpu.config import SolverType  # noqa: E402
from solver2d_tpu.models import build  # noqa: E402
from solver2d_tpu.models.contact_scenes import pyramid_world  # noqa: E402
from solver2d_tpu.models.joint_scenes import bridge  # noqa: E402
from solver2d_tpu.step import step  # noqa: E402
from solver2d_tpu.utils.metrics import joint_error, kinetic_energy  # noqa: E402
import solver2d_tpu_torch as port  # noqa: E402
from solver2d_tpu_torch.utils.metrics import joint_error as port_joint_error  # noqa: E402
from solver2d_tpu_torch.utils.metrics import kinetic_energy as port_kinetic_energy  # noqa: E402


# chip_smoke.py's sweep-and-prune settings (its SAP_KW)
SAP_WINDOW = 48


def main(scene: str = "pyramid", steps: int = 23, solver: str = "TGS_SOFT", xla: bool = False,
         bucketed: bool = False, sap: bool = False, mis: bool = False):
    kw = dict(narrowphase="lanes", use_pallas_solver=False)
    if bucketed:
        kw.update(contact_bucket_cap=-1, joint_bucket_cap=-1)
    if mis:
        kw.update(incremental_coloring=False)
    if scene == "pyramid":
        w, _ = pyramid_world(SolverType.TGS_SOFT, 20)
    elif scene == "bridge":
        w = bridge(SolverType.TGS_SOFT).world
    else:
        sc = build(*scene.split("/", 1), SolverType[solver])
        assert sc.pre_step is None and sc.on_step is None, "a scene with hooks"
        w = sc.world
    if sap:
        kw.update(broadphase="sap", sap_window=SAP_WINDOW, max_shapes=len(w.shapes))
    if scene == "pyramid":
        state, cfg = w.freeze(solver=SolverType[solver], max_contacts=896, max_colors=10, gjk_iters=10, **kw)
    elif scene == "bridge":
        state, cfg = w.freeze(solver=SolverType[solver], max_colors=8, **kw)
    else:
        state, cfg = sc.freeze(**kw)
        if not sc.world.joints:
            # the JAX solver's joint phases over an empty table change nothing
            cfg = cfg.replace(solve_joints=False)
    pcfg = port.SimConfig(**{k: getattr(cfg, k) for k in port.SimConfig.__dataclass_fields__ if hasattr(cfg, k)})
    pcfg = pcfg.replace(lane_solve=False, use_fused_solver=False if xla else None)
    print(f"{scene} {solver}: JAX use_pallas_solver={cfg.use_pallas_solver}, contact_bucket_cap "
          f"{cfg.contact_bucket_cap}, joint_bucket_cap {cfg.joint_bucket_cap}, broadphase {cfg.broadphase} "
          f"(window {cfg.sap_window}, {cfg.max_shapes} shape slots), incremental_coloring "
          f"{cfg.incremental_coloring}; port route "
          f"{'fused' if port.config.use_fused(pcfg) else 'XLA'}", flush=True)
    pstep = port.batched_step(pcfg)
    pbatch = port.replicate(port.state_from_numpy(jax.tree.map(np.asarray, state), device="cpu"), 1)
    p0 = np.asarray(state.bodies.position)
    dyn = np.asarray(state.bodies.type) == 2
    worst = worst_port = 0.0
    for i in range(steps):
        with jax.disable_jit():
            state = step(state, jnp.float32(1.0 / 60.0), cfg)
        pbatch = pstep(pbatch, 1.0 / 60.0)
        pos = np.asarray(state.bodies.position)
        ppos = pbatch.bodies.position[0].numpy()
        if scene == "pyramid":
            m = float(np.linalg.norm((pos - p0)[dyn], axis=-1).max())
            pm = float(np.linalg.norm((ppos - p0)[dyn], axis=-1).max())
            what = "largest box displacement"
        elif scene == "bridge" or cfg.solve_joints:
            m = float(joint_error(state))
            pm = float(port_joint_error(pbatch)[0])
            worst, worst_port = max(worst, m), max(worst_port, pm)
            what = f"joint_error (largest so far JAX {worst:.6f}, port {worst_port:.6f})"
        else:
            m, pm = float(state.diag.max_penetration), float(pbatch.diag.max_penetration[0])
            what = (f"kinetic energy JAX {float(kinetic_energy(state)):.6f}, port "
                    f"{float(port_kinetic_energy(pbatch)[0]):.6f}; max penetration")
        print(f"{scene} {solver} step {i + 1}: {what} JAX {m:.6f}, port {pm:.6f}; largest position difference "
              f"{np.abs(pos - ppos).max():.3e}; color_overflow JAX {int(state.diag.color_overflow)}, "
              f"port {int(pbatch.diag.color_overflow[0])}; pair_overflow JAX {bool(state.diag.pair_overflow)}, "
              f"port {bool(pbatch.diag.pair_overflow[0])}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(args[0] if args else "pyramid", int(args[1]) if len(args) > 1 else 23,
         args[2] if len(args) > 2 else "TGS_SOFT", xla="--xla" in sys.argv, bucketed="--bucketed" in sys.argv,
         sap="--sap" in sys.argv, mis="--mis" in sys.argv)
