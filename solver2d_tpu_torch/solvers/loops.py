"""The solver scripts of the per-world step.

Port of the JAX package's `solvers/loops.py` for its fused solvers
(`_solve_pallas`, :460-488): TGS_Soft (reference:
src/solve_tgs_soft.c:138-280), SoftStep (src/solve_soft_step.c:182-311)
and PGS_Soft (src/solve_pgs_soft.c:127-242). Prepare the soft contacts and
joints, run the solver's whole script in one launch of K1
(`fused_cuda.fused_solve`), then finalize positions and store the impulses
for the next step's warm start.
"""

from __future__ import annotations

import torch

from ..config import CONTACT_HERTZ, JOINT_HERTZ, SimConfig, SolverType
from . import joints as jk
from .common import finalize_positions, prepare_contacts, store_impulses, unpack_body_state
from .fused_cuda import fused_solve
from .fused_solve import fused_inputs
from .scripts import SOLVER_SCRIPTS, step_size


def _finish(bodies, contacts, joints, cons, jcons, bs, n_imp, t_imp, jimp5):
    v, w, dp, rot = unpack_body_state(bs)
    bodies = finalize_positions(bodies, dp, rot, v, w)
    contacts = store_impulses(contacts, cons, n_imp, t_imp)
    jimp = jk.JointImp(jimp5[..., 0:2], jimp5[..., 2], jimp5[..., 3], jimp5[..., 4])
    return bodies, contacts, jk.store_impulses(joints, jcons, jimp)


def prepare_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt, cfg: SimConfig):
    """Prepare the soft contacts and joints of a batch of worlds ([W, ...]
    state, gravity [W, 2], dt a 0-dim float32 tensor) and pack the fused
    solve's inputs. Returns (inputs, contact cons, joint cons)."""
    W = bodies.type.shape[0]
    worlds = torch.arange(W, device=dt.device)[:, None]
    script = SOLVER_SCRIPTS[cfg.solver]
    h, inv_h = step_size(script, dt, cfg.iterations)
    contact_hertz = torch.clamp(script.contact_hertz * inv_h, max=CONTACT_HERTZ)
    joint_hertz = torch.clamp(script.joint_hertz * inv_h, max=JOINT_HERTZ)

    bconst = torch.cat(
        [bodies.inv_mass[..., None], bodies.inv_inertia[..., None], bodies.rot, bodies.local_center], dim=-1
    )
    cons, n_imp, t_imp = prepare_contacts(
        contacts, bconst[worlds, contacts.body_a], bconst[worlds, contacts.body_b],
        h=h, hertz=contact_hertz, warm_start=cfg.warm_start,
    )
    # the substep solvers keep the joints' stored impulses unconditionally,
    # PGS_Soft only with the warm start (loops.py:_solve_pallas's joint_warm)
    jcons, jimp = jk.prepare_joints(bodies, joints, h=h, hertz=joint_hertz, warm_start=script.loop == "substep" or cfg.warm_start)
    x = fused_inputs(
        bodies, gravity, contacts.body_a, contacts.body_b, cons, n_imp, t_imp, ccolor, cmap,
        joints.body_a, joints.body_b, jcons, jimp, jcolor, jmap, h, inv_h,
    )
    return x, cons, jcons


def fused_static(cfg: SimConfig) -> dict:
    """The fused solve's static arguments for a configuration: the
    solver's script, and one relax pass a substep (the substep loop) or
    `extra_iterations` after the position integrate (the PGS loop)."""
    script = SOLVER_SCRIPTS[cfg.solver]
    relax = int(cfg.extra_iterations > 0) if script.loop == "substep" else cfg.extra_iterations
    return dict(script=script, substeps=cfg.iterations, relax=relax, warm_start=cfg.warm_start,
                n_colors=cfg.max_colors, n_joint_colors=cfg.joint_max_colors)


def solve_prepared(bodies, contacts, joints, x, cons, jcons, cfg: SimConfig):
    """Run the fused solve (one launch of K1 on the card) on what
    `prepare_fused` made of these bodies, contacts and joints. Returns
    (bodies, contacts, joints)."""
    bs, n_imp, t_imp, jimp5 = fused_solve(x, **fused_static(cfg))
    return _finish(bodies, contacts, joints, cons, jcons, bs, n_imp, t_imp, jimp5)


def solve_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt, cfg: SimConfig):
    """cfg.solver on a batch of worlds through the fused solve (the JAX
    package's `_solve_pallas`). Returns (bodies, contacts, joints)."""
    x, cons, jcons = prepare_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt, cfg)
    return solve_prepared(bodies, contacts, joints, x, cons, jcons, cfg)


def solve_tgs_soft_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt, cfg: SimConfig):
    """TGS_Soft through the fused solve (the JAX `loops.solve_tgs_soft`)."""
    return solve_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt,
                       cfg.replace(solver=SolverType.TGS_SOFT))


def solve_soft_step_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt, cfg: SimConfig):
    """SoftStep through the fused solve (the JAX `loops.solve_soft_step`)."""
    return solve_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt,
                       cfg.replace(solver=SolverType.SOFT_STEP))


def solve_pgs_soft_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt, cfg: SimConfig):
    """PGS_Soft through the fused solve (the JAX `loops.solve_pgs_soft`)."""
    return solve_fused(bodies, contacts, joints, ccolor, cmap, jcolor, jmap, gravity, dt,
                       cfg.replace(solver=SolverType.PGS_SOFT))
