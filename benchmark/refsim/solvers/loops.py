"""The solver scripts of the per-world step, on its two routes.

Port of the JAX package's `solvers/loops.py`, as far as the benchmark's
cells run it.

The fused route (`_solve_pallas`, :460-488): TGS_Soft (reference:
src/solve_tgs_soft.c:138-280), SoftStep (src/solve_soft_step.c:182-311)
and PGS_Soft (src/solve_pgs_soft.c:127-242). Prepare the soft contacts and
joints, run the solver's whole script in one launch of K1's plain twin
(`fused_cuda.fused_solve`), then finalize positions and store the impulses
for the next step's warm start.

The XLA route (`SOLVERS`): PGS_NGS_Block, the reference's default, as a
sequence of colored passes in plain PyTorch on the dense layout. Body
state rides one packed [W, B, 8] tensor; `Colors` holds each world's
colors and body maps. It follows the XLA code, not K1: velocity damping
divides, and a constraint that lost a body map cell still writes the
bodies it won. The program's other XLA solvers and its bucketed layout
are not copied: a cell that runs them brings their reference with it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CONTACT_HERTZ, JOINT_HERTZ, SimConfig, SolverType
from . import contact_kernels as ck
from . import joints as jk
from .common import (
    BodyMap,
    body_const_rows,
    body_plan,
    finalize_positions,
    integrate_positions_packed,
    integrate_velocities_packed,
    pack_body_state,
    prepare_contacts,
    store_impulses,
    unpack_body_state,
    warm_start_packed,
)
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


# ------------------------------------------------------------ the XLA route


class Colors(NamedTuple):
    """A batch's constraint structure for one step ([W, ...] each): contact
    and joint colors and body maps."""

    ccolor: torch.Tensor
    cmap: BodyMap
    jcolor: torch.Tensor
    jmap: BodyMap


class _Set(NamedTuple):
    """Prepared constraints and their body indices [W, N]."""

    cons: NamedTuple
    ia: torch.Tensor
    ib: torch.Tensor


class Hints(NamedTuple):
    """What the XLA solve of a step takes from the host: the colors whose
    passes run, and the depth of its ordered sums."""

    c_live: tuple
    j_live: tuple
    depth: int


def _live(color, keep, bmap: BodyMap, n_colors: int):
    """[K] bool: color k's pass can change something, in some world: a body
    takes a row from it, or a constraint of it keeps its impulses (`keep`:
    active winners). A pass over a color without either is an exact no-op,
    which the JAX package's static program runs all the same."""
    slot_any = (bmap.slot >= 0).flatten(0, 1).any(dim=0)
    keyed = torch.where(keep & (color >= 0), color, n_colors).flatten().long()
    upd_any = torch.bincount(keyed, minlength=n_colors + 1)[:n_colors] > 0
    return slot_any | upd_any


def solve_hints(bodies, contacts, joints, colors: Colors, cfg: SimConfig) -> Hints:
    """The step's `Hints`, in one host sync. The depth bounds the contacts
    of a dynamic body in any world."""
    W, B = bodies.type.shape
    worlds = torch.arange(W, device=bodies.type.device)[:, None]
    dyn = (bodies.type == 2) & bodies.alive
    touching = contacts.alive & (contacts.point_count > 0)
    c_keep = touching & colors.cmap.winner
    j_keep = joints.alive & colors.jmap.winner
    ends = torch.cat([contacts.body_a, contacts.body_b], dim=1)
    kept = torch.cat([touching, touching], dim=1) & dyn[worlds, ends]
    count = torch.zeros((W, B + 1), dtype=torch.long, device=ends.device).scatter_add_(
        1, torch.where(kept, ends, B).long(), torch.ones_like(ends, dtype=torch.long))
    vals = torch.cat([
        _live(colors.ccolor, c_keep, colors.cmap, cfg.max_colors).long(),
        _live(colors.jcolor, j_keep, colors.jmap, cfg.joint_max_colors).long(),
        count[:, :B].amax().reshape(1),
    ]).tolist()
    K = cfg.max_colors
    return Hints(c_live=tuple(k for k in range(K) if vals[k]),
                 j_live=tuple(k for k in range(cfg.joint_max_colors) if vals[K + k]), depth=int(vals[-1]))


def _sets(st: _Set, color, bmap: BodyMap, live):
    """For each live color k: (its constraint set, its slot table, the mask
    of impulses it may keep): all constraints with the color-k winners."""
    for k in live:
        yield st, bmap.slot[..., k], (color == k) & bmap.winner


class _Solve:
    """One step's XLA solve of a batch: the prepared sets, the carry (bs,
    n_imp, t_imp, joint impulses), and the colored passes over them."""

    def __init__(self, bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints):
        """Prepare the rigid contacts and joints; the contacts keep their
        stored impulses with `cfg.warm_start`, the joints too. dt is a 0-dim
        float32 tensor; `hints` the step's `Hints` (`solve_hints`)."""
        W = bodies.type.shape[0]
        self.bodies, self.contacts, self.joints, self.colors, self.gravity, self.cfg, self.hints = (
            bodies, contacts, joints, colors, gravity, cfg, hints)
        # dt itself (PGS_NGS_Block does not substep); 1/h is 0 for dt <= 0
        n = torch.full((), float(cfg.iterations if cfg.substepping() else 1), dtype=torch.float32, device=dt.device)
        self.h = dt / n
        self.inv_h = torch.where(dt > 0, n / torch.where(dt > 0, dt, torch.ones_like(dt)), 0.0)
        worlds = torch.arange(W, device=dt.device)[:, None]
        bconst = body_const_rows(bodies)
        ia, ib = contacts.body_a, contacts.body_b
        cons, n_imp, t_imp = prepare_contacts(
            contacts, bconst[worlds, ia], bconst[worlds, ib], h=self.h, hertz=0.0, warm_start=cfg.warm_start,
            soft=False,
        )
        self.c = _Set(cons, ia, ib)
        jcons, jimp = jk.prepare_joints(bodies, joints, h=self.h, hertz=0.0, warm_start=cfg.warm_start, soft=False)
        self.j = _Set(jcons, joints.body_a, joints.body_b)
        bs = pack_body_state(bodies.v, bodies.w, bodies.delta_pos, bodies.rot)
        self.st = (bs, n_imp, t_imp, jimp)
        self._plan = None

    # -- the contact warm start's ordered sums
    def plan(self):
        if self._plan is None:
            dyn = (self.bodies.type == 2) & self.bodies.alive
            worlds = torch.arange(dyn.shape[0], device=dyn.device)[:, None]
            c = self.c
            act = c.cons.active
            self._plan = body_plan(c.ia, c.ib, act & dyn[worlds, c.ia], act & dyn[worlds, c.ib], dyn.shape[1],
                                   self.hints.depth)
        return self._plan

    def integrate_velocities(self):
        bs, n, t, jimp = self.st
        self.st = (integrate_velocities_packed(self.bodies, bs, self.gravity, self.h), n, t, jimp)

    def integrate_positions(self):
        bs, n, t, jimp = self.st
        self.st = (integrate_positions_packed(self.bodies, bs, self.h), n, t, jimp)

    def warm_contacts(self, fixed_anchors: bool = False):
        if not self.cfg.solve_contacts:
            return
        bs, n, t, jimp = self.st
        c = self.c
        self.st = (warm_start_packed(bs, c.cons, c.ia, c.ib, n, t, self.plan(), fixed_anchors), n, t, jimp)

    def _contact_sets(self):
        return _sets(self.c, self.colors.ccolor, self.colors.cmap, self.hints.c_live)

    def _joint_sets(self):
        return _sets(self.j, self.colors.jcolor, self.colors.jmap, self.hints.j_live)

    def joint_gs(self, mode: str, use_bias: bool):
        if not self.cfg.solve_joints:
            return
        bs, n, t, jimp = self.st
        for j, slot, win in self._joint_sets():
            bs, jimp = jk.solve_pass((bs, jimp), j.cons, j.ia, j.ib, mode, self.h, self.inv_h, use_bias, slot, win,
                                     True, False)
        self.st = (bs, n, t, jimp)

    def joint_warm(self):
        if not self.cfg.solve_joints:
            return
        bs, n, t, jimp = self.st
        for j, slot, _ in self._joint_sets():
            bs = jk.warm_start_apply(bs, j.cons, j.ia, j.ib, jimp, slot)
        self.st = (bs, n, t, jimp)

    def joint_ngs(self):
        if not self.cfg.solve_joints:
            return
        bs, n, t, jimp = self.st
        for j, slot, _ in self._joint_sets():
            bs = jk.position_apply(bs, j.cons, j.ia, j.ib, slot)
        self.st = (bs, n, t, jimp)

    def finish(self):
        bs, n, t, jimp = self.st
        v, w, dp, rot = unpack_body_state(bs)
        return (finalize_positions(self.bodies, dp, rot, v, w), store_impulses(self.contacts, self.c.cons, n, t),
                jk.store_impulses(self.joints, self.j.cons, jimp))


def solve_pgs_ngs_block(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_pgs_ngs_block.c:892-963 (the reference's default)."""
    s = _Solve(bodies, contacts, joints, colors, gravity, dt, cfg, hints)
    s.integrate_velocities()
    vbias, kmat, bmass, use_block, pmask_eff = ck.prepare_block(s.c.cons, s.inv_h)
    # the warm start runs inside the solver's creation whatever the setting
    # (block.c:281-319); its impulses are zero without it
    s.warm_contacts(fixed_anchors=True)
    s.joint_warm()
    for _ in range(cfg.iterations):
        s.joint_gs("rigid", True)
        if cfg.solve_contacts:
            bs, n, t, jimp = s.st
            for c, slot, win in s._contact_sets():
                bs, n, t = ck.block_velocity_pass(
                    (bs, n, t), c.cons, c.ia, c.ib, vbias, kmat, bmass, use_block, pmask_eff, slot,
                    c.cons.active & win,
                )
            s.st = (bs, n, t, jimp)
    s.integrate_positions()
    for _ in range(cfg.extra_iterations):
        if cfg.solve_contacts:
            bs, n, t, jimp = s.st
            for c, slot, _ in s._contact_sets():
                bs = ck.block_position_pass(bs, c.cons, c.ia, c.ib, use_block, slot)
            s.st = (bs, n, t, jimp)
        s.joint_ngs()
    return s.finish()


# the XLA route's solvers that the reference has
SOLVERS = {SolverType.PGS_NGS_BLOCK: solve_pgs_ngs_block}


def solve_xla(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig):
    """cfg.solver on a batch of worlds through the XLA route: the step's
    hints from the host, then the solve, eagerly. dt is a 0-dim float32
    tensor. Returns (bodies, contacts, joints)."""
    if cfg.solver not in SOLVERS:
        raise NotImplementedError(f"the reference has no XLA solve of {cfg.solver.name}")
    hints = solve_hints(bodies, contacts, joints, colors, cfg)
    return SOLVERS[cfg.solver](bodies, contacts, joints, colors, gravity, dt, cfg, hints)
