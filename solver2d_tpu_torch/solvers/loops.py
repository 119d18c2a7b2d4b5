"""The solver scripts of the per-world step, on its two routes.

Port of the JAX package's `solvers/loops.py`.

The fused route (`_solve_pallas`, :460-488): TGS_Soft (reference:
src/solve_tgs_soft.c:138-280), SoftStep (src/solve_soft_step.c:182-311)
and PGS_Soft (src/solve_pgs_soft.c:127-242). Prepare the soft contacts and
joints, run the solver's whole script in one launch of K1
(`fused_cuda.fused_solve`), then finalize positions and store the impulses
for the next step's warm start.

The XLA route (`SOLVERS`): each reference solver's iteration structure as
a sequence of colored passes in plain PyTorch, for all ten: PGS,
PGS_NGS, PGS_NGS_Block, PGS_Soft, Jacobi, SoftStep, TGS_Soft, TGS_NGS,
TGS_Sticky (its contacts always dense) and XPBD. Body
state rides one packed [W, B, 8] tensor; `Colors` holds each world's
colors and body maps and, on the bucketed layout, its bucket tables. These
solvers follow the XLA code, not K1: velocity damping divides, and a
constraint that lost a body map cell still writes the bodies it won.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import CONTACT_HERTZ, JOINT_HERTZ, SimConfig, SolverType
from ..ops import math2d as m
from . import contact_kernels as ck
from . import joints as jk
from .common import (
    BodyMap,
    body_const_rows,
    body_plan,
    bucket_contacts,
    finalize_positions,
    integrate_positions_packed,
    integrate_velocities_packed,
    ngs_apply,
    pack_body_state,
    prepare_contacts,
    store_impulses,
    unbucket_impulses,
    unpack_body_state,
    warm_start_packed,
)
from . import graphs
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


# ------------------------------------------------------------ the XLA route


class Colors(NamedTuple):
    """A batch's constraint structure for one step ([W, ...] each): contact
    and joint colors and body maps, and the color-major bucket tables of
    the bucketed layout (None on the dense one)."""

    ccolor: torch.Tensor
    cmap: BodyMap
    jcolor: torch.Tensor
    jmap: BodyMap
    bucket: Optional[torch.Tensor] = None
    jbucket: Optional[torch.Tensor] = None


class _Set(NamedTuple):
    """Prepared constraints and their body indices [W, N]."""

    cons: NamedTuple
    ia: torch.Tensor
    ib: torch.Tensor


def _cols(x, sl):
    """Slice a tensor, or each field of a tuple, along the constraint dim."""
    if isinstance(x, torch.Tensor):
        return x[:, sl]
    return type(x)(*(_cols(f, sl) for f in x))


def _slot_local(bmap: BodyMap, k: int, cap: int):
    slot_k = bmap.slot[..., k]
    return torch.where(slot_k >= 0, slot_k - k * cap, -1)


class Hints(NamedTuple):
    """What the XLA solve of a step takes from the host: the colors whose
    passes run, and the depth of its ordered sums."""

    c_live: tuple
    j_live: tuple
    depth: int


def _live(color, keep, bmap: BodyMap, n_colors: int, cap: int):
    """[K] bool: color k's pass can change something, in some world: a body
    takes a row from it, or a constraint of it keeps its impulses (`keep`:
    active winners). A pass over a color without either is an exact no-op,
    which the JAX package's static program runs all the same (`cap` > 0:
    the bucketed layout, `keep` in bucket order)."""
    slot_any = (bmap.slot >= 0).flatten(0, 1).any(dim=0)
    if cap > 0:
        upd_any = keep.reshape(keep.shape[0], n_colors, cap).any(dim=2).any(dim=0)
    else:
        keyed = torch.where(keep & (color >= 0), color, n_colors).flatten().long()
        upd_any = torch.bincount(keyed, minlength=n_colors + 1)[:n_colors] > 0
    return slot_any | upd_any


def solve_hints(bodies, contacts, joints, colors: Colors, cfg: SimConfig) -> Hints:
    """The step's `Hints`, in one host sync. The depth bounds the contacts
    of a dynamic body in any world (the bucketed layout holds no more)."""
    W, B = bodies.type.shape
    worlds = torch.arange(W, device=bodies.type.device)[:, None]
    dyn = (bodies.type == 2) & bodies.alive
    touching = contacts.alive & (contacts.point_count > 0)
    c_cap = j_cap = 0
    if colors.bucket is not None:
        c_cap = cfg.contact_bucket_cap
        bi = torch.clamp(colors.bucket, min=0)
        c_keep = touching[worlds, bi] & (colors.bucket >= 0) & colors.cmap.winner
    else:
        c_keep = touching & colors.cmap.winner
    if colors.jbucket is not None:
        j_cap = cfg.joint_bucket_cap
        bi = torch.clamp(colors.jbucket, min=0)
        j_keep = joints.alive[worlds, bi] & (colors.jbucket >= 0) & colors.jmap.winner
    else:
        j_keep = joints.alive & colors.jmap.winner
    ends = torch.cat([contacts.body_a, contacts.body_b], dim=1)
    kept = torch.cat([touching, touching], dim=1) & dyn[worlds, ends]
    count = torch.zeros((W, B + 1), dtype=torch.long, device=ends.device).scatter_add_(
        1, torch.where(kept, ends, B).long(), torch.ones_like(ends, dtype=torch.long))
    vals = torch.cat([
        _live(colors.ccolor, c_keep, colors.cmap, cfg.max_colors, c_cap).long(),
        _live(colors.jcolor, j_keep, colors.jmap, cfg.joint_max_colors, j_cap).long(),
        count[:, :B].amax().reshape(1),
    ]).tolist()
    K = cfg.max_colors
    return Hints(c_live=tuple(k for k in range(K) if vals[k]),
                 j_live=tuple(k for k in range(cfg.joint_max_colors) if vals[K + k]), depth=int(vals[-1]))


def _sets(st: _Set, color, bmap: BodyMap, cap: int, live):
    """For each live color k: (the constraint dim's slice of its pass, its
    constraint set, its slot table, the mask of impulses it may keep) — all
    constraints with the color-k winners on the dense layout (cap 0),
    color k's slice on the bucketed one."""
    for k in live:
        if cap > 0:
            sl = slice(k * cap, (k + 1) * cap)
            yield sl, _cols(st, sl), _slot_local(bmap, k, cap), bmap.winner[:, sl]
        else:
            yield slice(None), st, bmap.slot[..., k], (color == k) & bmap.winner


class _Solve:
    """One step's XLA solve of a batch: the prepared sets, the carry (bs,
    n_imp, t_imp, joint impulses), and the colored passes over them."""

    def __init__(self, bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints, *,
                 hertz=None, joint_warm: bool, contact_warm: bool | None = None):
        """Prepare the contacts (soft with `hertz` = (contact factor, joint
        factor) of 1/h, else rigid) and joints, in bucket order on the
        bucketed layout; the contacts keep their stored impulses with
        `contact_warm` (default: `cfg.warm_start`). dt is a 0-dim float32
        tensor; `hints` the step's `Hints` (`solve_hints`), so that the
        solve syncs with the host nowhere and a CUDA graph can hold it."""
        W = bodies.type.shape[0]
        self.bodies, self.contacts, self.joints, self.colors, self.gravity, self.cfg, self.hints = (
            bodies, contacts, joints, colors, gravity, cfg, hints)
        # a substep of dt (substepping solvers) or dt itself; 1/h is 0 for dt <= 0
        n = torch.full((), float(cfg.iterations if cfg.substepping() else 1), dtype=torch.float32, device=dt.device)
        self.h = dt / n
        self.inv_h = torch.where(dt > 0, n / torch.where(dt > 0, dt, torch.ones_like(dt)), 0.0)
        soft = hertz is not None
        if soft:
            contact_hertz = torch.clamp(hertz[0] * self.inv_h, max=CONTACT_HERTZ)
            joint_hertz = torch.clamp(hertz[1] * self.inv_h, max=JOINT_HERTZ)
        else:
            contact_hertz = joint_hertz = 0.0
        worlds = torch.arange(W, device=dt.device)[:, None]
        bconst = body_const_rows(bodies)
        ia, ib = contacts.body_a, contacts.body_b
        cons, n_imp, t_imp = prepare_contacts(
            contacts, bconst[worlds, ia], bconst[worlds, ib], h=self.h, hertz=contact_hertz,
            warm_start=cfg.warm_start if contact_warm is None else contact_warm, soft=soft,
        )
        self.bucket = colors.bucket
        if self.bucket is not None:
            cons, ia, ib, n_imp, t_imp = bucket_contacts(cons, ia, ib, n_imp, t_imp, self.bucket)
        self.c = _Set(cons, ia, ib)
        jcons, jimp = jk.prepare_joints(bodies, joints, h=self.h, hertz=joint_hertz, warm_start=joint_warm, soft=soft)
        ja, jb = joints.body_a, joints.body_b
        if colors.jbucket is not None:
            jcons, ja, jb, jimp = jk.bucket_joints(jcons, ja, jb, jimp, colors.jbucket)
        self.j = _Set(jcons, ja, jb)
        bs = pack_body_state(bodies.v, bodies.w, bodies.delta_pos, bodies.rot)
        self.st = (bs, n_imp, t_imp, jimp)
        self._plan = None
        self.c_cap = cfg.contact_bucket_cap if self.bucket is not None else 0
        self.j_cap = cfg.joint_bucket_cap if colors.jbucket is not None else 0

    # -- the contact warm start's (and Jacobi's) ordered sums
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
        return _sets(self.c, self.colors.ccolor, self.colors.cmap, self.c_cap, self.hints.c_live)

    def _joint_sets(self):
        return _sets(self.j, self.colors.jcolor, self.colors.jmap, self.j_cap, self.hints.j_live)

    def contact_gs(self, mode: ck.SolveMode, use_bias: bool):
        if not self.cfg.solve_contacts:
            return
        bs, n, t, jimp = self.st
        for sl, c, slot, win in self._contact_sets():
            bs, n_k, t_k = ck.gs_contact_pass(
                (bs, n[:, sl], t[:, sl]), c.cons, c.ia, c.ib, mode, self.inv_h, use_bias, slot, c.cons.active & win,
            )
            n, t = _put(n, sl, n_k), _put(t, sl, t_k)
        self.st = (bs, n, t, jimp)

    def contact_ngs(self):
        if not self.cfg.solve_contacts:
            return
        bs, n, t, jimp = self.st
        for _, c, slot, _ in self._contact_sets():
            bs = ngs_apply(bs, c.cons, c.ia, c.ib, slot)
        self.st = (bs, n, t, jimp)

    def joint_gs(self, mode: str, use_bias: bool, solve_mouse: bool = True, only_mouse: bool = False):
        if not self.cfg.solve_joints:
            return
        bs, n, t, jimp = self.st
        for sl, j, slot, win in self._joint_sets():
            bs, imp_k = jk.solve_pass(
                (bs, _cols(jimp, sl)), j.cons, j.ia, j.ib, mode, self.h, self.inv_h, use_bias, slot, win, solve_mouse,
                only_mouse,
            )
            jimp = jk.JointImp(*(_put(a, sl, b) for a, b in zip(jimp, imp_k)))
        self.st = (bs, n, t, jimp)

    def joint_warm(self):
        if not self.cfg.solve_joints:
            return
        bs, n, t, jimp = self.st
        for sl, j, slot, _ in self._joint_sets():
            bs = jk.warm_start_apply(bs, j.cons, j.ia, j.ib, _cols(jimp, sl), slot)
        self.st = (bs, n, t, jimp)

    def joint_ngs(self):
        if not self.cfg.solve_joints:
            return
        bs, n, t, jimp = self.st
        for _, j, slot, _ in self._joint_sets():
            bs = jk.position_apply(bs, j.cons, j.ia, j.ib, slot)
        self.st = (bs, n, t, jimp)

    def store(self, n, t):
        """The contacts and joints with these contact impulses and the
        carried joint impulses stored."""
        jimp = self.st[3]
        cons = self.c.cons
        if self.bucket is not None:
            contacts = unbucket_impulses(self.contacts, cons, self.bucket, n, t)
        else:
            contacts = store_impulses(self.contacts, cons, n, t)
        if self.colors.jbucket is not None:
            joints = jk.store_impulses_bucketed(self.joints, self.j.cons, self.colors.jbucket, jimp)
        else:
            joints = jk.store_impulses(self.joints, self.j.cons, jimp)
        return contacts, joints

    def finish(self):
        bs, n, t, _ = self.st
        v, w, dp, rot = unpack_body_state(bs)
        return (finalize_positions(self.bodies, dp, rot, v, w),) + self.store(n, t)


def _put(full, sl, part):
    """full with its constraint-dim slice `sl` replaced by part."""
    if sl == slice(None):
        return part
    return torch.cat([full[:, :sl.start], part, full[:, sl.stop:]], dim=1)


def _rigid(bodies, contacts, joints, colors, gravity, dt, cfg, hints):
    return _Solve(bodies, contacts, joints, colors, gravity, dt, cfg, hints, joint_warm=cfg.warm_start)


def solve_pgs(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_pgs.c:125-213 (box2d_lite style)."""
    s = _rigid(bodies, contacts, joints, colors, gravity, dt, cfg, hints)
    s.integrate_velocities()
    if cfg.warm_start:
        s.warm_contacts()
        s.joint_warm()
    for _ in range(cfg.iterations):
        s.joint_gs("baumgarte", True)
        s.contact_gs(ck.PGS_BAUMGARTE, True)
    s.integrate_positions()
    return s.finish()


def solve_pgs_ngs(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_pgs_ngs.c:149-255."""
    s = _rigid(bodies, contacts, joints, colors, gravity, dt, cfg, hints)
    s.integrate_velocities()
    if cfg.warm_start:
        s.warm_contacts()
        s.joint_warm()
    for _ in range(cfg.iterations):
        s.joint_gs("rigid", True)
        s.contact_gs(ck.PGS_PLAIN, True)
    s.integrate_positions()
    for _ in range(cfg.extra_iterations):
        s.joint_ngs()
        s.contact_ngs()
    return s.finish()


def solve_pgs_ngs_block(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_pgs_ngs_block.c:892-963 (the reference's default)."""
    s = _rigid(bodies, contacts, joints, colors, gravity, dt, cfg, hints)
    s.integrate_velocities()
    # the block extras are elementwise over the constraint rows, so they
    # take the bucketed layout with the constraints
    vbias, kmat, bmass, use_block, pmask_eff = ck.prepare_block(s.c.cons, s.inv_h)
    # the warm start runs inside the solver's creation whatever the setting
    # (block.c:281-319); its impulses are zero without it
    s.warm_contacts(fixed_anchors=True)
    s.joint_warm()
    for _ in range(cfg.iterations):
        s.joint_gs("rigid", True)
        if cfg.solve_contacts:
            bs, n, t, jimp = s.st
            for sl, c, slot, win in s._contact_sets():
                bs, n_k, t_k = ck.block_velocity_pass(
                    (bs, n[:, sl], t[:, sl]), c.cons, c.ia, c.ib, vbias[:, sl], kmat[:, sl], bmass[:, sl],
                    use_block[:, sl], pmask_eff[:, sl], slot, c.cons.active & win,
                )
                n, t = _put(n, sl, n_k), _put(t, sl, t_k)
            s.st = (bs, n, t, jimp)
    s.integrate_positions()
    for _ in range(cfg.extra_iterations):
        if cfg.solve_contacts:
            bs, n, t, jimp = s.st
            for sl, c, slot, _ in s._contact_sets():
                bs = ck.block_position_pass(bs, c.cons, c.ia, c.ib, use_block[:, sl], slot)
            s.st = (bs, n, t, jimp)
        s.joint_ngs()
    return s.finish()


def _soft(bodies, contacts, joints, colors, gravity, dt, cfg, hints, contact_factor, joint_factor, joint_warm):
    return _Solve(bodies, contacts, joints, colors, gravity, dt, cfg, hints, hertz=(contact_factor, joint_factor),
                  joint_warm=joint_warm)


def solve_pgs_soft_xla(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_pgs_soft.c:127-242."""
    s = _soft(bodies, contacts, joints, colors, gravity, dt, cfg, hints, 0.333, 0.5, cfg.warm_start)
    s.integrate_velocities()
    if cfg.warm_start:
        s.warm_contacts()
        s.joint_warm()
    for _ in range(cfg.iterations):
        s.joint_gs("soft", True)
        s.contact_gs(ck.PGS_SOFT, True)
    s.integrate_positions()
    for _ in range(cfg.extra_iterations):
        s.joint_gs("soft", False, solve_mouse=False)
        s.contact_gs(ck.PGS_SOFT, False)
    return s.finish()


def solve_jacobi(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_jacobi.c:134-292. Contacts solved Jacobi (deltas
    summed, applied once an iteration) on the dense table; joints
    Gauss-Seidel, soft."""
    s = _soft(bodies, contacts, joints, colors, gravity, dt, cfg, hints, 0.333, 0.5, cfg.warm_start)
    s.integrate_velocities()
    if cfg.warm_start:
        s.warm_contacts()
        s.joint_warm()

    def it(use_bias):
        s.joint_gs("soft", use_bias, solve_mouse=use_bias)
        if cfg.solve_contacts:
            bs, n, t, jimp = s.st
            c = s.c
            bs, n, t = ck.jacobi_contact_pass(bs, c.cons, c.ia, c.ib, n, t, ck.JACOBI_SOFT, s.inv_h, use_bias,
                                              s.plan())
            s.st = (bs, n, t, jimp)

    for _ in range(cfg.iterations):
        it(True)
    s.integrate_positions()
    for _ in range(cfg.extra_iterations):
        it(False)
    return s.finish()


def _substep_soft(bodies, contacts, joints, colors, gravity, dt, cfg, hints, mode, joint_factor, fixed_warm):
    """TGS_Soft (solve_tgs_soft.c:138-280) and SoftStep
    (solve_soft_step.c:182-311): prepare once, then a substep integrates
    velocities, warm starts, solves with bias, integrates positions and
    relaxes."""
    # the substep solvers keep the joints' stored impulses unconditionally
    s = _soft(bodies, contacts, joints, colors, gravity, dt, cfg, hints, 0.25, joint_factor, True)
    for _ in range(cfg.iterations):
        s.integrate_velocities()
        if cfg.warm_start:
            s.joint_warm()
            s.warm_contacts(fixed_anchors=fixed_warm)
        s.joint_gs("soft", True)
        s.contact_gs(mode, True)
        s.integrate_positions()
        if cfg.extra_iterations > 0:
            s.joint_gs("soft", False, solve_mouse=False)
            s.contact_gs(mode, False)
    return s.finish()


def solve_tgs_soft_xla(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_tgs_soft.c:138-280 (became Box2D v3's solver)."""
    return _substep_soft(bodies, contacts, joints, colors, gravity, dt, cfg, hints, ck.TGS_SOFT, 0.125, False)


def solve_soft_step_xla(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_soft_step.c:182-311 (TGS_Soft with fixed anchors)."""
    return _substep_soft(bodies, contacts, joints, colors, gravity, dt, cfg, hints, ck.SOFT_STEP, 0.25, True)


def solve_tgs_ngs(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_tgs_ngs.c:207-317."""
    s = _rigid(bodies, contacts, joints, colors, gravity, dt, cfg, hints)
    for _ in range(cfg.iterations):
        s.integrate_velocities()
        if cfg.warm_start:
            s.joint_warm()
            s.warm_contacts()
        s.joint_gs("rigid", True)
        s.contact_gs(ck.TGS_RIGID, True)
        s.integrate_positions()
        s.joint_ngs()
        s.contact_ngs()
    return s.finish()


def solve_tgs_sticky(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_tgs_sticky.c:313-417. Rigid contacts without a
    warm start, persistent friction anchors (`ck.prepare_sticky`),
    Baumgarte joints; positions are finalized before the relax passes. The
    contacts are dense whatever the bucket cap (their anchors are
    prepared in slot order); the joints take their buckets."""
    s = _Solve(bodies, contacts, joints, colors, gravity, dt, cfg, hints, joint_warm=False, contact_warm=False)
    c = s.c
    lfa, lfb, tsep, stm, fric_store = ck.prepare_sticky(bodies.position, bodies.rot, contacts, c.cons, c.ia, c.ib)
    # every contact starts a step persisted; a friction clamp clears it
    persisted = torch.ones_like(c.cons.active)

    def sticky_gs(use_bias):
        nonlocal persisted
        if not cfg.solve_contacts:
            return
        bs, n, t, jimp = s.st
        for _, cs, slot, win in s._contact_sets():
            bs, n, t, persisted = ck.sticky_velocity_pass(
                (bs, n, t, persisted), cs.cons, cs.ia, cs.ib, lfa, lfb, tsep, stm, s.inv_h, use_bias, slot,
                cs.cons.active & win,
            )
        s.st = (bs, n, t, jimp)

    for _ in range(cfg.iterations):
        s.integrate_velocities()
        s.joint_gs("baumgarte", True)
        sticky_gs(True)
        s.integrate_positions()

    # finalize the positions, then relax from zeroed deltas (sticky.c:389-410)
    bs, n, t, jimp = s.st
    v, w, dp, rot = unpack_body_state(bs)
    bodies_out = finalize_positions(bodies, dp, rot, v, w)
    s.st = (pack_body_state(v, w, torch.zeros_like(dp), rot), n, t, jimp)
    for _ in range(cfg.extra_iterations):
        s.joint_gs("baumgarte", False)
        sticky_gs(False)

    bs, n, t, _ = s.st
    v, w, _, _ = unpack_body_state(bs)
    contacts, joints = s.store(n, t)
    fa_n, fb_n, fa_a, fb_a = fric_store
    contacts = dataclasses.replace(
        contacts, friction_normal_a=fa_n, friction_normal_b=fb_n, friction_anchor_a=fa_a, friction_anchor_b=fb_a,
        friction_persisted=persisted & c.cons.active,
    )
    return dataclasses.replace(bodies_out, v=v, w=w), contacts, joints


def solve_xpbd(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig, hints: Hints):
    """reference: src/solve_xpbd.c:342-530 (Mueller et al. 2020). A substep
    integrates velocities and positions, projects the joints (the mouse
    joints by their velocity solve) and the contacts in position space,
    derives the velocities and relaxes the contact velocities. Only the
    dynamic bodies are finalized; the impulses are stored times 1/h."""
    s = _Solve(bodies, contacts, joints, colors, gravity, dt, cfg, hints, joint_warm=False, contact_warm=False)
    dyn = bodies.alive & (bodies.type == 2)

    def contact_pass(fn, *args):
        if not cfg.solve_contacts:
            return
        bs, n, t, jimp = s.st
        for sl, c, slot, win in s._contact_sets():
            bs, n_k, t_k = fn((bs, n[:, sl], t[:, sl]), c.cons, c.ia, c.ib, *args, slot, c.cons.active & win)
            n, t = _put(n, sl, n_k), _put(t, sl, t_k)
        s.st = (bs, n, t, jimp)

    for _ in range(cfg.iterations):
        # integrate velocities and positions at once (xpbd.c:408-449)
        s.integrate_velocities()
        _, _, dp0, rot0 = unpack_body_state(s.st[0])
        s.integrate_positions()
        # the joints' position projection, then the mouse joints' velocity
        # solve (joint.c:450-465)
        if cfg.solve_joints:
            bs, n, t, jimp = s.st
            for _, j, slot, _ in s._joint_sets():
                bs = jk.xpbd_apply(bs, j.cons, j.ia, j.ib, slot)
            s.st = (bs, n, t, jimp)
        s.joint_gs("rigid", True, only_mouse=True)
        contact_pass(ck.xpbd_position_pass, s.h)
        # derive the velocities (xpbd.c:465-489)
        bs, n, t, jimp = s.st
        v, w, dp, rot = unpack_body_state(bs)
        v = torch.where(dyn[..., None], s.inv_h * (dp - dp0), v)
        w = torch.where(dyn, m.compute_angular_velocity(rot0, rot, s.inv_h), w)
        s.st = (pack_body_state(v, w, dp, rot), n, t, jimp)
        contact_pass(ck.xpbd_velocity_pass, s.inv_h)

    bs, n, t, _ = s.st
    v, w, dp, rot = unpack_body_state(bs)
    # finalize only the dynamic bodies (xpbd.c:497-512)
    dyn2 = dyn[..., None]
    position = torch.where(dyn2, bodies.position + dp, bodies.position)
    origin = torch.where(dyn2, position - m.rotate(rot, bodies.local_center), bodies.origin)
    bodies_out = dataclasses.replace(
        bodies, position=position, origin=origin, rot=rot, delta_pos=torch.zeros_like(dp),
        delta_pos0=torch.zeros_like(dp), v=v, w=w, force=torch.zeros_like(bodies.force),
        torque=torch.zeros_like(bodies.torque),
    )
    # the impulses are stored times 1/h, for reporting only (xpbd.c:514-527)
    return (bodies_out,) + s.store(n * s.inv_h, t * s.inv_h)


# the XLA route's solvers (config.XLA_SOLVERS)
SOLVERS = {
    SolverType.JACOBI: solve_jacobi,
    SolverType.PGS: solve_pgs,
    SolverType.PGS_NGS: solve_pgs_ngs,
    SolverType.PGS_NGS_BLOCK: solve_pgs_ngs_block,
    SolverType.PGS_SOFT: solve_pgs_soft_xla,
    SolverType.SOFT_STEP: solve_soft_step_xla,
    SolverType.TGS_STICKY: solve_tgs_sticky,
    SolverType.TGS_SOFT: solve_tgs_soft_xla,
    SolverType.TGS_NGS: solve_tgs_ngs,
    SolverType.XPBD: solve_xpbd,
}


# per configuration and batch shape on the card: the union of the live
# colors and the largest depth seen so far (see `solve_xla`)
_widened: dict = {}


def _widen_hints(key, hints: Hints) -> Hints:
    """`hints` widened to every color live in an earlier step of the same
    key, and the depth to the next power of two at or above the largest
    seen. A pass over a color without live constraints, and a sum over
    absent entries, change nothing, so the widened solve equals the narrow
    one bit for bit, and its graph's key changes only when a new color or
    depth appears."""
    c_live, j_live, depth = _widened.get(key, ((), (), 1))
    while depth < hints.depth:
        depth *= 2
    widened = Hints(tuple(sorted(set(c_live) | set(hints.c_live))), tuple(sorted(set(j_live) | set(hints.j_live))),
                    depth)
    _widened[key] = widened
    return widened


def solve_xla(bodies, contacts, joints, colors: Colors, gravity, dt, cfg: SimConfig):
    """cfg.solver on a batch of worlds through the XLA route: the step's
    hints from the host, then the solve, through a CUDA graph on the card
    (`graphs.run`, with the hints widened by `_widen_hints` so that its
    graphs are reused). dt is a 0-dim float32 tensor. Returns (bodies,
    contacts, joints)."""
    hints = solve_hints(bodies, contacts, joints, colors, cfg)
    if bodies.type.is_cuda and graphs.ENABLED:
        hints = _widen_hints((cfg, tuple(bodies.type.shape), bodies.type.device), hints)
    solve = SOLVERS[cfg.solver]
    return graphs.run((cfg, hints), lambda *args: solve(*args, cfg, hints),
                      (bodies, contacts, joints, colors, gravity, dt))
