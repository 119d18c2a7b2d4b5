"""The fused soft solve of the per-world step: its packed inputs, its
scripts and its plain PyTorch twin.

Port of the JAX package's `solvers/pallas_solver.py` (the TPU kernel K1 and
its `fused_solve` wrapper). One world's whole solve runs on its own body
state, in one of three scripts (`scripts.Script`):

- TGS_Soft (reference: src/solve_tgs_soft.c:138-280), the substep loop: per
  substep integrate velocities, warm start joints and then contacts (at the
  anchors rotated to the current rotation), one colored pass over the soft
  revolute and mouse joints and one over the contacts, integrate positions,
  then one relax pass of each;
- SoftStep (src/solve_soft_step.c:182-311): the same loop, with the contact
  warm start at the prepare-time anchors and the SOFT_STEP contact solve;
- PGS_Soft (src/solve_pgs_soft.c:127-242), the PGS loop: integrate
  velocities once, warm start contacts and then joints, `substeps` biased
  passes (joints, then contacts), integrate positions, then `relax` relax
  passes.

`fused_inputs` packs what the kernel reads (the columns of
`pack_cons_fields` and `pack_joint_fields` are the TPU kernel's), and
`fused_solve_plain` is the plain twin of the kernel
(`fused_cuda.fused_solve`, csrc/fused_solve.cu), which repeats its
operations in its order.

Where the TPU kernel worked around its hardware, both do it directly:
indexed loads and stores of body rows instead of one-hot incidence
products, selects instead of masked blends `x + m * (y - x)`, and warm-start
sums in a fixed order: each body adds its contacts' deltas in the order of
the JAX package's scatter-add over [body_a; body_b] and its joints' deltas
in color order, as the JAX package's colored joint warm start does
(`common.entry_plan`).

A mouse joint never writes its body A (the prepare zeroes A's masses), but
its pivot velocity reads A's velocity as the JAX package's
`joints.solve_joint_core` does. The joint coloring gives every colored
joint its (body, color) cell at both dynamic endpoints, mouse joints
included, so no other joint of its color writes a dynamic body A while the
mouse joint reads it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import math2d as m
from . import contact_kernels as ck
from . import joints as jk
from .common import ContactCons, apply_plan, dense_plan, entry_plan, pack_body_state, unpack_body_state
from .scripts import Script

I32 = torch.int32
N_CONS_FIELDS = 37
N_JOINT_FIELDS = 23

# bits of the contact flags column
C_PMASK0, C_PMASK1, C_ACTIVE, C_WRITE_A, C_WRITE_B, C_WINNER = 1, 2, 4, 8, 16, 32
# bits of the joint flags column
J_MOUSE, J_ACTIVE, J_LIMIT, J_MOTOR, J_WRITE_A, J_WRITE_B, J_WINNER = 1, 2, 4, 8, 16, 32, 64


def pack_cons_fields(cons: ContactCons):
    """The float fields of each contact, [..., C, 37], in the TPU kernel's
    column order (pallas_solver.py:pack_cons_fields)."""
    c = lambda x: x[..., None]  # noqa: E731
    pt = lambda x: x.flatten(-2)  # noqa: E731  [..., 2, 2] -> point 0 xy, point 1 xy
    return torch.cat([
        c(cons.inv_mass_a), c(cons.inv_i_a), c(cons.inv_mass_b), c(cons.inv_i_b),
        cons.normal, c(cons.friction),
        pt(cons.local_anchor_a), pt(cons.local_anchor_b), pt(cons.r_a0), pt(cons.r_b0),
        cons.separation, cons.adjusted_separation, cons.normal_mass, cons.tangent_mass,
        cons.bias_coef, cons.mass_coef, cons.imp_coef,
    ], dim=-1).contiguous()


def pack_joint_fields(jcons: jk.JointCons):
    """The float fields of each joint, [..., J, 23], in the TPU kernel's
    column order (pallas_solver.py:pack_joint_fields)."""
    c = lambda x: x[..., None]  # noqa: E731
    return torch.cat([
        c(jcons.inv_mass_a), c(jcons.inv_i_a), c(jcons.inv_mass_b), c(jcons.inv_i_b),
        jcons.local_anchor_a, jcons.local_anchor_b, jcons.center_diff0,
        c(jcons.axial_mass), c(jcons.pm11), c(jcons.pm12), c(jcons.pm22),
        c(jcons.bias_coef), c(jcons.mass_coef), c(jcons.imp_coef),
        c(jcons.reference_angle), c(jcons.lower_angle), c(jcons.upper_angle),
        c(jcons.motor_speed), c(jcons.max_motor_torque), c(jcons.inertia_b),
    ], dim=-1).contiguous()


def unpack_cons(cf, cflags) -> ContactCons:
    pm = torch.stack([(cflags & C_PMASK0) != 0, (cflags & C_PMASK1) != 0], dim=-1)
    pt = lambda a: cf[..., a:a + 4].unflatten(-1, (2, 2))  # noqa: E731
    return ContactCons(
        inv_mass_a=cf[..., 0], inv_i_a=cf[..., 1], inv_mass_b=cf[..., 2], inv_i_b=cf[..., 3],
        normal=cf[..., 4:6], friction=cf[..., 6], active=(cflags & C_ACTIVE) != 0, pmask=pm,
        local_anchor_a=pt(7), local_anchor_b=pt(11), r_a0=pt(15), r_b0=pt(19),
        separation=cf[..., 23:25], adjusted_separation=cf[..., 25:27],
        normal_mass=cf[..., 27:29], tangent_mass=cf[..., 29:31],
        bias_coef=cf[..., 31:33], mass_coef=cf[..., 33:35], imp_coef=cf[..., 35:37],
    )


def unpack_joints(jf, jflags) -> jk.JointCons:
    f = lambda i: jf[..., i]  # noqa: E731
    return jk.JointCons(
        is_mouse=(jflags & J_MOUSE) != 0, active=(jflags & J_ACTIVE) != 0,
        inv_mass_a=f(0), inv_i_a=f(1), inv_mass_b=f(2), inv_i_b=f(3),
        local_anchor_a=jf[..., 4:6], local_anchor_b=jf[..., 6:8], center_diff0=jf[..., 8:10],
        axial_mass=f(10), pm11=f(11), pm12=f(12), pm22=f(13),
        bias_coef=f(14), mass_coef=f(15), imp_coef=f(16),
        reference_angle=f(17), lower_angle=f(18), upper_angle=f(19),
        enable_limit=(jflags & J_LIMIT) != 0, enable_motor=(jflags & J_MOTOR) != 0,
        motor_speed=f(20), max_motor_torque=f(21), inertia_b=f(22),
    )


class FusedInputs(NamedTuple):
    """Everything the fused solve reads, for W worlds of B bodies, C
    contacts and J joints."""

    body_const: torch.Tensor  # f32 [W, B, 8]: dyn, move, inv_mass, mass_grav (2), inv_I*torque, damp_lin, damp_ang
    bs: torch.Tensor          # f32 [W, B, 8] packed body state
    cfields: torch.Tensor     # f32 [W, C, 37]
    cint: torch.Tensor        # i32 [W, C, 4]: body_a, body_b, color, flags (C_*)
    n_imp: torch.Tensor       # f32 [W, C, 2]
    t_imp: torch.Tensor       # f32 [W, C, 2]
    jfields: torch.Tensor     # f32 [W, J, 23]
    jint: torch.Tensor        # i32 [W, J, 4]: body_a, body_b, color, flags (J_*)
    jimp: torch.Tensor        # f32 [W, J, 5]: impulse (2), motor, lower, upper
    c_off: torch.Tensor       # i32 [W, B+1] contact warm-start plan: offsets
    c_ent: torch.Tensor       # i32 [W, 2C] ... and entries (rows of the [W, 2C] delta table)
    j_off: torch.Tensor       # i32 [W, B+1] joint warm-start plan
    j_ent: torch.Tensor       # i32 [W, 2J]
    scal: torch.Tensor        # f32 [2]: h, inv_h


def fused_inputs(bodies, gravity, ia, ib, cons: ContactCons, n_imp, t_imp, ccolor, cmap,
                 ja, jb, jcons: jk.JointCons, jimp: jk.JointImp, jcolor, jmap, h, inv_h) -> FusedInputs:
    """Derive and pack the fused solve's inputs for a batch of worlds
    (pallas_solver.py:fused_solve, :442-470): bodies [W, B]; prepared
    contacts [W, C] between bodies ia and ib, with their colors and body
    map; prepared joints [W, J] between ja and jb, with theirs; gravity
    [W, 2]; h and inv_h 0-dim."""
    W, B = bodies.type.shape
    C = ccolor.shape[1]
    J = jcolor.shape[1]
    dev = ccolor.device
    worlds = torch.arange(W, device=dev)[:, None]
    dyn_b = (bodies.type == 2) & bodies.alive
    move = (bodies.type != 0) & bodies.alive
    mass_grav = bodies.force + bodies.mass[..., None] * bodies.gravity_scale[..., None] * gravity[:, None, :]
    f = lambda x: x.to(torch.float32)[..., None]  # noqa: E731
    body_const = torch.cat([
        f(dyn_b), f(move), f(bodies.inv_mass), mass_grav, f(bodies.inv_inertia * bodies.torque),
        f(1.0 / (1.0 + h * bodies.linear_damping)), f(1.0 / (1.0 + h * bodies.angular_damping)),
    ], dim=-1).contiguous()

    wa, wb = dyn_b[worlds, ia], dyn_b[worlds, ib]
    bit = lambda m, b: m.to(I32) * b  # noqa: E731
    cflags = (bit(cons.pmask[..., 0], C_PMASK0) + bit(cons.pmask[..., 1], C_PMASK1) + bit(cons.active, C_ACTIVE)
              + bit(wa, C_WRITE_A) + bit(wb, C_WRITE_B) + bit(cmap.winner, C_WINNER))
    cint = torch.stack([ia, ib, ccolor, cflags], dim=-1).contiguous()

    jwa = dyn_b[worlds, ja] & ~jcons.is_mouse  # the mouse joint never writes body A
    jwb = dyn_b[worlds, jb]
    jflags = (bit(jcons.is_mouse, J_MOUSE) + bit(jcons.active, J_ACTIVE) + bit(jcons.enable_limit, J_LIMIT)
              + bit(jcons.enable_motor, J_MOTOR) + bit(jwa, J_WRITE_A) + bit(jwb, J_WRITE_B)
              + bit(jmap.winner, J_WINNER))
    jint = torch.stack([ja, jb, jcolor, jflags], dim=-1).contiguous()
    jimp5 = torch.cat([jimp.impulse, jimp.motor[..., None], jimp.lower[..., None], jimp.upper[..., None]], dim=-1)

    # contacts warm bodies in the order of [body_a; body_b]; joints (the
    # active, colored winners) in color order
    pos_c = torch.arange(2 * C, device=dev).expand(W, -1)
    c_off, c_ent = entry_plan(
        torch.cat([ia, ib], dim=1), torch.cat([cons.active & wa, cons.active & wb], dim=1), pos_c, B
    )
    jact = jcons.active & jmap.winner & (jcolor >= 0)
    pos_j = torch.arange(2 * J, device=dev).expand(W, -1)
    jc2 = torch.cat([jcolor, jcolor], dim=1).long().clamp(min=0)
    j_off, j_ent = entry_plan(
        torch.cat([ja, jb], dim=1), torch.cat([jact & jwa, jact & jwb], dim=1), jc2 * (2 * J) + pos_j, B
    )
    return FusedInputs(
        body_const=body_const,
        bs=pack_body_state(bodies.v, bodies.w, bodies.delta_pos, bodies.rot).contiguous(),
        cfields=pack_cons_fields(cons), cint=cint,
        n_imp=n_imp.contiguous(), t_imp=t_imp.contiguous(),
        jfields=pack_joint_fields(jcons), jint=jint, jimp=jimp5.contiguous(),
        c_off=c_off, c_ent=c_ent, j_off=j_off, j_ent=j_ent,
        scal=torch.stack([h, inv_h]).to(torch.float32).contiguous(),
    )


def _write_rows(bs, idx, upd, v, w):
    """bs[idx].v, .w = v, w where upd: at most one writer a body, so the
    writes commute."""
    W, B = bs.shape[:2]
    worlds = torch.arange(W, device=bs.device)[:, None]
    ext = torch.cat([bs, torch.zeros_like(bs[:, :1])], dim=1)
    ext[worlds, torch.where(upd, idx, B).long(), 0:3] = torch.cat([v, w[..., None]], dim=-1)
    return ext[:, :B]


def fused_solve_plain(x: FusedInputs, *, script: Script, substeps: int, relax: int, warm_start: bool,
                      n_colors: int, n_joint_colors: int):
    """The plain PyTorch twin of K1 (csrc/fused_solve.cu): `script` on every
    world, with `substeps` substeps (the substep loop) or velocity passes
    (the PGS loop), and `relax` relax passes (a substep's, or the PGS loop's
    after its position integrate). Returns (bs [W, B, 8], n_imp, t_imp
    [W, C, 2], jimp [W, J, 5])."""
    W, B = x.bs.shape[:2]
    dev = x.bs.device
    worlds = torch.arange(W, device=dev)[:, None]
    h, inv_h = x.scal[0], x.scal[1]
    bc = x.body_const
    dyn, move = bc[..., 0] > 0.0, bc[..., 1] > 0.0
    inv_mass, mass_grav, inv_i_tau = bc[..., 2], bc[..., 3:5], bc[..., 5]
    damp_lin, damp_ang = bc[..., 6], bc[..., 7]

    ia, ib, color, cflags = x.cint.unbind(-1)
    cons = unpack_cons(x.cfields, cflags)
    cwa, cwb = (cflags & C_WRITE_A) != 0, (cflags & C_WRITE_B) != 0
    cwin = (cflags & C_WINNER) != 0
    ja, jb, jcolor, jflags = x.jint.unbind(-1)
    jcons = unpack_joints(x.jfields, jflags)
    jwa, jwb = (jflags & J_WRITE_A) != 0, (jflags & J_WRITE_B) != 0
    jwin = (jflags & J_WINNER) != 0
    c_table = dense_plan(x.c_off, x.c_ent)
    j_table = dense_plan(x.j_off, x.j_ent)

    def rows(bs, idx):
        return unpack_body_state(bs[worlds, idx])

    def integrate_velocities(bs):
        v, w = bs[..., 0:2], bs[..., 2]
        v2 = (v + (h * inv_mass)[..., None] * mass_grav) * damp_lin[..., None]
        w2 = (w + h * inv_i_tau) * damp_ang
        v = torch.where(dyn[..., None], v2, v)
        w = torch.where(dyn, w2, w)
        return torch.cat([v, w[..., None], bs[..., 3:]], dim=-1)

    def integrate_positions(bs):
        v, w, dp, rot = unpack_body_state(bs)
        dp = torch.where(move[..., None], dp + h * v, dp)
        rot = torch.where(move[..., None], m.integrate_rot(rot, h * w), rot)
        return pack_body_state(v, w, dp, rot)

    def joint_warm(bs, jimp):
        _, _, _, qA = rows(bs, ja)
        _, _, _, qB = rows(bs, jb)
        rA = m.rotate(qA, jcons.local_anchor_a)
        rB = m.rotate(qB, jcons.local_anchor_b)
        P = jimp[..., 0:2]
        axial = torch.where(jcons.is_mouse, jimp[..., 2], jimp[..., 2] + jimp[..., 3] - jimp[..., 4])
        dA = torch.cat([-jcons.inv_mass_a[..., None] * P, (-jcons.inv_i_a * (m.cross(rA, P) + axial))[..., None]], -1)
        dB = torch.cat([jcons.inv_mass_b[..., None] * P, (jcons.inv_i_b * (m.cross(rB, P) + axial))[..., None]], -1)
        return apply_plan(bs, torch.cat([dA, dB], dim=1), *j_table)

    def contact_warm(bs, n_imp, t_imp):
        if script.fixed_warm:
            rA, rB = cons.r_a0, cons.r_b0
        else:
            _, _, _, qA = rows(bs, ia)
            _, _, _, qB = rows(bs, ib)
            rA = m.rotate(qA[..., None, :], cons.local_anchor_a)
            rB = m.rotate(qB[..., None, :], cons.local_anchor_b)
        tangent = m.right_perp(cons.normal)
        P = n_imp[..., None] * cons.normal[..., None, :] + t_imp[..., None] * tangent[..., None, :]
        P = torch.where(cons.pmask[..., None], P, 0.0)
        tq_a = m.cross(rA, P)
        tq_b = m.cross(rB, P)
        P_tot = P[..., 0, :] + P[..., 1, :]
        dA = torch.cat([-cons.inv_mass_a[..., None] * P_tot, (-cons.inv_i_a * (tq_a[..., 0] + tq_a[..., 1]))[..., None]], -1)
        dB = torch.cat([cons.inv_mass_b[..., None] * P_tot, (cons.inv_i_b * (tq_b[..., 0] + tq_b[..., 1]))[..., None]], -1)
        return apply_plan(bs, torch.cat([dA, dB], dim=1), *c_table)

    def joint_colors(bs, jimp, use_bias, solve_mouse):
        for k in range(n_joint_colors):
            vA, wA, dcA, qA = rows(bs, ja)
            vB, wB, dcB, qB = rows(bs, jb)
            imp = jk.JointImp(jimp[..., 0:2], jimp[..., 2], jimp[..., 3], jimp[..., 4])
            vA2, wA2, vB2, wB2, new_imp, imp2, scope = jk.solve_joint_core(
                jcons, vA, wA, vB, wB, qA, qB, dcA, dcB, imp, h, inv_h, use_bias, solve_mouse
            )
            upd = (jcolor == k) & scope & jwin
            bs = _write_rows(bs, ja, upd & jwa, vA2, wA2)
            bs = _write_rows(bs, jb, upd & jwb, vB2, wB2)
            new5 = torch.cat([new_imp, imp2.motor[..., None], imp2.lower[..., None], imp2.upper[..., None]], -1)
            jimp = torch.where(upd[..., None], new5, jimp)
        return bs, jimp

    def contact_colors(bs, n_imp, t_imp, use_bias):
        for k in range(n_colors):
            vA, wA, dcA, qA = rows(bs, ia)
            vB, wB, dcB, qB = rows(bs, ib)
            vA2, wA2, vB2, wB2, n2, t2 = ck.solve_contact_core(
                cons, vA, wA, vB, wB, qA, qB, dcA, dcB, n_imp, t_imp, script.mode, inv_h, use_bias
            )
            upd = (color == k) & cons.active & cwin
            bs = _write_rows(bs, ia, upd & cwa, vA2, wA2)
            bs = _write_rows(bs, ib, upd & cwb, vB2, wB2)
            n_imp = torch.where(upd[..., None], n2, n_imp)
            t_imp = torch.where(upd[..., None], t2, t_imp)
        return bs, n_imp, t_imp

    def relax_pass(bs, n_imp, t_imp, jimp):
        bs, jimp = joint_colors(bs, jimp, False, False)
        bs, n_imp, t_imp = contact_colors(bs, n_imp, t_imp, False)
        return bs, n_imp, t_imp, jimp

    bs, n_imp, t_imp, jimp = x.bs, x.n_imp, x.t_imp, x.jimp
    if script.loop == "substep":
        for _ in range(substeps):
            bs = integrate_velocities(bs)
            if warm_start:
                bs = joint_warm(bs, jimp)
                bs = contact_warm(bs, n_imp, t_imp)
            bs, jimp = joint_colors(bs, jimp, True, True)
            bs, n_imp, t_imp = contact_colors(bs, n_imp, t_imp, True)
            bs = integrate_positions(bs)
            if relax:
                bs, n_imp, t_imp, jimp = relax_pass(bs, n_imp, t_imp, jimp)
        return bs, n_imp, t_imp, jimp
    # the PGS loop warms contacts before joints
    bs = integrate_velocities(bs)
    if warm_start:
        bs = contact_warm(bs, n_imp, t_imp)
        bs = joint_warm(bs, jimp)
    for _ in range(substeps):
        bs, jimp = joint_colors(bs, jimp, True, True)
        bs, n_imp, t_imp = contact_colors(bs, n_imp, t_imp, True)
    bs = integrate_positions(bs)
    for _ in range(relax):
        bs, n_imp, t_imp, jimp = relax_pass(bs, n_imp, t_imp, jimp)
    return bs, n_imp, t_imp, jimp
