"""Revolute and mouse joints on tensors.

Port of the JAX package's `solvers/joints.py`: preparation (reference:
revolute_joint.c:30-105 rigid, :421-506 soft, mouse_joint.c:31-83), the
motor and angle limits, the mouse joint's angular damping and the velocity
solve in its rigid (revolute_joint.c:152-303), soft (:508-657) and
Baumgarte (:660-790) modes (mouse_joint.c:109-159), the warm start, the NGS
position solve (:305-419) and the impulse store. Functions broadcast over
leading dims; `prepare_joints` takes a batch of worlds ([W, B] bodies,
[W, J] joints), the passes the per-world layout of `common.py`. The kernel
K1 (csrc/fused_solve.cu) repeats the soft `solve_joint_core` operation for
operation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import ANGULAR_SLOP, BAUMGARTE, MAX_ANGULAR_CORRECTION, PI
from ..ops import math2d as m
from .common import gather_apply, gather_rows2, pack_body_state, unpack_body_state


class JointCons(NamedTuple):
    """Per-joint soft constraint data; the pivot effective-mass inverse is
    stored as the three distinct entries of the symmetric 2x2."""

    is_mouse: torch.Tensor       # bool
    active: torch.Tensor         # bool
    inv_mass_a: torch.Tensor
    inv_i_a: torch.Tensor
    inv_mass_b: torch.Tensor
    inv_i_b: torch.Tensor
    local_anchor_a: torch.Tensor  # [..., 2] center-of-mass relative
    local_anchor_b: torch.Tensor
    center_diff0: torch.Tensor    # [..., 2]
    axial_mass: torch.Tensor
    pm11: torch.Tensor
    pm12: torch.Tensor
    pm22: torch.Tensor
    bias_coef: torch.Tensor
    mass_coef: torch.Tensor
    imp_coef: torch.Tensor
    reference_angle: torch.Tensor
    lower_angle: torch.Tensor
    upper_angle: torch.Tensor
    enable_limit: torch.Tensor    # bool
    enable_motor: torch.Tensor    # bool
    motor_speed: torch.Tensor
    max_motor_torque: torch.Tensor
    inertia_b: torch.Tensor       # body B's rotational inertia (mouse damping)


class JointImp(NamedTuple):
    impulse: torch.Tensor  # [..., 2]
    motor: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor


def _pivot_k(rA, rB, mA, mB, iA, iB):
    """The symmetric pivot effective-mass matrix as its three distinct
    entries (reference: revolute_joint.c:624-633)."""
    k11 = mA + mB + rA[..., 1] ** 2 * iA + rB[..., 1] ** 2 * iB
    k12 = -rA[..., 1] * rA[..., 0] * iA - rB[..., 1] * rB[..., 0] * iB
    k22 = mA + mB + rA[..., 0] ** 2 * iA + rB[..., 0] ** 2 * iB
    return k11, k12, k22


def _solve_sym(k11, k12, k22, b):
    """Solve [k11 k12; k12 k22] x = b; a singular matrix gives 0
    (math.h:410-420)."""
    det = k11 * k22 - k12 * k12
    inv_det = torch.where(det != 0.0, 1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    x = inv_det * (k22 * b[..., 0] - k12 * b[..., 1])
    y = inv_det * (k11 * b[..., 1] - k12 * b[..., 0])
    return torch.stack([x, y], dim=-1)


def _inv_sym(k11, k12, k22):
    det = k11 * k22 - k12 * k12
    inv_det = torch.where(det != 0.0, 1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    return inv_det * k22, -inv_det * k12, inv_det * k11


def prepare_joints(bodies, joints, *, h, hertz, warm_start: bool, soft: bool = True):
    """Revolute preparation, soft or rigid (`soft=False`: no revolute
    stiffness), and mouse preparation for a batch of worlds (bodies [W, B],
    joints [W, J]). h and hertz are 0-dim float32 tensors. Returns (cons,
    imp)."""
    W = joints.body_a.shape[0]
    worlds = torch.arange(W, device=joints.body_a.device)[:, None]
    ia, ib = joints.body_a, joints.body_b

    def at(x, i):
        return x[worlds, i]

    is_mouse = joints.type == 1
    # the mouse joint ignores body A (mouse_joint.c:31-107)
    mA = torch.where(is_mouse, 0.0, at(bodies.inv_mass, ia))
    iA = torch.where(is_mouse, 0.0, at(bodies.inv_inertia, ia))
    mB, iB = at(bodies.inv_mass, ib), at(bodies.inv_inertia, ib)

    la = joints.local_anchor_a - at(bodies.local_center, ia)
    lb = joints.local_anchor_b - at(bodies.local_center, ib)
    rA = m.rotate(at(bodies.rot, ia), la)
    rB = m.rotate(at(bodies.rot, ib), lb)
    pB = at(bodies.position, ib)
    center_diff0 = torch.where(
        is_mouse[..., None], pB - joints.target, pB - at(bodies.position, ia)  # mouse_joint.c:75, revolute :53
    )
    pm11, pm12, pm22 = _inv_sym(*_pivot_k(rA, rB, mA, mB, iA, iB))

    k_ax = iA + iB
    axial_mass = torch.where(k_ax > 0.0, 1.0 / torch.where(k_ax > 0.0, k_ax, 1.0), 0.0)
    fixed_rotation = k_ax == 0.0

    # the mouse joint has its own stiffness (mouse_joint.c:50-58); the soft
    # revolute joint the solver's joint hertz with zeta 10 (:470-477)
    zeta = torch.where(is_mouse, joints.damping_ratio, 10.0)
    hz = torch.where(is_mouse, joints.hertz, hertz if soft else 0.0)
    omega = 2.0 * PI * hz
    c = h * omega * (2.0 * zeta + h * omega)
    denom = 2.0 * zeta + h * omega
    bias_coef = torch.where(denom > 0.0, omega / torch.where(denom > 0.0, denom, 1.0), 0.0)
    imp_coef = 1.0 / (1.0 + c)
    mass_coef = c * imp_coef

    warm = joints.alive & warm_start
    keep_axial = warm & ~fixed_rotation
    imp = JointImp(
        impulse=torch.where(warm[..., None], joints.impulse, 0.0),
        # the mouse joint keeps its angular-damping state in motor_impulse
        motor=torch.where(is_mouse | (keep_axial & joints.enable_motor), joints.motor_impulse, 0.0),
        lower=torch.where(keep_axial & joints.enable_limit, joints.lower_impulse, 0.0),
        upper=torch.where(keep_axial & joints.enable_limit, joints.upper_impulse, 0.0),
    )
    cons = JointCons(
        is_mouse=is_mouse, active=joints.alive,
        inv_mass_a=mA, inv_i_a=iA, inv_mass_b=mB, inv_i_b=iB,
        local_anchor_a=la, local_anchor_b=lb, center_diff0=center_diff0,
        axial_mass=axial_mass, pm11=pm11, pm12=pm12, pm22=pm22,
        bias_coef=bias_coef, mass_coef=mass_coef, imp_coef=imp_coef,
        reference_angle=joints.reference_angle, lower_angle=joints.lower_angle,
        upper_angle=joints.upper_angle, enable_limit=joints.enable_limit,
        enable_motor=joints.enable_motor, motor_speed=joints.motor_speed,
        max_motor_torque=joints.max_motor_torque, inertia_b=at(bodies.inertia, ib),
    )
    return cons, imp


def _motor_limits(cons: JointCons, imp: JointImp, wA, wB, qA, qB, h, inv_h, use_bias: bool, mode: str = "soft"):
    """Motor and angle limits of the revolute joint: `mode` "rigid"
    (revolute_joint.c:174-219), "soft" (:527-603) or "baumgarte" (:679-747).
    Returns (wA, wB, imp)."""
    iA, iB = cons.inv_i_a, cons.inv_i_b
    fixed_rot = (iA + iB) == 0.0
    rev = ~cons.is_mouse & cons.active

    do_motor = rev & cons.enable_motor & ~fixed_rot
    cdot = wB - wA - cons.motor_speed
    impulse = -cons.axial_mass * cdot
    max_imp = h * cons.max_motor_torque
    new_motor = torch.minimum(torch.maximum(imp.motor + impulse, -max_imp), max_imp)
    d = torch.where(do_motor, new_motor - imp.motor, 0.0)
    motor = torch.where(do_motor, new_motor, imp.motor)
    wA = wA - iA * d
    wB = wB + iB * d

    do_limit = rev & cons.enable_limit & ~fixed_rot
    angle = m.relative_angle(qB, qA) - cons.reference_angle

    def limit(C, cdot, old, scale_imp):
        spec = C > 0.0
        mass_scale, imp_scale = 1.0, 0.0
        if mode == "rigid":
            bias = torch.clamp(C, min=0.0) * inv_h
        elif mode == "baumgarte":
            bias = torch.where(spec, C * inv_h, BAUMGARTE * inv_h * C if use_bias else 0.0)
        elif use_bias:
            bias = torch.where(spec, C * inv_h, cons.bias_coef * C)
            mass_scale = torch.where(spec, 1.0, cons.mass_coef)
            imp_scale = torch.where(spec, 0.0, cons.imp_coef)
        else:
            bias = torch.where(spec, C * inv_h, 0.0)
        impulse = -cons.axial_mass * mass_scale * (cdot + bias) - imp_scale * scale_imp
        return torch.clamp(old + impulse, min=0.0)

    new_lower = limit(angle - cons.lower_angle, wB - wA, imp.lower, imp.lower)
    d_lo = torch.where(do_limit, new_lower - imp.lower, 0.0)
    lower = torch.where(do_limit, new_lower, imp.lower)
    wA = wA - iA * d_lo
    wB = wB + iB * d_lo

    # the upper limit's impulse-scale term reads the lower impulse, as
    # revolute_joint.c:595 does
    new_upper = limit(cons.upper_angle - angle, wA - wB, imp.upper, imp.lower)
    d_hi = torch.where(do_limit, new_upper - imp.upper, 0.0)
    upper = torch.where(do_limit, new_upper, imp.upper)
    wA = wA + iA * d_hi
    wB = wB - iB * d_hi
    return wA, wB, imp._replace(motor=motor, lower=lower, upper=upper)


def _mouse_angular_damping(cons: JointCons, imp: JointImp, wB, h):
    """The mouse joint's angular damping (mouse_joint.c:120-131)."""
    zeta, hz = 0.1, 0.5
    omega = 2.0 * PI * hz
    c = h * omega * (2.0 * zeta + h * omega)
    imp_scale = 1.0 / (1.0 + c)
    mass_scale = c * imp_scale
    impulse = -mass_scale * cons.inertia_b * wB - imp_scale * imp.motor
    do = cons.is_mouse & cons.active
    motor = torch.where(do, imp.motor + impulse, imp.motor)
    wB = wB + torch.where(do, cons.inv_i_b * impulse, 0.0)
    return wB, imp._replace(motor=motor)


def solve_joint_core(cons: JointCons, vA, wA, vB, wB, qA, qB, dcA, dcB, imp: JointImp,
                     h, inv_h, use_bias: bool, solve_mouse: bool = True, mode: str = "soft",
                     only_mouse: bool = False):
    """The velocity solve of every joint, elementwise, in `mode` "soft",
    "rigid" or "baumgarte" (the mouse joint always soft). `solve_mouse`
    False leaves the mouse joints out of `scope`, `only_mouse` the others.
    Returns (vA, wA, vB, wB, new_impulse, imp2, scope): velocities outside
    `scope` are the inputs; the caller keeps the impulses of the joints it
    applies."""
    mA, iA = cons.inv_mass_a, cons.inv_i_a
    mB, iB = cons.inv_mass_b, cons.inv_i_b
    vA0, wA0, vB0, wB0 = vA, wA, vB, wB

    wA, wB, imp2 = _motor_limits(cons, imp, wA, wB, qA, qB, h, inv_h, use_bias, mode)
    if solve_mouse:
        wB, imp2 = _mouse_angular_damping(cons, imp2, wB, h)

    # point to point
    rA = m.rotate(qA, cons.local_anchor_a)
    rB = m.rotate(qB, cons.local_anchor_b)
    cdot = (vB + m.cross_sv(wB, rB)) - (vA + m.cross_sv(wA, rA))
    mouse = cons.is_mouse[..., None]
    # the mouse separation is dcB + rB + (cB0 - target) (mouse_joint.c:138-141)
    separation = torch.where(
        mouse, dcB + rB + cons.center_diff0, (dcB - dcA) + (rB - rA) + cons.center_diff0
    )
    # the mouse joint always uses its soft coefficients (mouse_joint.c:133-159)
    if mode == "soft" and use_bias:
        bias = cons.bias_coef[..., None] * separation
        mass_scale, imp_scale = cons.mass_coef, cons.imp_coef
    else:
        soft_bias = cons.bias_coef[..., None] * separation
        if mode == "baumgarte":  # always biased (revolute_joint.c:762-763)
            bias = torch.where(mouse, soft_bias, BAUMGARTE * inv_h * separation)
        else:
            bias = torch.where(mouse, soft_bias, 0.0)
        mass_scale = torch.where(cons.is_mouse, cons.mass_coef, 1.0)
        imp_scale = torch.where(cons.is_mouse, cons.imp_coef, 0.0)

    # fresh pivot mass for the revolute joint (revolute_joint.c:630-636),
    # the prepared one for the mouse joint (mouse_joint.c:153)
    rhs = cdot + bias
    b_fresh = _solve_sym(*_pivot_k(rA, rB, mA, mB, iA, iB), rhs)
    b_prep = torch.stack(
        [cons.pm11 * rhs[..., 0] + cons.pm12 * rhs[..., 1], cons.pm12 * rhs[..., 0] + cons.pm22 * rhs[..., 1]],
        dim=-1,
    )
    b = torch.where(mouse, b_prep, b_fresh)
    impulse = -mass_scale[..., None] * b - imp_scale[..., None] * imp2.impulse
    new_imp = imp2.impulse + impulse

    not_mouse = ~cons.is_mouse
    vA = vA - torch.where(not_mouse, mA, 0.0)[..., None] * impulse
    wA = wA - torch.where(not_mouse, iA, 0.0) * m.cross(rA, impulse)
    vB = vB + mB[..., None] * impulse
    wB = wB + iB * m.cross(rB, impulse)

    # relax passes leave mouse joints alone (joint.c:390-397); the XPBD loop
    # solves only the mouse joints in velocity space (joint.c:450-465)
    scope = cons.active if solve_mouse else cons.active & not_mouse
    if only_mouse:
        scope = scope & cons.is_mouse
    vA = torch.where(scope[..., None], vA, vA0)
    wA = torch.where(scope, wA, wA0)
    vB = torch.where(scope[..., None], vB, vB0)
    wB = torch.where(scope, wB, wB0)
    return vA, wA, vB, wB, new_imp, imp2, scope


def store_impulses(joints, cons: JointCons, imp: JointImp):
    """Keep the live joints' impulses for the next step's warm start."""
    a = cons.active
    return dataclasses.replace(
        joints,
        impulse=torch.where(a[..., None], imp.impulse, joints.impulse),
        motor_impulse=torch.where(a, imp.motor, joints.motor_impulse),
        lower_impulse=torch.where(a, imp.lower, joints.lower_impulse),
        upper_impulse=torch.where(a, imp.upper, joints.upper_impulse),
    )


# ------------------------------------------------------- the per-world passes
#
# Joint sets [W, J] with their body indices ia, ib [W, J], applied to the
# packed body state [W, B, 8] through a slot table (`common.gather_apply`).


def warm_start_apply(bs, cons: JointCons, ia, ib, imp: JointImp, slot_k):
    """Warm start one joint set (revolute_joint.c:107-150,
    mouse_joint.c:85-107)."""
    rows_a, rows_b = gather_rows2(bs, ia, ib)
    vA, wA, dcA, qA = unpack_body_state(rows_a)
    vB, wB, dcB, qB = unpack_body_state(rows_b)
    rA = m.rotate(qA, cons.local_anchor_a)
    rB = m.rotate(qB, cons.local_anchor_b)
    axial = torch.where(cons.is_mouse, imp.motor, imp.motor + imp.lower - imp.upper)
    P = imp.impulse
    vA2 = vA - cons.inv_mass_a[..., None] * P
    wA2 = wA - cons.inv_i_a * (m.cross(rA, P) + axial)
    vB2 = vB + cons.inv_mass_b[..., None] * P
    wB2 = wB + cons.inv_i_b * (m.cross(rB, P) + axial)
    return gather_apply(bs, slot_k, ia, pack_body_state(vA2, wA2, dcA, qA), pack_body_state(vB2, wB2, dcB, qB))


def solve_pass(carry, cons: JointCons, ia, ib, mode: str, h, inv_h, use_bias: bool, slot_k, upd,
               solve_mouse: bool = True, only_mouse: bool = False):
    """One joint velocity pass over a set: `upd` marks the joints whose
    impulses are kept (the color-k winners), to which `scope` is added.
    carry = (bs, imp)."""
    bs, imp = carry
    rows_a, rows_b = gather_rows2(bs, ia, ib)
    vA, wA, dcA, qA = unpack_body_state(rows_a)
    vB, wB, dcB, qB = unpack_body_state(rows_b)
    vA, wA, vB, wB, new_imp, imp2, scope = solve_joint_core(
        cons, vA, wA, vB, wB, qA, qB, dcA, dcB, imp, h, inv_h, use_bias, solve_mouse, mode, only_mouse
    )
    upd = upd & scope
    bs = gather_apply(bs, slot_k, ia, pack_body_state(vA, wA, dcA, qA), pack_body_state(vB, wB, dcB, qB))
    return bs, JointImp(
        impulse=torch.where(upd[..., None], new_imp, imp.impulse),
        motor=torch.where(upd, imp2.motor, imp.motor),
        lower=torch.where(upd, imp2.lower, imp.lower),
        upper=torch.where(upd, imp2.upper, imp.upper),
    )


def position_apply(bs, cons: JointCons, ia, ib, slot_k):
    """The NGS position solve of a joint set (revolute_joint.c:305-419): the
    angular limit's correction, then the point-to-point projection; mouse
    joints are left alone (joint.c:353-364)."""
    rows_a, rows_b = gather_rows2(bs, ia, ib)
    vA, wA, dcA, qA = unpack_body_state(rows_a)
    vB, wB, dcB, qB = unpack_body_state(rows_b)
    mA, iA = cons.inv_mass_a, cons.inv_i_a
    mB, iB = cons.inv_mass_b, cons.inv_i_b
    fixed_rot = (iA + iB) == 0.0
    rev = ~cons.is_mouse & cons.active

    # angular limit (revolute_joint.c:322-346)
    do_limit = rev & cons.enable_limit & ~fixed_rot
    angle = m.relative_angle(qB, qA) - cons.reference_angle
    equal = torch.abs(cons.upper_angle - cons.lower_angle) < 2.0 * ANGULAR_SLOP
    C_eq = torch.clamp(angle - cons.lower_angle, min=-MAX_ANGULAR_CORRECTION, max=MAX_ANGULAR_CORRECTION)
    C_lo = torch.clamp(angle - cons.lower_angle + ANGULAR_SLOP, min=-MAX_ANGULAR_CORRECTION, max=0.0)
    C_hi = torch.clamp(angle - cons.upper_angle - ANGULAR_SLOP, min=0.0, max=MAX_ANGULAR_CORRECTION)
    C = torch.where(
        equal, C_eq,
        torch.where(angle <= cons.lower_angle, C_lo, torch.where(angle >= cons.upper_angle, C_hi, 0.0)),
    )
    limit_imp = torch.where(do_limit, -cons.axial_mass * C, 0.0)
    qA2 = m.integrate_rot(qA, -iA * limit_imp)
    qB2 = m.integrate_rot(qB, iB * limit_imp)

    # point to point (revolute_joint.c:348-413)
    rA = m.rotate(qA2, cons.local_anchor_a)
    rB = m.rotate(qB2, cons.local_anchor_b)
    Cp = (dcB - dcA) + (rB - rA) + cons.center_diff0
    impulse = _solve_sym(*_pivot_k(rA, rB, mA, mB, iA, iB), -Cp)
    impulse = torch.where(rev[..., None], impulse, 0.0)
    dcA2 = dcA - mA[..., None] * impulse
    qA2 = m.integrate_rot(qA2, -iA * m.cross(rA, impulse))
    dcB2 = dcB + mB[..., None] * impulse
    qB2 = m.integrate_rot(qB2, iB * m.cross(rB, impulse))

    revn = rev[..., None]
    out_a = torch.where(revn, pack_body_state(vA, wA, dcA2, qA2), rows_a)
    out_b = torch.where(revn, pack_body_state(vB, wB, dcB2, qB2), rows_b)
    return gather_apply(bs, slot_k, ia, out_a, out_b)


