"""Contact velocity and position solves.

Port of the JAX package's `solvers/contact_kernels.py`. One core covers
the reference's per-solver contact sweeps, which differ only in anchor
handling, separation source and bias model (`SolveMode`):

- PGS Baumgarte        (reference: src/solve_pgs.c:17-122)
- plain PGS            (reference: src/solve_pgs_ngs.c:16-124)
- PGS soft / Jacobi    (reference: src/solve_pgs_soft.c:16-125, solve_jacobi.c:21-132)
- SoftStep fixed-TGS   (reference: src/solve_soft_step.c:66-177)
- TGS soft             (reference: src/solve_tgs_soft.c:17-135)
- TGS rigid            (reference: src/solve_tgs_ngs.c:91-201)

and the 2x2 block solver of PGS_NGS_Block (src/solve_pgs_ngs_block.c).
`solve_contact_core` is elementwise over leading dims (K1's twin calls
it); the block passes take the per-world layout of
`common.py` (body state [W, B, 8], constraints [W, N, ...] and their body
indices ia, ib).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import BAUMGARTE, LINEAR_SLOP, MAX_BAUMGARTE_VELOCITY, MAX_LINEAR_CORRECTION
from ..ops import math2d as m
from .common import ContactCons, gather_apply, gather_rows2, pack_body_state, unpack_body_state


@dataclasses.dataclass(frozen=True)
class SolveMode:
    sep_from_delta: bool       # separation from delta_pos/rot (TGS) vs prepared
    current_vel_anchors: bool  # anchors rotated by the current rotation vs rA0
    bias: str                  # "none" | "baumgarte" | "soft" | "spec_only"
    soft_clamp: float = 1.0    # scale on MAX_BAUMGARTE_VELOCITY for the soft bias
    friction_first: bool = False
    speculation: bool = True   # False: skip sep > 0 points and zero their impulses


PGS_BAUMGARTE = SolveMode(False, False, "baumgarte")
PGS_PLAIN = SolveMode(False, False, "none", friction_first=True, speculation=False)
PGS_SOFT = SolveMode(False, False, "soft", soft_clamp=0.5)
JACOBI_SOFT = SolveMode(False, False, "soft", soft_clamp=1.0)
SOFT_STEP = SolveMode(True, False, "soft", soft_clamp=0.5)
TGS_SOFT = SolveMode(True, True, "soft", soft_clamp=1.0)
TGS_RIGID = SolveMode(True, True, "spec_only")


def _apply(mA, iA, mB, iB, d, direction, vA, wA, vB, wB, rA, rB):
    P = d[..., None] * direction
    vA = vA - mA[..., None] * P
    wA = wA - iA * m.cross(rA, P)
    vB = vB + mB[..., None] * P
    wB = wB + iB * m.cross(rB, P)
    return vA, wA, vB, wB


def solve_contact_core(cons: ContactCons, vA, wA, vB, wB, qA, qB, dcA, dcB, n_imp, t_imp,
                       mode: SolveMode, inv_h, use_bias: bool):
    """Solve the normal and friction impulses of each contact's two points
    (normal first unless `mode.friction_first`), elementwise over the
    leading dims. Returns (vA, wA, vB, wB, n_imp, t_imp)."""
    mA, iA = cons.inv_mass_a, cons.inv_i_a
    mB, iB = cons.inv_mass_b, cons.inv_i_b
    normal = cons.normal
    tangent = m.right_perp(normal)

    def anchors(j):
        if mode.current_vel_anchors:
            return (m.rotate(qA, cons.local_anchor_a[..., j, :]),
                    m.rotate(qB, cons.local_anchor_b[..., j, :]))
        return cons.r_a0[..., j, :], cons.r_b0[..., j, :]

    def current_sep(j):
        if not mode.sep_from_delta:
            return cons.separation[..., j]
        rsA = m.rotate(qA, cons.local_anchor_a[..., j, :])
        rsB = m.rotate(qB, cons.local_anchor_b[..., j, :])
        ds = (dcB - dcA) + (rsB - rsA)
        return (ds * normal).sum(-1) + cons.adjusted_separation[..., j]

    def normal_point(j, vA, wA, vB, wB):
        rA, rB = anchors(j)
        s = current_sep(j)
        spec = s > 0.0
        mass_scale, imp_scale = 1.0, 0.0
        if mode.bias == "baumgarte":
            bias_pen = torch.clamp(BAUMGARTE * inv_h * torch.clamp(s + LINEAR_SLOP, max=0.0),
                                   min=-MAX_BAUMGARTE_VELOCITY)
            bias = torch.where(spec, s * inv_h, bias_pen)
        elif mode.bias == "soft" and use_bias:
            bias_pen = torch.clamp(cons.bias_coef[..., j] * s, min=-mode.soft_clamp * MAX_BAUMGARTE_VELOCITY)
            bias = torch.where(spec, s * inv_h, bias_pen)
            mass_scale = torch.where(spec, 1.0, cons.mass_coef[..., j])
            imp_scale = torch.where(spec, 0.0, cons.imp_coef[..., j])
        elif mode.bias in ("soft", "spec_only"):
            bias = torch.where(spec, s * inv_h, 0.0)
        else:  # none
            bias = torch.zeros_like(s)
        vr = (vB + m.cross_sv(wB, rB)) - (vA + m.cross_sv(wA, rA))
        vn = (vr * normal).sum(-1)
        old = n_cols[j]
        impulse = -cons.normal_mass[..., j] * mass_scale * (vn + bias) - imp_scale * old
        ok = cons.pmask[..., j]
        new_total = torch.where(ok, torch.clamp(old + impulse, min=0.0), old)
        d = new_total - old
        if not mode.speculation:
            # plain PGS zeroes the stored impulse of an open point without
            # un-applying it (solve_pgs_ngs.c:86-91 `continue`)
            new_total = torch.where(spec & ok, 0.0, new_total)
            d = torch.where(spec, 0.0, d)
        n_cols[j] = new_total
        return _apply(mA, iA, mB, iB, d, normal, vA, wA, vB, wB, rA, rB)

    def friction_point(j, vA, wA, vB, wB):
        rA, rB = anchors(j)
        vr = (vB + m.cross_sv(wB, rB)) - (vA + m.cross_sv(wA, rA))
        vt = (vr * tangent).sum(-1)
        lam = -cons.tangent_mass[..., j] * vt
        max_f = cons.friction * n_cols[j]
        old = t_cols[j]
        ok = cons.pmask[..., j]
        new_total = torch.where(ok, torch.clamp(old + lam, min=-max_f, max=max_f), old)
        d = new_total - old
        if not mode.speculation:
            open_ = cons.separation[..., j] > 0.0
            new_total = torch.where(open_ & ok, 0.0, new_total)
            d = torch.where(open_, 0.0, d)
        t_cols[j] = new_total
        return _apply(mA, iA, mB, iB, d, tangent, vA, wA, vB, wB, rA, rB)

    n_cols = [n_imp[..., 0], n_imp[..., 1]]
    t_cols = [t_imp[..., 0], t_imp[..., 1]]
    first, second = (friction_point, normal_point) if mode.friction_first else (normal_point, friction_point)
    for j in range(2):
        vA, wA, vB, wB = first(j, vA, wA, vB, wB)
    for j in range(2):
        vA, wA, vB, wB = second(j, vA, wA, vB, wB)
    return vA, wA, vB, wB, torch.stack(n_cols, dim=-1), torch.stack(t_cols, dim=-1)


# ----------------------------------------------------------- 2x2 block solver


def _mat22(a11, a12, a21, a22):
    return torch.stack([torch.stack([a11, a12], dim=-1), torch.stack([a21, a22], dim=-1)], dim=-2)


def _mul_mv(mat, v):
    return torch.stack(
        [mat[..., 0, 0] * v[..., 0] + mat[..., 0, 1] * v[..., 1],
         mat[..., 1, 0] * v[..., 0] + mat[..., 1, 1] * v[..., 1]],
        dim=-1,
    )


def _inverse22(mat):
    """Inverse with det == 0 giving the zero matrix (reference: math.h:392-406)."""
    a, b = mat[..., 0, 0], mat[..., 0, 1]
    c, d = mat[..., 1, 0], mat[..., 1, 1]
    det = a * d - b * c
    inv_det = torch.where(det != 0.0, 1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    return _mat22(inv_det * d, -inv_det * b, -inv_det * c, inv_det * a)


def prepare_block(cons: ContactCons, inv_dt):
    """The block solver's extras (reference: src/solve_pgs_ngs_block.c:135-279):
    the per-point speculative velocity bias, the 2x2 normal matrix K and its
    inverse, and the demotion to one point of a badly conditioned K.
    Returns (velocity_bias [..., 2], k_mat [..., 2, 2], block_mass, use_block,
    pmask_eff [..., 2])."""
    velocity_bias = -torch.clamp(cons.separation * inv_dt, min=0.0)
    normal = cons.normal
    rn1A = m.cross(cons.r_a0[..., 0, :], normal)
    rn1B = m.cross(cons.r_b0[..., 0, :], normal)
    rn2A = m.cross(cons.r_a0[..., 1, :], normal)
    rn2B = m.cross(cons.r_b0[..., 1, :], normal)
    mAB = cons.inv_mass_a + cons.inv_mass_b
    iA, iB = cons.inv_i_a, cons.inv_i_b
    k11 = mAB + iA * rn1A**2 + iB * rn1B**2
    k22 = mAB + iA * rn2A**2 + iB * rn2B**2
    k12 = mAB + iA * rn1A * rn2A + iB * rn1B * rn2B
    k_mat = _mat22(k11, k12, k12, k22)
    cond_ok = k11 * k11 < 1000.0 * (k11 * k22 - k12 * k12)  # block.c:260-267
    use_block = cons.pmask[..., 1] & cond_ok
    # demoted constraints use only point 0 (block.c:268-273)
    pmask_eff = torch.stack([cons.pmask[..., 0], use_block], dim=-1)
    return velocity_bias, k_mat, _inverse22(k_mat), use_block, pmask_eff


def block_velocity_pass(carry, cons: ContactCons, ia, ib, velocity_bias, k_mat, block_mass, use_block, pmask_eff,
                        slot_k, upd):
    """One pass of s2BlockSolveVelocity (block.c:329-658) over a constraint
    set: friction first, then the scalar normal of a one-point contact or
    the 2x2 LCP by total enumeration (all four cases evaluated, the first
    valid one taken). carry = (bs, n_imp, t_imp); slot_k and upd as in
    `gs_contact_pass`."""
    bs, n_imp, t_imp0 = carry
    rows_a, rows_b = gather_rows2(bs, ia, ib)
    vA, wA, dcA, qA = unpack_body_state(rows_a)
    vB, wB, dcB, qB = unpack_body_state(rows_b)
    mA, iA = cons.inv_mass_a, cons.inv_i_a
    mB, iB = cons.inv_mass_b, cons.inv_i_b
    normal = cons.normal
    tangent = m.right_perp(normal)
    rA1, rB1 = cons.r_a0[..., 0, :], cons.r_b0[..., 0, :]
    rA2, rB2 = cons.r_a0[..., 1, :], cons.r_b0[..., 1, :]

    # friction (block.c:364-392)
    t_cols = [t_imp0[..., 0], t_imp0[..., 1]]
    for j, (rA, rB) in enumerate(((rA1, rB1), (rA2, rB2))):
        vr = (vB + m.cross_sv(wB, rB)) - (vA + m.cross_sv(wA, rA))
        vt = (vr * tangent).sum(-1)
        lam = cons.tangent_mass[..., j] * (-vt)
        max_f = cons.friction * n_imp[..., j]
        old = t_cols[j]
        new = torch.where(pmask_eff[..., j], torch.clamp(old + lam, min=-max_f, max=max_f), old)
        t_cols[j] = new
        vA, wA, vB, wB = _apply(mA, iA, mB, iB, new - old, tangent, vA, wA, vB, wB, rA, rB)
    t_imp = torch.stack(t_cols, dim=-1)

    # scalar normal of one-point contacts (block.c:395-423)
    one_point = cons.pmask[..., 0] & ~use_block
    vr = (vB + m.cross_sv(wB, rB1)) - (vA + m.cross_sv(wA, rA1))
    vn = (vr * normal).sum(-1)
    lam = -cons.normal_mass[..., 0] * (vn - velocity_bias[..., 0])
    old0 = n_imp[..., 0]
    new0 = torch.clamp(old0 + lam, min=0.0)
    d0 = torch.where(one_point, new0 - old0, 0.0)
    vA_s, wA_s, vB_s, wB_s = _apply(mA, iA, mB, iB, d0, normal, vA, wA, vB, wB, rA1, rB1)
    n0_s = torch.where(one_point, new0, old0)

    # the 2x2 block LCP (block.c:424-651)
    a_acc = n_imp
    dv1 = (vB + m.cross_sv(wB, rB1)) - (vA + m.cross_sv(wA, rA1))
    dv2 = (vB + m.cross_sv(wB, rB2)) - (vA + m.cross_sv(wA, rA2))
    vn1 = (dv1 * normal).sum(-1)
    vn2 = (dv2 * normal).sum(-1)
    b = torch.stack([vn1 - velocity_bias[..., 0], vn2 - velocity_bias[..., 1]], dim=-1)
    b = b - _mul_mv(k_mat, a_acc)
    k12, k21 = k_mat[..., 0, 1], k_mat[..., 1, 0]
    zero = torch.zeros_like(k12)
    # case 1: both points active
    x1 = -_mul_mv(block_mass, b)
    ok1 = (x1[..., 0] >= 0.0) & (x1[..., 1] >= 0.0)
    # case 2: x2 = 0
    x2 = torch.stack([-cons.normal_mass[..., 0] * b[..., 0], zero], dim=-1)
    ok2 = (x2[..., 0] >= 0.0) & (k21 * x2[..., 0] + b[..., 1] >= 0.0)
    # case 3: x1 = 0
    x3 = torch.stack([zero, -cons.normal_mass[..., 1] * b[..., 1]], dim=-1)
    ok3 = (x3[..., 1] >= 0.0) & (k12 * x3[..., 1] + b[..., 0] >= 0.0)
    # case 4: both zero
    ok4 = (b[..., 0] >= 0.0) & (b[..., 1] >= 0.0)
    x = torch.where(
        ok1[..., None], x1,
        torch.where(ok2[..., None], x2,
                    torch.where(ok3[..., None], x3, torch.where(ok4[..., None], torch.zeros_like(x1), a_acc))),
    )
    d_blk = x - a_acc  # zero when no case applies (block.c:648-649 "give up")
    P1 = d_blk[..., 0:1] * normal
    P2 = d_blk[..., 1:2] * normal
    vA_b = vA - mA[..., None] * (P1 + P2)
    wA_b = wA - iA * (m.cross(rA1, P1) + m.cross(rA2, P2))
    vB_b = vB + mB[..., None] * (P1 + P2)
    wB_b = wB + iB * (m.cross(rB1, P1) + m.cross(rB2, P2))

    blk = use_block
    vA = torch.where(blk[..., None], vA_b, vA_s)
    wA = torch.where(blk, wA_b, wA_s)
    vB = torch.where(blk[..., None], vB_b, vB_s)
    wB = torch.where(blk, wB_b, wB_s)
    n_new = torch.where(blk[..., None], x, torch.stack([n0_s, n_imp[..., 1]], dim=-1))

    bs = gather_apply(bs, slot_k, ia, pack_body_state(vA, wA, dcA, qA), pack_body_state(vB, wB, dcB, qB))
    updn = upd[..., None]
    return bs, torch.where(updn, n_new, n_imp), torch.where(updn, t_imp, t_imp0)


def block_position_pass(bs, cons: ContactCons, ia, ib, use_block, slot_k):
    """s2BlockSolvePosition (block.c:679-890) over a constraint set: block
    NGS for two-point manifolds, scalar NGS otherwise."""
    rows_a, rows_b = gather_rows2(bs, ia, ib)
    vA, wA, dcA, qA = unpack_body_state(rows_a)
    vB, wB, dcB, qB = unpack_body_state(rows_b)
    mA, iA = cons.inv_mass_a, cons.inv_i_a
    mB, iB = cons.inv_mass_b, cons.inv_i_b
    normal = cons.normal

    # block path (2 points)
    rA1 = m.rotate(qA, cons.local_anchor_a[..., 0, :])
    rB1 = m.rotate(qB, cons.local_anchor_b[..., 0, :])
    rA2 = m.rotate(qA, cons.local_anchor_a[..., 1, :])
    rB2 = m.rotate(qB, cons.local_anchor_b[..., 1, :])
    dc = dcB - dcA
    s1 = ((dc + rB1 - rA1) * normal).sum(-1) + cons.adjusted_separation[..., 0]
    s2 = ((dc + rB2 - rA2) * normal).sum(-1) + cons.adjusted_separation[..., 1]
    C1 = torch.clamp(BAUMGARTE * (s1 + LINEAR_SLOP), min=-MAX_LINEAR_CORRECTION, max=0.0)
    C2 = torch.clamp(BAUMGARTE * (s2 + LINEAR_SLOP), min=-MAX_LINEAR_CORRECTION, max=0.0)
    bvec = torch.stack([C1, C2], dim=-1)
    rn1A = m.cross(rA1, normal)
    rn1B = m.cross(rB1, normal)
    rn2A = m.cross(rA2, normal)
    rn2B = m.cross(rB2, normal)
    mAB = mA + mB
    k11 = mAB + iA * rn1A**2 + iB * rn1B**2
    k22 = mAB + iA * rn2A**2 + iB * rn2B**2
    k12 = mAB + iA * rn1A * rn2A + iB * rn1B * rn2B
    cond_ok = k11 * k11 < 10000.0 * (k11 * k22 - k12 * k12)  # block.c:747-754
    inv_k = _inverse22(_mat22(k11, k12, k12, k22))
    zero = torch.zeros_like(k11)
    x1 = -_mul_mv(inv_k, bvec)
    ok1 = (x1[..., 0] >= 0.0) & (x1[..., 1] >= 0.0)
    x2 = torch.stack([-bvec[..., 0] / torch.where(k11 != 0, k11, 1.0), zero], dim=-1)
    ok2 = (x2[..., 0] >= 0.0) & (k12 * x2[..., 0] + bvec[..., 1] >= 0.0)
    x3 = torch.stack([zero, -bvec[..., 1] / torch.where(k22 != 0, k22, 1.0)], dim=-1)
    ok3 = (x3[..., 1] >= 0.0) & (k12 * x3[..., 1] + bvec[..., 0] >= 0.0)
    x = torch.where(ok1[..., None], x1, torch.where(ok2[..., None], x2, torch.where(ok3[..., None], x3, 0.0)))
    P1 = x[..., 0:1] * normal
    P2 = x[..., 1:2] * normal
    dcA_b = dcA - mA[..., None] * (P1 + P2)
    qA_b = m.integrate_rot(qA, -iA * (m.cross(rA1, P1) + m.cross(rA2, P2)))
    dcB_b = dcB + mB[..., None] * (P1 + P2)
    qB_b = m.integrate_rot(qB, iB * (m.cross(rB1, P1) + m.cross(rB2, P2)))

    # scalar path (one point, or a degenerate block)
    dcA_s, qA_s, dcB_s, qB_s = dcA, qA, dcB, qB
    for j in range(2):
        rA = m.rotate(qA_s, cons.local_anchor_a[..., j, :])
        rB = m.rotate(qB_s, cons.local_anchor_b[..., j, :])
        d = (dcB_s - dcA_s) + (rB - rA)
        sep = (d * normal).sum(-1) + cons.adjusted_separation[..., j]
        C = torch.clamp(BAUMGARTE * (sep + LINEAR_SLOP), min=-MAX_LINEAR_CORRECTION, max=0.0)
        rnA = m.cross(rA, normal)
        rnB = m.cross(rB, normal)
        Ks = mAB + iA * rnA**2 + iB * rnB**2
        impulse = torch.where(Ks > 0.0, -C / torch.where(Ks > 0.0, Ks, 1.0), 0.0)
        impulse = torch.where(cons.pmask[..., j], impulse, 0.0)
        P = impulse[..., None] * normal
        dcA_s = dcA_s - mA[..., None] * P
        qA_s = m.integrate_rot(qA_s, -iA * m.cross(rA, P))
        dcB_s = dcB_s + mB[..., None] * P
        qB_s = m.integrate_rot(qB_s, iB * m.cross(rB, P))

    blk = (use_block & cond_ok)[..., None]
    out_a = pack_body_state(vA, wA, torch.where(blk, dcA_b, dcA_s), torch.where(blk, qA_b, qA_s))
    out_b = pack_body_state(vB, wB, torch.where(blk, dcB_b, dcB_s), torch.where(blk, qB_b, qB_s))
    return gather_apply(bs, slot_k, ia, out_a, out_b)



