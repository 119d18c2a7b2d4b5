"""The soft contact velocity solve of one constraint set.

Port of the JAX package's `solvers/contact_kernels.py:solve_contact_core` in
its soft modes: TGS_Soft (reference: src/solve_tgs_soft.c:17-135), SoftStep
(src/solve_soft_step.c:66-177) and PGS_Soft (src/solve_pgs_soft.c:16-125).
They differ only in where the anchors and the separation come from and in
the clamp of the soft bias.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MAX_BAUMGARTE_VELOCITY
from ..ops import math2d as m
from .common import ContactCons


@dataclasses.dataclass(frozen=True)
class SolveMode:
    sep_from_delta: bool       # separation from delta_pos/rot (TGS) vs prepared
    current_vel_anchors: bool  # anchors rotated by the current rotation vs rA0
    soft_clamp: float          # scale on MAX_BAUMGARTE_VELOCITY for the bias


PGS_SOFT = SolveMode(False, False, soft_clamp=0.5)
SOFT_STEP = SolveMode(True, False, soft_clamp=0.5)
TGS_SOFT = SolveMode(True, True, soft_clamp=1.0)


def solve_contact_core(cons: ContactCons, vA, wA, vB, wB, qA, qB, dcA, dcB, n_imp, t_imp,
                       mode: SolveMode, inv_h, use_bias: bool):
    """Solve normal then friction impulses of each contact's two points,
    elementwise over the leading dims. Returns (vA, wA, vB, wB, n_imp, t_imp)."""
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

    def apply(d, direction, vA, wA, vB, wB, rA, rB):
        P = d[..., None] * direction
        vA = vA - mA[..., None] * P
        wA = wA - iA * m.cross(rA, P)
        vB = vB + mB[..., None] * P
        wB = wB + iB * m.cross(rB, P)
        return vA, wA, vB, wB

    n_cols = [n_imp[..., 0], n_imp[..., 1]]
    t_cols = [t_imp[..., 0], t_imp[..., 1]]

    for j in range(2):
        rA, rB = anchors(j)
        s = current_sep(j)
        spec = s > 0.0
        if use_bias:
            bias_pen = torch.clamp(cons.bias_coef[..., j] * s, min=-mode.soft_clamp * MAX_BAUMGARTE_VELOCITY)
            bias = torch.where(spec, s * inv_h, bias_pen)
            mass_scale = torch.where(spec, 1.0, cons.mass_coef[..., j])
            imp_scale = torch.where(spec, 0.0, cons.imp_coef[..., j])
        else:
            bias = torch.where(spec, s * inv_h, 0.0)
            mass_scale, imp_scale = 1.0, 0.0
        vr = (vB + m.cross_sv(wB, rB)) - (vA + m.cross_sv(wA, rA))
        vn = (vr * normal).sum(-1)
        old = n_cols[j]
        impulse = -cons.normal_mass[..., j] * mass_scale * (vn + bias) - imp_scale * old
        new_total = torch.where(cons.pmask[..., j], torch.clamp(old + impulse, min=0.0), old)
        n_cols[j] = new_total
        vA, wA, vB, wB = apply(new_total - old, normal, vA, wA, vB, wB, rA, rB)

    for j in range(2):
        rA, rB = anchors(j)
        vr = (vB + m.cross_sv(wB, rB)) - (vA + m.cross_sv(wA, rA))
        vt = (vr * tangent).sum(-1)
        lam = -cons.tangent_mass[..., j] * vt
        max_f = cons.friction * n_cols[j]
        old = t_cols[j]
        new_total = torch.where(cons.pmask[..., j], torch.clamp(old + lam, min=-max_f, max=max_f), old)
        t_cols[j] = new_total
        vA, wA, vB, wB = apply(new_total - old, tangent, vA, wA, vB, wB, rA, rB)

    return vA, wA, vB, wB, torch.stack(n_cols, dim=-1), torch.stack(t_cols, dim=-1)
