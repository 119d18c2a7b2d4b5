"""Shared solver pieces: integration, packed body state, soft contact
preparation, impulse store, body maps.

Port of the JAX package's `solvers/common.py` for the soft solvers.
Functions broadcast over leading dims: the lane solve calls them on
[bodies, worlds] and [bucket positions, worlds] tensors, the per-world step
on [worlds, bodies] and [worlds, contacts]. Scalars that depend on the step (h,
inv_h, hertz) are 0-dim float32 tensors, formed as the JAX package forms
them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import CONTACT_ZETA, PI
from ..ops import math2d as m
from ..ops.coloring import build_body_map
from ..state import Bodies


def integrate_velocities(consts, v_in, w_in, gravity, h):
    """reference: src/solve_common.c:10-45. `consts` holds the per-body
    constants (type, alive, mass, inv_mass, inv_inertia, force, torque,
    damping, gravity_scale) with v_in's leading shape."""
    dyn = (consts.type == 2) & consts.alive
    mg = consts.mass[..., None] * consts.gravity_scale[..., None] * gravity
    v = v_in + (h * consts.inv_mass)[..., None] * (consts.force + mg)
    w = w_in + h * consts.inv_inertia * consts.torque
    v = v / (1.0 + h * consts.linear_damping)[..., None]
    w = w / (1.0 + h * consts.angular_damping)
    return torch.where(dyn[..., None], v, v_in), torch.where(dyn, w, w_in)


def integrate_positions(alive, body_type, delta_pos, rot, v, w, h):
    """reference: src/solve_common.c:47-68 (non-static bodies)"""
    moving = alive & (body_type != 0)
    dp = torch.where(moving[..., None], delta_pos + h * v, delta_pos)
    r = torch.where(moving[..., None], m.integrate_rot(rot, h * w), rot)
    return dp, r


def finalize_positions(bodies: Bodies, delta_pos, rot, v, w) -> Bodies:
    """position += delta; recompute the origin; clear forces
    (reference: src/solve_common.c:70-91)."""
    moving = bodies.alive & (bodies.type != 0)
    position = torch.where(moving[..., None], bodies.position + delta_pos, bodies.position)
    origin = torch.where(
        moving[..., None], position - m.rotate(rot, bodies.local_center), bodies.origin
    )
    return dataclasses.replace(
        bodies,
        origin=origin, position=position,
        delta_pos=torch.zeros_like(delta_pos), delta_pos0=torch.zeros_like(delta_pos),
        rot=rot, rot0=rot, v=v, w=w,
        force=torch.zeros_like(bodies.force), torque=torch.zeros_like(bodies.torque),
    )


def pack_body_state(v, w, dp, rot):
    """The solver's body state, one row a body: [vx, vy, w, dpx, dpy,
    rot_s, rot_c, pad]."""
    return torch.cat([v, w[..., None], dp, rot, torch.zeros_like(w[..., None])], dim=-1)


def unpack_body_state(bs):
    """(v [..., 2], w, delta_pos [..., 2], rot [..., 2]) of packed rows."""
    return bs[..., 0:2], bs[..., 2], bs[..., 3:5], bs[..., 5:7]


class ContactCons(NamedTuple):
    """Per-contact soft constraint data (reference: src/solvers.h:26-56);
    the point axis is the trailing [.., 2]."""

    inv_mass_a: torch.Tensor
    inv_i_a: torch.Tensor
    inv_mass_b: torch.Tensor
    inv_i_b: torch.Tensor
    normal: torch.Tensor           # [..., 2]
    friction: torch.Tensor
    active: torch.Tensor           # alive & point_count > 0
    pmask: torch.Tensor            # [..., 2] per-point validity
    local_anchor_a: torch.Tensor   # [..., 2, 2] center-of-mass relative
    local_anchor_b: torch.Tensor
    r_a0: torch.Tensor             # [..., 2, 2] world anchors at prepare
    r_b0: torch.Tensor
    separation: torch.Tensor       # [..., 2]
    adjusted_separation: torch.Tensor
    normal_mass: torch.Tensor
    tangent_mass: torch.Tensor
    bias_coef: torch.Tensor
    mass_coef: torch.Tensor
    imp_coef: torch.Tensor

    def rows(self, sl):
        """The constraints of a slice of the leading dim."""
        return ContactCons(*(x[sl] for x in self))


def _effective_masses(rA, rB, normal, mA, iA, mB, iB):
    tangent = m.right_perp(normal)
    rnA = m.cross(rA, normal[..., None, :])
    rnB = m.cross(rB, normal[..., None, :])
    k_n = mA[..., None] + mB[..., None] + iA[..., None] * rnA**2 + iB[..., None] * rnB**2
    rtA = m.cross(rA, tangent[..., None, :])
    rtB = m.cross(rB, tangent[..., None, :])
    k_t = mA[..., None] + mB[..., None] + iA[..., None] * rtA**2 + iB[..., None] * rtB**2
    nm = torch.where(k_n > 0.0, 1.0 / torch.where(k_n > 0.0, k_n, 1.0), 0.0)
    tm = torch.where(k_t > 0.0, 1.0 / torch.where(k_t > 0.0, k_t, 1.0), 0.0)
    return nm, tm


def prepare_contacts(contacts, ra, rb, *, h, hertz, warm_start: bool):
    """Soft contact preparation (reference: src/solve_common.c:188-274).
    `contacts` has the fields of `Contacts` in any leading shape; ra, rb are
    the endpoints' constant rows [inv_mass, inv_I, rot(2), local_center(2)].
    Returns (cons, normal_impulse, tangent_impulse)."""
    mA, iA, qA, lcA = ra[..., 0], ra[..., 1], ra[..., 2:4], ra[..., 4:6]
    mB, iB, qB, lcB = rb[..., 0], rb[..., 1], rb[..., 2:4], rb[..., 4:6]

    active = contacts.alive & (contacts.point_count > 0)
    pts = torch.arange(2, device=active.device)
    pmask = active[..., None] & (pts < contacts.point_count[..., None])

    normal = contacts.normal
    la = contacts.anchor_a - lcA[..., None, :]
    lb = contacts.anchor_b - lcB[..., None, :]
    rA = m.rotate(qA[..., None, :], la)
    rB = m.rotate(qB[..., None, :], lb)

    sep = contacts.separation
    adj = sep - ((rB - rA) * normal[..., None, :]).sum(-1)
    nm, tm = _effective_masses(rA, rB, normal, mA, iA, mB, iB)

    # stiffer against statics (solve_common.c:219); per contact, stored per point
    contact_hertz = torch.where((mA == 0.0) | (mB == 0.0), 2.0 * hertz, hertz)
    omega = (2.0 * PI * contact_hertz)[..., None].expand(sep.shape)
    c = h * omega * (2.0 * CONTACT_ZETA + h * omega)
    bias_coef = omega / (2.0 * CONTACT_ZETA + h * omega)
    imp_coef = 1.0 / (1.0 + c)
    mass_coef = c * imp_coef
    # the warm impulses are kept unconditionally (see the JAX package's note
    # on the PGS prep guard, solve_common.c:133)
    keep = pmask & warm_start
    n_imp = torch.where(keep, contacts.normal_impulse, 0.0)
    t_imp = torch.where(keep, contacts.tangent_impulse, 0.0)

    cons = ContactCons(
        inv_mass_a=mA, inv_i_a=iA, inv_mass_b=mB, inv_i_b=iB,
        normal=normal, friction=contacts.friction, active=active, pmask=pmask,
        local_anchor_a=la, local_anchor_b=lb, r_a0=rA, r_b0=rB,
        separation=sep, adjusted_separation=adj,
        normal_mass=nm, tangent_mass=tm,
        bias_coef=bias_coef, mass_coef=mass_coef, imp_coef=imp_coef,
    )
    return cons, n_imp, t_imp


def store_impulses(contacts, cons: ContactCons, n_imp, t_imp):
    """Keep the live points' impulses for the next step's warm start
    (reference: src/solve_common.c:396-410)."""
    return dataclasses.replace(
        contacts,
        normal_impulse=torch.where(cons.pmask, n_imp, contacts.normal_impulse),
        tangent_impulse=torch.where(cons.pmask, t_imp, contacts.tangent_impulse),
    )


class BodyMap(NamedTuple):
    """slot [B, K]: the color-k constraint writing body b (-1 none);
    winner [N]: the constraint owns its table entries."""

    slot: torch.Tensor
    winner: torch.Tensor


def make_body_map(body_a, body_b, color, active, dyn_mask, num_bodies: int, n_colors: int,
                  write_a_extra=None) -> BodyMap:
    """The body map of one constraint set ([N], dyn_mask [B]) or of one per
    world ([W, N], dyn_mask [W, B]). `write_a_extra` masks the A endpoints
    that are written (mouse joints never write body A)."""
    N = body_a.shape[-1]
    idx = torch.arange(N, dtype=torch.int32, device=body_a.device)
    write_a = torch.gather(dyn_mask, -1, body_a.long())
    write_b = torch.gather(dyn_mask, -1, body_b.long())
    if write_a_extra is not None:
        write_a = write_a & write_a_extra
    slot = build_body_map(body_a, body_b, color, active, write_a, write_b, num_bodies, n_colors)
    c = torch.clamp(color, 0, n_colors - 1)
    cells = torch.cat([body_a, body_b], dim=-1) * n_colors + torch.cat([c, c], dim=-1)
    got = torch.gather(slot.flatten(-2), -1, cells.long())
    own_a = ~write_a | (got[..., :N] == idx)
    own_b = ~write_b | (got[..., N:] == idx)
    return BodyMap(slot=slot, winner=own_a & own_b)
