"""Shared solver pieces: integration, packed body state, contact
preparation, impulse store, body maps, and the colored passes of the
per-world XLA solvers.

Port of the JAX package's `solvers/common.py`. Functions broadcast over
leading dims: the per-world step calls them on [worlds, bodies] and
[worlds, contacts]. Scalars that depend on the step (h, inv_h, hertz) are
0-dim float32 tensors, formed as the JAX package forms them.

The per-world passes (`gather_rows2`, `gather_apply`) take [W, ...] tensors and the constraints' body
indices as int32 tensors beside their constraint rows; the JAX package
carries those indices inside its rows as floats (`_i2f`), a TPU
workaround the port leaves behind. Warm-start and Jacobi sums follow the
JAX package's scatter-add order on the CPU (`body_plan`), never atomics.
The port's bucketed layout and its NGS contact pass are not copied.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import CONTACT_ZETA, PI
from ..ops import math2d as m
from ..ops.coloring import build_body_map
from ..state import Bodies

I32 = torch.int32


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


def body_const_rows(bodies):
    """The per-body constant rows the contact prepare gathers: [inv_mass,
    inv_I, rot(2), local_center(2)]."""
    return torch.cat(
        [bodies.inv_mass[..., None], bodies.inv_inertia[..., None], bodies.rot, bodies.local_center], dim=-1
    )


def prepare_contacts(contacts, ra, rb, *, h, hertz, warm_start: bool, soft: bool = True):
    """Soft contact preparation (reference: src/solve_common.c:188-274), or
    the PGS one (`soft=False`, :93-168), which differ in the bias, mass and
    impulse coefficients only. `contacts` has the fields of `Contacts` in
    any leading shape; ra, rb are the endpoints' constant rows
    (`body_const_rows`). Returns (cons, normal_impulse, tangent_impulse)."""
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

    if soft:
        # stiffer against statics (solve_common.c:219); per contact, stored per point
        contact_hertz = torch.where((mA == 0.0) | (mB == 0.0), 2.0 * hertz, hertz)
        omega = (2.0 * PI * contact_hertz)[..., None].expand(sep.shape)
        c = h * omega * (2.0 * CONTACT_ZETA + h * omega)
        bias_coef = omega / (2.0 * CONTACT_ZETA + h * omega)
        imp_coef = 1.0 / (1.0 + c)
        mass_coef = c * imp_coef
    else:
        bias_coef = torch.where(sep > 0.0, 1.0, 0.0)
        mass_coef = torch.ones_like(sep)
        imp_coef = torch.zeros_like(sep)
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


# ---------------------------------------------------- the per-world XLA route
#
# Body state [W, B, 8] (`pack_body_state`); constraints [W, N, ...] with
# their body indices ia, ib [W, N] (int32). Within a color every dynamic
# body is written by at most one constraint, so a pass gathers its
# endpoints' rows, solves every constraint of the set, and reads each
# body's new row back through the body map's slot (`gather_apply`).


def _worlds(x):
    return torch.arange(x.shape[0], device=x.device)[:, None]


def integrate_velocities_packed(bodies, bs, gravity, h):
    """integrate_velocities on packed rows; gravity [W, 2]."""
    v, w, dp, rot = unpack_body_state(bs)
    v, w = integrate_velocities(bodies, v, w, gravity[:, None, :], h)
    return pack_body_state(v, w, dp, rot)


def integrate_positions_packed(bodies, bs, h):
    v, w, dp, rot = unpack_body_state(bs)
    dp, rot = integrate_positions(bodies.alive, bodies.type, dp, rot, v, w, h)
    return pack_body_state(v, w, dp, rot)


def gather_rows2(bs, ia, ib):
    """The body rows of both endpoints of every constraint: (rows_a,
    rows_b), each [W, N, 8]."""
    N = ia.shape[1]
    rows = bs[_worlds(bs), torch.cat([ia, ib], dim=1)]
    return rows[:, :N], rows[:, N:]


def gather_apply(bs, slot_k, ia, out_a, out_b):
    """Body b takes the new row of the constraint slot_k[w, b] (its
    endpoint A's row if b is that constraint's body A, else its B's), or
    keeps its row where slot_k is -1. out_a, out_b [W, N, 8]."""
    B = bs.shape[1]
    w = _worlds(bs)
    ci = torch.clamp(slot_k, min=0)
    is_a = ia[w, ci] == torch.arange(B, dtype=ia.dtype, device=ia.device)
    sel = torch.where(is_a[..., None], out_a[w, ci], out_b[w, ci])
    return torch.where((slot_k >= 0)[..., None], sel, bs)


def entry_plan(body, keep, order, n_bodies: int):
    """CSR of the kept entries of each body, per world: offsets [W, B+1]
    into entries [W, E], which list entry indices by body and then by
    `order` (non-negative, unique per world, < 2^40)."""
    W, E = body.shape
    key = torch.where(keep, body.long() * (1 << 40) + order, n_bodies * (1 << 40))
    skey, ent = torch.sort(key, dim=1)
    bounds = torch.arange(n_bodies + 1, device=body.device, dtype=torch.long) * (1 << 40)
    off = torch.searchsorted(skey, bounds.expand(W, -1).contiguous(), side="left").to(I32)
    return off.contiguous(), ent.to(I32).contiguous()


def dense_plan(off, ent, depth=None):
    """The plan as a table [W, B, D] of entries and its mask [W, B, D];
    D is `depth` if given (at least the most entries of a body), else
    that most (a host sync)."""
    cnt = off[:, 1:] - off[:, :-1]
    D = depth if depth is not None else int(cnt.max()) if cnt.numel() else 0
    d = torch.arange(D, device=off.device)
    pos = (off[:, :-1, None] + d).long()
    has = d < cnt[..., None]
    rows = torch.gather(ent, 1, torch.clamp(pos, max=ent.shape[1] - 1).flatten(1)).reshape(pos.shape)
    return torch.where(has, rows, 0).long(), has


def apply_plan(bs, delta, table, has):
    """bs[..., 0:3] += each of a body's planned deltas, one after another."""
    W = bs.shape[0]
    worlds = torch.arange(W, device=bs.device)[:, None]
    vw = bs[..., 0:3]
    for d in range(table.shape[2]):
        vw = torch.where(has[..., d, None], vw + delta[worlds, table[..., d]], vw)
    return torch.cat([vw, bs[..., 3:]], dim=-1)


def body_plan(ia, ib, keep_a, keep_b, n_bodies: int, depth=None):
    """The ordered scatter-add plan of per-constraint endpoint deltas into
    bodies: for each body its kept entries of cat([ia, ib]) in that order,
    the order in which the JAX package's scatter-add sums them on the CPU.
    Entries left out add exact zeros there (constraints without live points,
    bodies that are not dynamic). Returns (table, has) [W, B, D]; build it
    once a step; without `depth` (see `dense_plan`) it syncs the host."""
    W, N = ia.shape
    pos = torch.arange(2 * N, device=ia.device).expand(W, -1)
    off, ent = entry_plan(torch.cat([ia, ib], dim=1), torch.cat([keep_a, keep_b], dim=1), pos, n_bodies)
    return dense_plan(off, ent, depth)


def scatter_vw(bs, delta_a, delta_b, plan):
    """Add the endpoint deltas [W, N, 3] (of v, w) to the bodies' rows in
    the plan's order."""
    return apply_plan(bs, torch.cat([delta_a, delta_b], dim=1), *plan)


def warm_start_packed(bs, cons: ContactCons, ia, ib, n_imp, t_imp, plan, fixed_anchors: bool = False):
    """Apply the contacts' accumulated impulses to their bodies (reference:
    src/solve_common.c:276-326; at the prepare-time anchors,
    solve_soft_step.c:16-63), summed in the plan's order."""
    if fixed_anchors:
        rA, rB = cons.r_a0, cons.r_b0
    else:
        rot = bs[..., 5:7]
        w = _worlds(bs)
        rA = m.rotate(rot[w, ia][..., None, :], cons.local_anchor_a)
        rB = m.rotate(rot[w, ib][..., None, :], cons.local_anchor_b)
    tangent = m.right_perp(cons.normal)
    P = n_imp[..., None] * cons.normal[..., None, :] + t_imp[..., None] * tangent[..., None, :]
    P = torch.where(cons.pmask[..., None], P, 0.0)
    P_tot = P.sum(dim=-2)
    torque_a = m.cross(rA, P).sum(dim=-1)
    torque_b = m.cross(rB, P).sum(dim=-1)
    dA = torch.cat([-cons.inv_mass_a[..., None] * P_tot, (-cons.inv_i_a * torque_a)[..., None]], dim=-1)
    dB = torch.cat([cons.inv_mass_b[..., None] * P_tot, (cons.inv_i_b * torque_b)[..., None]], dim=-1)
    return scatter_vw(bs, dA, dB, plan)



