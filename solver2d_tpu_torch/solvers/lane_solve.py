"""Lane-batched contact solve: shared constraint structure, worlds in lanes.

Port of the JAX package's `solvers/lane_solve.py`. The constraint structure
(colors, buckets, body map) comes from world 0 and is shared by every world
of a lockstep batch; body state is [B, W, 8] (one row per body, all worlds)
and constraints are [T, W, ...] in bucket-position-major order, so each
color phase gathers its endpoints' rows once for all worlds. A world whose
contact at a bucket slot is not world 0's pair is masked out of that
constraint and counted in its `mismatch`.

Body state lanes: [vx, vy, w, dpx, dpy, rot_s, rot_c, pad].
Reference scripts: solve_tgs_soft.c:138-280 (TGS_Soft),
solve_soft_step.c:182-311 (SoftStep: TGS_Soft's substeps with the
prepare-time anchors), solve_pgs_soft.c:127-242 (PGS_Soft).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import CONTACT_HERTZ, SimConfig
from ..ops import coloring
from ..ops import math2d as m
from . import contact_kernels as ck
from .common import (
    finalize_positions,
    integrate_positions,
    integrate_velocities,
    make_body_map,
    pack_body_state,
    prepare_contacts,
    unpack_body_state,
)
from .scripts import SOLVER_SCRIPTS, step_size

I32 = torch.int32


class LaneStructure(NamedTuple):
    """Shared (world-0) constraint structure for one lane-batched step."""

    bucket: torch.Tensor       # [T] i32 contact slot per bucket position (-1 pad)
    ia: torch.Tensor           # [T] i32 endpoint A body
    ib: torch.Tensor           # [T] i32 endpoint B body
    slot: torch.Tensor         # [B, K] i32 bucket-global body map
    winner: torch.Tensor       # [T] bool constraint owns its map entries
    is_a: torch.Tensor         # [B, K] bool the slot's constraint has this body as A
    ccolor: torch.Tensor       # [C] i32 world-0 colors
    shared_overflow: torch.Tensor  # [] i32 world-0 color + bucket + winner overflow


class _LaneContacts(NamedTuple):
    """The contact fields prepare_contacts reads, [T, W, ...]."""

    alive: torch.Tensor
    point_count: torch.Tensor
    normal: torch.Tensor
    anchor_a: torch.Tensor
    anchor_b: torch.Tensor
    separation: torch.Tensor
    friction: torch.Tensor
    normal_impulse: torch.Tensor
    tangent_impulse: torch.Tensor


def _t2(x):
    """[W, N, ...] -> [N, W, ...] (worlds to lanes)."""
    return x.transpose(0, 1)


def build_lane_structure(contacts, dyn0, config: SimConfig) -> LaneStructure:
    """Color and bucket world 0's contact graph, and derive the shared solve
    structure."""
    B = config.max_bodies
    cap = config.contact_bucket_cap
    K = config.max_colors

    ba0 = contacts.body_a[0]
    bb0 = contacts.body_b[0]
    touching0 = contacts.alive[0] & (contacts.point_count[0] > 0)
    ccolor, c_ovf = coloring.assign_colors(
        contacts.color[0], ba0, bb0, touching0, dyn0, B, K,
        rounds=config.color_rounds, bucket_cap=cap,
    )
    c_active = touching0 & (ccolor >= 0)
    bucket, ccolor, drop = coloring.build_color_buckets(ccolor, c_active, K, cap)
    bi = torch.clamp(bucket, min=0)
    active_b = c_active[bi] & (bucket >= 0)
    color_b = torch.arange(K, dtype=I32, device=bucket.device).repeat_interleave(cap)
    ia = ba0[bi]
    ib = bb0[bi]
    cmap = make_body_map(ia, ib, color_b, active_b, dyn0, B, K)
    shared_ovf = (c_ovf + drop + (active_b & ~cmap.winner).sum()).to(I32)
    owner_a = ia[torch.clamp(cmap.slot, min=0).reshape(-1)].reshape(B, K)
    is_a = owner_a == torch.arange(B, dtype=I32, device=bucket.device)[:, None]
    return LaneStructure(
        bucket=bucket, ia=ia, ib=ib, slot=cmap.slot, winner=cmap.winner,
        is_a=is_a, ccolor=ccolor, shared_overflow=shared_ovf,
    )


def _permute_contacts_lane(contacts, struct: LaneStructure):
    """The per-world contact fields in bucket order [T, W, ...], with lanes
    whose pair is not the shared structure's masked dead. Returns (covered
    [W], contacts): covered counts each world's touching lanes."""
    bi = torch.clamp(struct.bucket, min=0)

    def g(x):
        return _t2(x[:, bi])

    valid = (struct.bucket >= 0)[:, None]
    match = valid & (g(contacts.body_a) == struct.ia[:, None]) & (g(contacts.body_b) == struct.ib[:, None])
    alive = g(contacts.alive) & match
    point_count = g(contacts.point_count)
    covered = (alive & (point_count > 0)).sum(dim=0).to(I32)
    return covered, _LaneContacts(
        alive=alive, point_count=point_count,
        normal=g(contacts.normal), anchor_a=g(contacts.anchor_a), anchor_b=g(contacts.anchor_b),
        separation=g(contacts.separation), friction=g(contacts.friction),
        normal_impulse=g(contacts.normal_impulse), tangent_impulse=g(contacts.tangent_impulse),
    )


def _scatter_plan(idx, n_rows: int):
    """The plan of an ordered scatter-add into n_rows rows: table[r, d] is
    the d-th entry of idx that names row r, in the order of idx (the
    sentinel len(idx) pads); entries with idx >= n_rows are dropped.

    Summing each row's terms in a fixed order makes the sums equal in every
    world and on every device (an atomic scatter-add on the card orders
    them differently from world to world, and lockstep worlds would drift
    apart). It is the order of the JAX package's scatter on the CPU."""
    dev = idx.device
    sel = torch.nonzero(idx < n_rows).flatten()
    i = idx[sel].long()
    order = torch.argsort(i, stable=True)
    si = i[order]
    counts = torch.bincount(i, minlength=n_rows)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(si.shape[0], device=dev) - starts[si]
    depth = int(counts.max()) if si.shape[0] else 0
    table = torch.full((n_rows, max(depth, 1)), idx.shape[0], dtype=torch.long, device=dev)
    table[si, rank] = sel[order]
    return table[:, :depth]


def _scatter_add_planned(target, vals, table):
    padded = torch.cat([vals, torch.zeros_like(vals[:1])])
    out = target
    for d in range(table.shape[1]):
        out = out + padded[table[:, d]]
    return out


def _lane_warm_start(bs, cons, n_imp, t_imp, struct: LaneStructure, plan, fixed_anchors: bool):
    """Apply the warm-start impulses of both endpoints (reference:
    src/solve_common.c:276-326; at the prepare-time anchors,
    solve_soft_step.c:16-63) with the ordered scatter `plan` over
    cat([ia, ib])."""
    if fixed_anchors:
        rA, rB = cons.r_a0, cons.r_b0
    else:
        rA = _rot_anchor(bs, struct.ia, cons.local_anchor_a)
        rB = _rot_anchor(bs, struct.ib, cons.local_anchor_b)
    tangent = m.right_perp(cons.normal)
    P = n_imp[..., None] * cons.normal[..., None, :] + t_imp[..., None] * tangent[..., None, :]
    P = torch.where(cons.pmask[..., None], P, 0.0)
    P_tot = P.sum(dim=-2)
    torque_a = m.cross(rA, P).sum(dim=-1)
    torque_b = m.cross(rB, P).sum(dim=-1)
    z2 = torch.zeros_like(P_tot)
    z1 = torch.zeros_like(torque_a[..., None])
    dA = torch.cat([-cons.inv_mass_a[..., None] * P_tot, (-cons.inv_i_a * torque_a)[..., None], z2, z2, z1], dim=-1)
    dB = torch.cat([cons.inv_mass_b[..., None] * P_tot, (cons.inv_i_b * torque_b)[..., None], z2, z2, z1], dim=-1)
    return _scatter_add_planned(bs, torch.cat([dA, dB]), plan)


def _rot_anchor(bs, idx, local_anchor):
    """World anchors [T, W, 2, 2] of the endpoints `idx` at their current
    rotation."""
    q = bs[idx][..., 5:7]
    return m.rotate(q[..., None, :], local_anchor)


def _lane_gs_sweep(bs, n_imp, t_imp, cons, struct: LaneStructure, cfg: SimConfig, mode, inv_h, use_bias):
    """One colored Gauss-Seidel sweep over all colors. Within a color every
    dynamic body is written by at most one constraint, so the new body rows
    are read back through the body map (slot) instead of scattered. The
    impulse tensors, owned by the solve, are updated in place."""
    cap = cfg.contact_bucket_cap
    for k in range(cfg.max_colors):
        sl = slice(k * cap, (k + 1) * cap)
        cons_k = cons.rows(sl)
        n_k, t_k = n_imp[sl], t_imp[sl]
        rows = bs[torch.cat([struct.ia[sl], struct.ib[sl]])]
        vA, wA, dcA, qA = unpack_body_state(rows[:cap])
        vB, wB, dcB, qB = unpack_body_state(rows[cap:])
        vA2, wA2, vB2, wB2, n2, t2 = ck.solve_contact_core(
            cons_k, vA, wA, vB, wB, qA, qB, dcA, dcB, n_k, t_k, mode, inv_h, use_bias
        )
        pool = torch.cat([pack_body_state(vA2, wA2, dcA, qA), pack_body_state(vB2, wB2, dcB, qB)], dim=-1)  # [cap, W, 16]
        slot_g = struct.slot[:, k]
        got = pool[torch.where(slot_g >= 0, slot_g - k * cap, 0)]                      # [B, W, 16]
        sel = torch.where(struct.is_a[:, k, None, None], got[..., :8], got[..., 8:])
        bs = torch.where((slot_g >= 0)[:, None, None], sel, bs)
        upd = (cons_k.active & struct.winner[sl][:, None])[..., None]
        n_imp[sl] = torch.where(upd, n2, n_k)
        t_imp[sl] = torch.where(upd, t2, t_k)
    return bs, n_imp, t_imp


def _store_impulses_lane(contacts, cons, struct: LaneStructure, n_imp, t_imp):
    """Write the lane impulses back to the per-world tables at the bucket
    slots their points are live in."""
    W, C = contacts.normal_impulse.shape[:2]
    dst = torch.where(struct.bucket >= 0, struct.bucket, C)
    out = torch.zeros((C + 1,) + n_imp.shape[1:-1] + (6,), dtype=n_imp.dtype, device=n_imp.device)
    out[dst] = torch.cat([n_imp, t_imp, cons.pmask.to(n_imp.dtype)], dim=-1)
    out = _t2(out[:C])  # [W, C, 6]
    keep = out[..., 4:6] > 0.5
    return dataclasses.replace(
        contacts,
        normal_impulse=torch.where(keep, out[..., 0:2], contacts.normal_impulse),
        tangent_impulse=torch.where(keep, out[..., 2:4], contacts.tangent_impulse),
    )


def lane_solve(bodies, contacts, struct: LaneStructure, gravity, dt, cfg: SimConfig):
    """Run the lane-batched solver script of cfg.solver on a [W, ...] batch.
    gravity is world 0's; dt a 0-dim float32 tensor. Returns (bodies',
    contacts', mismatch [W]): each world's touching contacts the shared
    structure did not cover (0 on lockstep batches)."""
    if cfg.solver not in SOLVER_SCRIPTS:
        raise ValueError(f"lane_solve runs TGS_SOFT, SOFT_STEP and PGS_SOFT, not {cfg.solver.name}")
    script = SOLVER_SCRIPTS[cfg.solver]
    h, inv_h = step_size(script, dt, cfg.iterations)
    hertz = torch.clamp(script.contact_hertz * inv_h, max=CONTACT_HERTZ)

    lc = bodies.map(_t2)  # per-body constants, [B, W]
    bs = pack_body_state(lc.v, lc.w, lc.delta_pos, lc.rot)  # [B, W, 8]
    # warm-start deltas go to the dynamic endpoints of real bucket entries
    # (the deltas of the others are zeros)
    B = bodies.type.shape[1]
    dyn0 = (bodies.type[0] == 2) & bodies.alive[0]
    ends = torch.cat([struct.ia, struct.ib])
    plan = _scatter_plan(torch.where(dyn0[ends] & (struct.bucket >= 0).repeat(2), ends, B), B)

    covered, lcon = _permute_contacts_lane(contacts, struct)
    touching_total = (contacts.alive & (contacts.point_count > 0)).sum(dim=1).to(I32)
    mismatch = touching_total - covered
    bconst = torch.cat(
        [lc.inv_mass[..., None], lc.inv_inertia[..., None], lc.rot, lc.local_center], dim=-1
    )  # [B, W, 6]
    cons, n_imp, t_imp = prepare_contacts(
        lcon, bconst[struct.ia], bconst[struct.ib], h=h, hertz=hertz, warm_start=cfg.warm_start
    )

    def integrate_v(bs):
        v, w = integrate_velocities(lc, bs[..., 0:2], bs[..., 2], gravity, h)
        return torch.cat([v, w[..., None], bs[..., 3:]], dim=-1)

    def integrate_p(bs):
        dp, rot = integrate_positions(lc.alive, lc.type, bs[..., 3:5], bs[..., 5:7], bs[..., 0:2], bs[..., 2], h)
        return torch.cat([bs[..., 0:3], dp, rot, bs[..., 7:8]], dim=-1)

    def sweep(bs, n, t, use_bias):
        return _lane_gs_sweep(bs, n, t, cons, struct, cfg, script.mode, inv_h, use_bias)

    if script.loop == "substep":
        # substep script (solve_tgs_soft.c:138-280, solve_soft_step.c:182-311)
        for _ in range(cfg.iterations):
            bs = integrate_v(bs)
            if cfg.warm_start:
                bs = _lane_warm_start(bs, cons, n_imp, t_imp, struct, plan, script.fixed_warm)
            bs, n_imp, t_imp = sweep(bs, n_imp, t_imp, True)
            bs = integrate_p(bs)
            if cfg.extra_iterations > 0:
                bs, n_imp, t_imp = sweep(bs, n_imp, t_imp, False)
    else:
        # PGS_Soft script (solve_pgs_soft.c:127-242)
        bs = integrate_v(bs)
        if cfg.warm_start:
            bs = _lane_warm_start(bs, cons, n_imp, t_imp, struct, plan, script.fixed_warm)
        for _ in range(cfg.iterations):
            bs, n_imp, t_imp = sweep(bs, n_imp, t_imp, True)
        bs = integrate_p(bs)
        for _ in range(cfg.extra_iterations):
            bs, n_imp, t_imp = sweep(bs, n_imp, t_imp, False)

    vw = _t2(bs)  # [W, B, 8]
    new_bodies = finalize_positions(bodies, vw[..., 3:5], vw[..., 5:7], vw[..., 0:2], vw[..., 2])
    contacts = _store_impulses_lane(contacts, cons, struct, n_imp, t_imp)
    return new_bodies, contacts, mismatch
