"""One step of a lockstep world batch, lane-batched.

Port of the lane branch of the JAX package's `step.step_batch`
(reference pipeline: src/world.c:120-306):

1. grid broadphase on world 0, then the persistent contact match whose slot
   layout every world shares (`ops/broadphase.py`);
2. the narrowphase of every (world, contact) through K2
   (`ops/narrow_cuda.py`), then warm-start id matching (`_apply_manifolds`);
3. coloring and color buckets of world 0's contact graph
   (`solvers/lane_solve.build_lane_structure`);
4. the soft contact solve with worlds in lanes (`solvers/lane_solve`);
5. AABB and fat-AABB update and diagnostics (`_post_solve`).

Two behaviours of the JAX lane path are reproduced as they are: the
per-world `mismatch` adds on top of world 0's shared overflow in
`color_overflow`, and world 0's gravity and shape geometry serve every world.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import SPECULATIVE_DISTANCE, SimConfig
from .ops import broadphase
from .ops.geometry import compute_aabbs
from .ops.narrow_cuda import collide
from .solvers.lane_solve import build_lane_structure, lane_solve
from .state import Contacts, Diagnostics, State

I32 = torch.int32


class ManifoldOut(NamedTuple):
    normal: torch.Tensor       # [..., 2]
    anchor_a: torch.Tensor     # [..., 2, 2]
    anchor_b: torch.Tensor
    separation: torch.Tensor   # [..., 2]
    point_id: torch.Tensor     # [..., 2]
    point_count: torch.Tensor
    cache_count: torch.Tensor
    cache_ia: torch.Tensor     # [..., 3]
    cache_ib: torch.Tensor


def _apply_manifolds(contacts: Contacts, out: ManifoldOut) -> Contacts:
    """Warm-start id matching and the manifold table update (reference:
    src/contact.c:328-358): a new point whose feature id equals a live old
    point's takes that point's impulses."""
    alive = contacts.alive
    pts = torch.arange(2, device=alive.device)
    new_count = torch.where(alive, out.point_count, 0)
    old_pmask = pts < contacts.point_count[..., None]
    new_pmask = pts < new_count[..., None]
    eq = (
        (out.point_id[..., :, None] == contacts.point_id[..., None, :])
        & old_pmask[..., None, :] & new_pmask[..., :, None]
    )
    matched = eq.any(-1)
    second = ~eq[..., 0] & eq[..., 1]  # first matching old point is point 1

    def take(old):
        return torch.where(second, old[..., 1:2], old[..., 0:1])

    a1, a2 = alive[..., None], alive[..., None, None]
    return dataclasses.replace(
        contacts,
        normal=torch.where(a1, out.normal, contacts.normal),
        anchor_a=torch.where(a2, out.anchor_a, contacts.anchor_a),
        anchor_b=torch.where(a2, out.anchor_b, contacts.anchor_b),
        separation=torch.where(a1, out.separation, contacts.separation),
        normal_impulse=torch.where(matched, take(contacts.normal_impulse), 0.0),
        tangent_impulse=torch.where(matched, take(contacts.tangent_impulse), 0.0),
        point_id=torch.where(a1, out.point_id, contacts.point_id),
        persisted=matched,
        point_count=new_count.to(I32),
        cache_count=torch.where(alive, out.cache_count, contacts.cache_count),
        cache_index_a=torch.where(a1, out.cache_ia, contacts.cache_index_a),
        cache_index_b=torch.where(a1, out.cache_ib, contacts.cache_index_b),
    )


def narrow_inputs(batch: State, contacts: Contacts):
    """K2's inputs for a lockstep batch: world 0's shape table [S, 34]
    (vx, vy, nx, ny rows, count, radius), the shared shape indices, and
    each world's endpoint poses [W, 4, C] and GJK caches [W, 7, C]."""
    s0 = batch.shapes.map(lambda x: x[0])
    geom = torch.cat(
        [
            s0.verts[..., 0], s0.verts[..., 1], s0.normals[..., 0], s0.normals[..., 1],
            s0.count[:, None].to(torch.float32), s0.radius[:, None],
        ],
        dim=-1,
    ).contiguous()
    pose = torch.cat([batch.bodies.origin, batch.bodies.rot], dim=-1)  # [W, B, 4]
    pa = pose[:, contacts.body_a[0]].transpose(1, 2).contiguous()
    pb = pose[:, contacts.body_b[0]].transpose(1, 2).contiguous()
    cache = torch.cat(
        [contacts.cache_count[:, None], contacts.cache_index_a.transpose(1, 2),
         contacts.cache_index_b.transpose(1, 2)],
        dim=1,
    ).contiguous()
    return geom, contacts.shape_a[0].contiguous(), contacts.shape_b[0].contiguous(), pa, pb, cache


def update_manifolds_lane(batch: State, contacts: Contacts, config: SimConfig) -> Contacts:
    """The narrowphase of a lockstep batch through K2, then id matching."""
    fout, iout, cout = collide(*narrow_inputs(batch, contacts), config.gjk_iters)
    f = fout.transpose(1, 2)  # [W, C, 12]
    i = iout.transpose(1, 2)
    c = cout.transpose(1, 2)
    out = ManifoldOut(
        normal=f[..., 0:2],
        anchor_a=f[..., 2:6].reshape(f.shape[:2] + (2, 2)),
        anchor_b=f[..., 6:10].reshape(f.shape[:2] + (2, 2)),
        separation=f[..., 10:12],
        point_id=i[..., 0:2],
        point_count=i[..., 2],
        cache_count=c[..., 0],
        cache_ia=c[..., 1:4],
        cache_ib=c[..., 4:7],
    )
    return _apply_manifolds(contacts, out)


def _post_solve(batch: State, new_bodies, contacts, pairs0, diverged, sbt0, touching,
                c_overflow) -> State:
    """AABB + fat-AABB hysteresis update, diagnostics, the new State."""
    shapes = batch.shapes
    W, B = new_bodies.type.shape
    new_pose = torch.cat([new_bodies.origin, new_bodies.rot], dim=-1)
    worlds = torch.arange(W, device=new_pose.device)[:, None]
    shape_pose = new_pose[worlds, broadphase.wrap_index(shapes.body, B)]
    aabbs = compute_aabbs(shapes.verts, shapes.radius, shape_pose[..., 0:2], shape_pose[..., 2:4])
    aabbs = aabbs + torch.tensor([-1.0, -1.0, 1.0, 1.0], device=aabbs.device) * SPECULATIVE_DISTANCE
    fat = broadphase.update_fat_aabbs(shapes.fat_aabb, aabbs, sbt0)

    pts = torch.arange(2, device=touching.device)
    pen = torch.where(
        touching[..., None] & (pts < contacts.point_count[..., None]), -contacts.separation, 0.0
    )
    diag = Diagnostics(
        contact_count=touching.sum(dim=1).to(I32),
        pair_count=pairs0.count.expand(W).to(I32),
        pair_overflow=pairs0.overflow | diverged,
        color_overflow=c_overflow.to(I32),
        max_penetration=pen.flatten(1).amax(dim=1),
        step_id=batch.diag.step_id + 1,
    )
    return State(
        bodies=new_bodies,
        shapes=dataclasses.replace(shapes, aabb=aabbs, fat_aabb=fat),
        contacts=contacts,
        joints=batch.joints,
        gravity=batch.gravity,
        diag=diag,
    )


def step_batch(batch: State, dt: float, config: SimConfig) -> State:
    """One step of a lockstep [W, ...] batch: pairing, coloring and the
    solve structure come from world 0 and are shared; worlds whose fat AABBs
    differ from world 0's get `diag.pair_overflow` raised. Runs on the
    batch's device."""
    W = batch.bodies.type.shape[0]
    bodies0 = batch.bodies.map(lambda x: x[0])
    shapes0 = batch.shapes.map(lambda x: x[0])
    joints0 = batch.joints.map(lambda x: x[0])
    S = shapes0.body.shape[0]
    B = bodies0.type.shape[0]
    sbt0 = torch.where(
        shapes0.alive, bodies0.type[broadphase.wrap_index(shapes0.body, B)], 0
    )
    pairs0 = broadphase.find_pairs_grid(
        shapes0, bodies0.type, broadphase.jointed_body_keys(joints0, config), config
    )
    diverged = (batch.shapes.fat_aabb != batch.shapes.fat_aabb[0:1]).reshape(W, S * 4).any(dim=1)

    contacts = broadphase.match_contacts_lane(batch.contacts, pairs0, shapes0)
    contacts = update_manifolds_lane(batch, contacts, config)

    dyn0 = (bodies0.type == 2) & bodies0.alive
    struct = build_lane_structure(contacts, dyn0, config)
    contacts = dataclasses.replace(contacts, color=struct.ccolor[None].expand(W, -1).contiguous())

    dt_t = torch.tensor(float(dt), dtype=torch.float32, device=batch.gravity.device)
    new_bodies, contacts, mismatch = lane_solve(
        batch.bodies, contacts, struct, batch.gravity[0], dt_t, config
    )
    touching = contacts.alive & (contacts.point_count > 0)
    return _post_solve(
        batch, new_bodies, contacts, pairs0, diverged, sbt0[None].expand(W, -1), touching,
        struct.shared_overflow + mismatch,
    )
