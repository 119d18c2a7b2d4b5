"""World queries and runtime interaction.

An own copy of the JAX package's `queries.py`, the query surface of the
public C API (reference: include/solver2d/solver2d.h):
- AABB query over live shapes        (s2World_QueryAABB, src/world.c:605-615)
- point test                          (s2Shape_TestPoint, src/shape.c:110-137)
- world raycast                       (per-shape raycasts, src/geometry.c)
- mouse picking: query + mouse joint  (samples/sample.cpp:69-123)

Queries are masked scans over the fixed-capacity shape table of one world:
the state itself when it has the JAX package's shapes, or world `world` of
a [W, ...] batch. Mouse attach, move and detach are functional state edits
of one world or of a batch, the same joint slot in every world (a body and
a target may differ by world). Everything runs on the state's device.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops import math2d as m
from .ops.broadphase import wrap_index
from .ops.raycast import RayHit, point_in_shape, raycast_shape
from .state import State
from .utils.runtime import _batched, _put, _vals


def _world(state: State, world: int):
    """(shapes, bodies) of one world."""
    if state.bodies.type.dim() == 1:
        return state.shapes, state.bodies
    return state.shapes.map(lambda x: x[world]), state.bodies.map(lambda x: x[world])


def query_aabb(state: State, lo, hi, world: int = 0) -> torch.Tensor:
    """Boolean mask [S] of the live shapes whose fat AABB overlaps [lo, hi]."""
    shapes, _ = _world(state, world)
    fat = shapes.fat_aabb
    lo, hi = _vals(lo, fat), _vals(hi, fat)
    overlap = (
        (fat[:, 0] <= hi[0]) & (lo[0] <= fat[:, 2])
        & (fat[:, 1] <= hi[1]) & (lo[1] <= fat[:, 3])
    )
    return overlap & shapes.alive


def test_point(state: State, point, world: int = 0) -> torch.Tensor:
    """Boolean mask [S]: the live shapes that contain the world point."""
    shapes, bodies = _world(state, world)
    point = _vals(point, shapes.verts)
    b = wrap_index(shapes.body, bodies.type.shape[0]).long()
    local = m.inv_transform_point(bodies.origin[b], bodies.rot[b], point)
    return point_in_shape(local, shapes.verts, shapes.count, shapes.radius) & shapes.alive


def _ray_aabb_enter(fat, p1, p2):
    """Slab test of the segment p1->p2 against fat AABBs [S, 4]: (hit mask,
    clamped entry fraction), the culling the reference's tree raycast does
    at each node (reference: src/dynamic_tree.c:1213-1315, src/aabb.c:19)."""
    d = p2 - p1
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t1 = (fat[:, 0:2] - p1) * inv
    t2 = (fat[:, 2:4] - p1) * inv
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    enter = torch.clamp(tmin, min=0.0)
    return (tmax >= enter) & (tmin <= 1.0), enter


def raycast_world(state: State, p1, p2, max_candidates: int = 64, world: int = 0) -> RayHit:
    """The nearest hit along the segment p1->p2.

    A world of at most `max_candidates` shape slots is scanned whole.
    Above that, the fat AABBs cull first and the shape casts run on the
    `max_candidates` candidates that the ray enters first, the vectorized
    analog of the reference's AABB-tree raycast (src/dynamic_tree.c:
    1213-1315). Candidates with equal entry fractions keep index order (a
    stable sort), the order of the JAX package's `top_k`."""
    shapes, bodies = _world(state, world)
    p1, p2 = _vals(p1, shapes.verts), _vals(p2, shapes.verts)
    S = shapes.verts.shape[0]

    if S <= max_candidates:
        cand = torch.arange(S, device=p1.device)
        cand_ok = shapes.alive
    else:
        ab_hit, t_enter = _ray_aabb_enter(shapes.fat_aabb, p1, p2)
        key = torch.where(ab_hit & shapes.alive, t_enter, float("inf"))
        cand = torch.sort(key, stable=True).indices[:max_candidates]
        cand_ok = key[cand] != float("inf")

    b = wrap_index(shapes.body[cand], bodies.type.shape[0]).long()
    l1 = m.inv_transform_point(bodies.origin[b], bodies.rot[b], p1)
    l2 = m.inv_transform_point(bodies.origin[b], bodies.rot[b], p2)
    ok, frac, pt, n = raycast_shape(l1, l2, 1.0, shapes.verts[cand], shapes.count[cand], shapes.radius[cand])
    ok = ok & cand_ok
    frac = torch.where(ok, frac, float("inf"))
    best = torch.argmin(frac)
    hit = ok.any()
    q = bodies.rot[b[best]]
    p0 = bodies.origin[b[best]]
    return RayHit(
        hit=hit,
        fraction=torch.where(hit, frac[best], 1.0),
        point=torch.where(hit, m.transform_point(p0, q, pt[best]), 0.0),
        normal=torch.where(hit, m.rotate(q, n[best]), 0.0),
        shape=torch.where(hit, cand[best].to(torch.int32), -1),
    )


# --- mouse picking (reference: samples/sample.cpp:69-123) ---

def pick_body(state: State, point, world: int = 0):
    """(found, body index): the dynamic body of the first live shape (in
    slot order) that contains the point; body -1 if none."""
    shapes, bodies = _world(state, world)
    inside = test_point(state, point, world)
    b = shapes.body
    dyn = bodies.type[wrap_index(b, bodies.type.shape[0]).long()] == 2
    cand = inside & dyn
    idx = torch.argmax(cand.to(torch.int32))
    found = cand.any()
    return found, torch.where(found, b[idx], -1)


def _rows(x, idx, batched):
    """x's rows at the body idx (an int, or one a world [W])."""
    if not batched:
        return x[idx]
    if isinstance(idx, torch.Tensor) and idx.dim() == 1:
        return x[torch.arange(x.shape[0], device=x.device), idx.long()]
    return x[:, idx]


def attach_mouse_joint(state: State, slot: int, body, target, hertz: float = 7.5, damping_ratio: float = 0.7,
                       ground_body: int = 0) -> State:
    """Enable joint `slot` as a mouse joint that drags `body` toward
    `target` (on a batch: `body` an int or one a world, `target` [2] or
    [W, 2]).

    The testbed uses hertz = 0.5 * frequency with damping 0.7 on a dummy
    ground body (sample.cpp:90-100); body A may be of any type: the solve
    reads its velocity and never moves it."""
    j, bds = state.joints, state.bodies
    bt = _batched(state)
    target = _vals(target, bds.origin)
    if isinstance(body, torch.Tensor):
        body = body.to(torch.int32)
    local_b = m.inv_transform_point(_rows(bds.origin, body, bt), _rows(bds.rot, body, bt), target)
    joints = dataclasses.replace(
        j,
        type=_put(j.type, slot, 1, bt),
        body_a=_put(j.body_a, slot, ground_body, bt),
        body_b=_put(j.body_b, slot, body, bt),
        local_anchor_a=_put(j.local_anchor_a, slot, 0.0, bt),
        local_anchor_b=_put(j.local_anchor_b, slot, local_b, bt),
        collide_connected=_put(j.collide_connected, slot, True, bt),
        target=_put(j.target, slot, target, bt),
        hertz=_put(j.hertz, slot, hertz, bt),
        damping_ratio=_put(j.damping_ratio, slot, damping_ratio, bt),
        impulse=_put(j.impulse, slot, 0.0, bt),
        motor_impulse=_put(j.motor_impulse, slot, 0.0, bt),
        color=_put(j.color, slot, -1, bt),
        alive=_put(j.alive, slot, True, bt),
    )
    return dataclasses.replace(state, joints=joints)


def move_mouse_target(state: State, slot: int, target) -> State:
    """s2MouseJoint_SetTarget (reference: src/mouse_joint.c:18-29)."""
    j = state.joints
    target = _put(j.target, slot, _vals(target, j.target), _batched(state))
    return dataclasses.replace(state, joints=dataclasses.replace(j, target=target))


def detach_mouse_joint(state: State, slot: int) -> State:
    j = state.joints
    alive = _put(j.alive, slot, False, _batched(state))
    return dataclasses.replace(state, joints=dataclasses.replace(j, alive=alive))
