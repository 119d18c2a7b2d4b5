"""Runtime changes to a frozen state: the fixed-capacity analog of the
reference's pool alloc and free (reference: src/pool.c, src/body.c:65-150
destroy, :316-384 setters and force and impulse application). Bodies,
shapes and joints are enabled and disabled by flipping alive masks;
teleporting re-initializes the kinematic fields.

An own copy of the JAX package's `utils/runtime.py`. Each function takes a
single world (the JAX shapes) or a [W, ...] batch, where it edits the same
slots in every world; a value broadcasts over the worlds, so a value of
shape [W, ...] gives each world its own. The new state is returned; the
old one is not changed.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import math2d as m
from ..ops.broadphase import wrap_index
from ..state import State

F32 = torch.float32


def _batched(state: State) -> bool:
    return state.bodies.type.dim() == 2


def _index(idx, like):
    """An int stays an int; a list or array of slots becomes a tensor."""
    if isinstance(idx, int):
        return idx
    return torch.as_tensor(idx, device=like.device).long()


def _at(x, idx, batched):
    return x[:, idx] if batched else x[idx]


def _put(x, idx, val, batched):
    out = x.clone()
    if batched:
        out[:, idx] = val
    else:
        out[idx] = val
    return out


def _vals(v, like):
    return torch.as_tensor(v, dtype=F32, device=like.device)


def _per_slot(mask, idx):
    """mask[idx] along the last dim, with JAX's wrap of a -1 index."""
    return torch.gather(mask, -1, wrap_index(idx, mask.shape[-1]).long())


def destroy_body(state: State, body_idx: int) -> State:
    """Disable a body, its shapes, its joints and its contacts."""
    alive = state.bodies.alive.clone()
    alive[..., body_idx] = False
    shapes, joints, contacts = state.shapes, state.joints, state.contacts
    joint_dead = (joints.body_a == body_idx) | (joints.body_b == body_idx)
    contact_dead = (contacts.body_a == body_idx) | (contacts.body_b == body_idx)
    return dataclasses.replace(
        state,
        bodies=dataclasses.replace(state.bodies, alive=alive),
        shapes=dataclasses.replace(shapes, alive=shapes.alive & (shapes.body != body_idx)),
        joints=dataclasses.replace(joints, alive=joints.alive & ~joint_dead),
        contacts=dataclasses.replace(contacts, alive=contacts.alive & ~contact_dead),
    )


def set_bodies_alive(state: State, body_idxs, alive: bool) -> State:
    """Enable or disable bodies with their shapes and joints (spawn and
    despawn); disabling also drops their contacts."""
    b = state.bodies
    bt = _batched(state)
    mask = _put(torch.zeros_like(b.alive), _index(body_idxs, b.alive), True, bt)
    bodies = dataclasses.replace(b, alive=torch.where(mask, alive, b.alive))
    s, j, c = state.shapes, state.joints, state.contacts
    shapes = dataclasses.replace(s, alive=torch.where(_per_slot(mask, s.body), alive, s.alive))
    jmask = _per_slot(mask, j.body_a) | _per_slot(mask, j.body_b)
    joints = dataclasses.replace(j, alive=torch.where(jmask, alive, j.alive))
    contacts = c
    if not alive:
        cmask = _per_slot(mask, c.body_a) | _per_slot(mask, c.body_b)
        contacts = dataclasses.replace(c, alive=c.alive & ~cmask)
    return dataclasses.replace(state, bodies=bodies, shapes=shapes, joints=joints, contacts=contacts)


def teleport_bodies(state: State, body_idxs, positions, reset_velocity=True) -> State:
    """Move bodies (keeping their orientation), zeroing their velocities
    and position deltas unless asked not to."""
    b = state.bodies
    bt = _batched(state)
    idx = _index(body_idxs, b.origin)
    positions = _vals(positions, b.origin)
    offset = positions - _at(b.origin, idx, bt)
    kw = dict(
        origin=_put(b.origin, idx, positions, bt),
        position=_put(b.position, idx, _at(b.position, idx, bt) + offset, bt),
    )
    if reset_velocity:
        kw.update(v=_put(b.v, idx, 0.0, bt), w=_put(b.w, idx, 0.0, bt), delta_pos=_put(b.delta_pos, idx, 0.0, bt))
    return dataclasses.replace(state, bodies=dataclasses.replace(b, **kw))


# --- body manipulation (reference: src/body.c:316-384, solver2d.h:38-42) ---

def set_linear_velocity(state: State, body_idx, v) -> State:
    b = state.bodies
    return dataclasses.replace(state, bodies=dataclasses.replace(
        b, v=_put(b.v, _index(body_idx, b.v), _vals(v, b.v), _batched(state))))


def set_angular_velocity(state: State, body_idx, w) -> State:
    b = state.bodies
    return dataclasses.replace(state, bodies=dataclasses.replace(
        b, w=_put(b.w, _index(body_idx, b.w), _vals(w, b.w), _batched(state))))


def apply_force_to_center(state: State, body_idx, force) -> State:
    """Accumulates into the step's force, cleared when the step ends
    (reference: s2Body_ApplyForceToCenter)."""
    b = state.bodies
    bt = _batched(state)
    idx = _index(body_idx, b.force)
    force = _at(b.force, idx, bt) + _vals(force, b.force)
    return dataclasses.replace(state, bodies=dataclasses.replace(b, force=_put(b.force, idx, force, bt)))


def apply_linear_impulse(state: State, body_idx, impulse, point) -> State:
    """v += impulse / m; w += cross(point - com, impulse) / I
    (reference: s2Body_ApplyLinearImpulse)."""
    b = state.bodies
    bt = _batched(state)
    idx = _index(body_idx, b.v)
    impulse = _vals(impulse, b.v)
    r = _vals(point, b.v) - _at(b.position, idx, bt)
    v = _at(b.v, idx, bt) + _at(b.inv_mass, idx, bt)[..., None] * impulse
    w = _at(b.w, idx, bt) + _at(b.inv_inertia, idx, bt) * (r[..., 0] * impulse[..., 1] - r[..., 1] * impulse[..., 0])
    return dataclasses.replace(state, bodies=dataclasses.replace(b, v=_put(b.v, idx, v, bt), w=_put(b.w, idx, w, bt)))


def set_transform(state: State, body_idx, position, angle) -> State:
    """s2Body_SetTransform: move the body origin and orientation; the
    center of mass follows. The rotation is `math2d.make_rot(angle)`,
    correctly rounded, which differs from the JAX package's by at most 1
    ulp."""
    b = state.bodies
    bt = _batched(state)
    idx = _index(body_idx, b.origin)
    position = _vals(position, b.origin)
    rot = m.make_rot(angle, device=b.rot.device)
    com = position + m.rotate(rot, _at(b.local_center, idx, bt))
    return dataclasses.replace(state, bodies=dataclasses.replace(
        b,
        origin=_put(b.origin, idx, position, bt),
        position=_put(b.position, idx, com, bt),
        rot=_put(b.rot, idx, rot, bt),
        rot0=_put(b.rot0, idx, rot, bt),
    ))


def destroy_joint(state: State, joint_idx: int) -> State:
    """Disable a joint (s2DestroyJoint)."""
    j = state.joints
    return dataclasses.replace(state, joints=dataclasses.replace(
        j, alive=_put(j.alive, joint_idx, False, _batched(state))))


def destroy_shape(state: State, shape_idx: int) -> State:
    """Disable a shape and its contacts. The body keeps its other shapes and
    its mass properties, as in the JAX package (a host-side rebuild can
    recompute them exactly)."""
    s, c = state.shapes, state.contacts
    shapes = dataclasses.replace(s, alive=_put(s.alive, shape_idx, False, _batched(state)))
    dead = (c.shape_a == shape_idx) | (c.shape_b == shape_idx)
    return dataclasses.replace(state, shapes=shapes, contacts=dataclasses.replace(c, alive=c.alive & ~dead))
