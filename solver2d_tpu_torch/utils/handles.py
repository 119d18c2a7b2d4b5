"""Slot reuse and ABA-safe handles for the fixed-capacity state.

An own copy of the JAX package's `utils/handles.py`. The reference's pools
hand out `{index, revision}` ids and bump the revision on free, so that a
stale id never addresses a reused slot (reference:
include/solver2d/id.h:12-45, src/pool.h:38-47). The state is fixed-capacity
tensors with alive masks, so allocation is decided on the host:

- `HandlePool` tracks free slots (lowest index first, like s2AllocObject)
  and per-slot revision counters for one entity class, in numpy;
- `WorldHandles.for_state` builds the pools of a frozen state's bodies,
  shapes and joints (for a [W, ...] batch: a slot is used if it is used in
  any world, and every edit writes the same slot in every world);
- `create_body` / `destroy_body` (and the shape and joint analogs)
  allocate and release slots, check revisions, and return or consume
  typed ids; a stale id raises `StaleHandleError` instead of changing
  another entity's slot.

The pools only decide indices; the state changes through tensor writes and
the `utils.runtime` functions, on the state's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..state import State
from . import runtime


def _put_slot(idx, batched, arr, val):
    """arr with slot idx set to val (in every world of a batch)."""
    return runtime._put(arr, idx, val, batched)


class BodyId(NamedTuple):
    index: int
    revision: int


class ShapeId(NamedTuple):
    index: int
    revision: int


class JointId(NamedTuple):
    index: int
    revision: int


class StaleHandleError(RuntimeError):
    """An id's revision does not match its slot's (the slot was freed, and
    maybe reused, since the id was issued)."""


class PoolExhaustedError(RuntimeError):
    pass


class HandlePool:
    """Free list and revision counters of one entity class (reference:
    src/pool.c s2AllocObject/s2FreeObject)."""

    def __init__(self, capacity: int, used):
        self.capacity = capacity
        self.revision = np.zeros(capacity, np.int64)
        used = set(int(u) for u in used)
        # lowest index first, like the reference's free list after creation
        self._free = sorted(set(range(capacity)) - used, reverse=True)

    def alloc(self) -> tuple[int, int]:
        if not self._free:
            raise PoolExhaustedError(
                f"no free slots (capacity {self.capacity}); grow the SimConfig capacity"
            )
        idx = self._free.pop()
        return idx, int(self.revision[idx])

    def free(self, index: int, revision: int):
        self.check(index, revision)
        self.revision[index] += 1  # invalidates every outstanding id
        self._free.append(index)
        self._free.sort(reverse=True)

    def check(self, index: int, revision: int):
        if not (0 <= index < self.capacity) or int(self.revision[index]) != revision:
            raise StaleHandleError(
                f"stale handle: slot {index} revision {revision} != {int(self.revision[index])}"
            )

    def is_valid(self, index: int, revision: int) -> bool:
        return 0 <= index < self.capacity and int(self.revision[index]) == revision


def _used(alive: torch.Tensor) -> np.ndarray:
    """Slots alive in any world."""
    a = alive.detach().cpu().numpy()
    return np.nonzero(a.reshape(-1, a.shape[-1]).any(axis=0))[0]


@dataclasses.dataclass
class WorldHandles:
    """Handle pools of one world's (or a batch's) body, shape and joint
    tables."""

    bodies: HandlePool
    shapes: HandlePool
    joints: HandlePool

    @classmethod
    def for_state(cls, state: State) -> "WorldHandles":
        return cls(
            bodies=HandlePool(state.bodies.alive.shape[-1], _used(state.bodies.alive)),
            shapes=HandlePool(state.shapes.alive.shape[-1], _used(state.shapes.alive)),
            joints=HandlePool(state.joints.alive.shape[-1], _used(state.joints.alive)),
        )

    # --- bodies ---

    def create_body(self, state: State, position=(0.0, 0.0), angle: float = 0.0,
                    body_type: int = 2, mass: float = 1.0, inertia: float = 1.0,
                    velocity=(0.0, 0.0), angular_velocity: float = 0.0) -> tuple[State, BodyId]:
        """Reuse a free body slot (reference: src/body.c:17-63). The new body
        has no shapes; attach them with create_circle_shape or
        create_box_shape. Its rotation is `math2d.make_rot(angle)`
        (see `runtime.set_transform`)."""
        from ..ops import math2d as m

        idx, rev = self.bodies.alloc()
        b = state.bodies
        dev = b.origin.device
        upd = functools.partial(_put_slot, idx, b.type.dim() == 2)
        pos = torch.as_tensor(position, dtype=torch.float32, device=dev)
        rot = m.make_rot(angle, device=dev)
        bodies = dataclasses.replace(
            b,
            type=upd(b.type, body_type),
            origin=upd(b.origin, pos),
            position=upd(b.position, pos),
            delta_pos=upd(b.delta_pos, 0.0),
            rot=upd(b.rot, rot),
            rot0=upd(b.rot0, rot),
            local_center=upd(b.local_center, 0.0),
            v=upd(b.v, torch.as_tensor(velocity, dtype=torch.float32, device=dev)),
            w=upd(b.w, angular_velocity),
            force=upd(b.force, 0.0),
            torque=upd(b.torque, 0.0),
            mass=upd(b.mass, mass),
            inv_mass=upd(b.inv_mass, 1.0 / mass if (mass > 0 and body_type == 2) else 0.0),
            inertia=upd(b.inertia, inertia),
            inv_inertia=upd(b.inv_inertia, 1.0 / inertia if (inertia > 0 and body_type == 2) else 0.0),
            gravity_scale=upd(b.gravity_scale, 1.0),
            linear_damping=upd(b.linear_damping, 0.0),
            angular_damping=upd(b.angular_damping, 0.0),
            alive=upd(b.alive, True),
        )
        return dataclasses.replace(state, bodies=bodies), BodyId(idx, rev)

    def destroy_body(self, state: State, bid: BodyId) -> State:
        """Checked destroy: frees the slot and invalidates the id. The
        body's shapes and joints are disabled; their slots are freed only if
        they were created through these handles too (scene-built shapes keep
        their indices for rebuilds)."""
        self.bodies.free(bid.index, bid.revision)
        return runtime.destroy_body(state, bid.index)

    # --- shapes ---

    def create_circle_shape(self, state: State, bid: BodyId, center, radius: float,
                            friction: float = 0.6, restitution: float = 0.0) -> tuple[State, ShapeId]:
        from ..ops import geometry

        self.bodies.check(bid.index, bid.revision)
        return self._create_shape(state, bid.index, geometry.circle(center, radius), friction, restitution)

    def create_box_shape(self, state: State, bid: BodyId, hx: float, hy: float,
                         friction: float = 0.6, restitution: float = 0.0) -> tuple[State, ShapeId]:
        from ..ops import geometry

        self.bodies.check(bid.index, bid.revision)
        return self._create_shape(state, bid.index, geometry.box(hx, hy), friction, restitution)

    def _create_shape(self, state: State, body_idx: int, geom, friction, restitution) -> tuple[State, ShapeId]:
        idx, rev = self.shapes.alloc()
        s = state.shapes
        batched = s.body.dim() == 2
        dev = s.verts.device
        upd = functools.partial(_put_slot, idx, batched)
        # a conservative first fat AABB; the step after recomputes it from
        # the body pose
        origin = state.bodies.origin[:, body_idx] if batched else state.bodies.origin[body_idx]
        ext = float(np.abs(np.asarray(geom.verts)).max() + geom.radius + 0.2)
        box = torch.cat([origin - ext, origin + ext], dim=-1)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        shapes = dataclasses.replace(
            s,
            body=upd(s.body, body_idx),
            source_type=upd(s.source_type, int(geom.source_type)),
            verts=upd(s.verts, f32(geom.verts)),
            normals=upd(s.normals, f32(geom.normals)),
            count=upd(s.count, int(geom.count)),
            radius=upd(s.radius, float(geom.radius)),
            friction=upd(s.friction, friction),
            restitution=upd(s.restitution, restitution),
            density=upd(s.density, 1.0),
            filter_category=upd(s.filter_category, 1),
            filter_mask=upd(s.filter_mask, -1),  # the uint32 bits 0xFFFFFFFF
            filter_group=upd(s.filter_group, 0),
            aabb=upd(s.aabb, box),
            fat_aabb=upd(s.fat_aabb, box),
            alive=upd(s.alive, True),
        )
        return dataclasses.replace(state, shapes=shapes), ShapeId(idx, rev)

    def destroy_shape(self, state: State, sid: ShapeId) -> State:
        self.shapes.free(sid.index, sid.revision)
        return runtime.destroy_shape(state, sid.index)

    # --- joints ---

    def destroy_joint(self, state: State, jid: JointId) -> State:
        self.joints.free(jid.index, jid.revision)
        return runtime.destroy_joint(state, jid.index)

    def alloc_joint_slot(self) -> JointId:
        """Reserve a joint slot (for example for queries.attach_mouse_joint)."""
        idx, rev = self.joints.alloc()
        return JointId(idx, rev)
