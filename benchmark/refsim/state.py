"""Structure-of-arrays world state as dataclasses of tensors.

Mirrors the port's `state.py` field by field, so that the check can read
the program's state by the same names (`harness/check.to_reference`). A
single world has the JAX package's shapes; a batch of worlds
(`replicate`) has a leading `W` dim on every tensor. Filter bits are int32
tensors holding the uint32 bit patterns (torch has no general uint32
arithmetic).

As in the JAX package, the TGS_Sticky friction-anchor fields of `Contacts`
have the contact table's width under TGS_Sticky and width 0 under every
other solver (`World.freeze` sizes them by solver); code that carries
them tests their width on the contact axis (`sticky_width`).
"""

from __future__ import annotations

import dataclasses

import torch

# int32 fields that hold uint32 bit patterns in the JAX state
_UINT32_FIELDS = frozenset({"filter_category", "filter_mask"})


class _Tree:
    """Mixin: map a function over the tensor fields (recursing into nested
    dataclasses), or over the same fields of several trees together."""

    def map(self, fn, *others):
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            vs = [getattr(o, f.name) for o in others]
            out[f.name] = v.map(fn, *vs) if isinstance(v, _Tree) else fn(v, *vs)
        return type(self)(**out)

@dataclasses.dataclass
class Bodies(_Tree):
    """SoA bodies (reference: src/body.h:16-76). `position` is the center of
    mass, `origin` the body origin; rotations are (sin, cos)."""

    type: torch.Tensor           # i32 [B] BodyType
    origin: torch.Tensor         # f32 [B,2]
    position: torch.Tensor       # f32 [B,2]
    delta_pos: torch.Tensor      # f32 [B,2]
    delta_pos0: torch.Tensor     # f32 [B,2] (XPBD scratch, carried)
    rot: torch.Tensor            # f32 [B,2]
    rot0: torch.Tensor           # f32 [B,2] (XPBD scratch, carried)
    local_center: torch.Tensor   # f32 [B,2]
    v: torch.Tensor              # f32 [B,2]
    w: torch.Tensor              # f32 [B]
    v0: torch.Tensor             # f32 [B,2] (XPBD scratch, carried)
    w0: torch.Tensor             # f32 [B]
    force: torch.Tensor          # f32 [B,2]
    torque: torch.Tensor         # f32 [B]
    mass: torch.Tensor           # f32 [B]
    inv_mass: torch.Tensor       # f32 [B]
    inertia: torch.Tensor        # f32 [B]
    inv_inertia: torch.Tensor    # f32 [B]
    linear_damping: torch.Tensor   # f32 [B]
    angular_damping: torch.Tensor  # f32 [B]
    gravity_scale: torch.Tensor    # f32 [B]
    alive: torch.Tensor          # bool [B]


@dataclasses.dataclass
class Shapes(_Tree):
    """SoA shapes, every shape a rounded convex polygon padded to 8 vertices
    (reference: src/shape.h:23-48). AABBs are (lo.x, lo.y, hi.x, hi.y)."""

    body: torch.Tensor           # i32 [S] owning body (-1 for dead slots)
    source_type: torch.Tensor    # i32 [S] ShapeType
    verts: torch.Tensor          # f32 [S,8,2] body-origin-local
    normals: torch.Tensor        # f32 [S,8,2]
    count: torch.Tensor          # i32 [S]
    radius: torch.Tensor         # f32 [S]
    friction: torch.Tensor       # f32 [S]
    restitution: torch.Tensor    # f32 [S]
    density: torch.Tensor        # f32 [S]
    filter_category: torch.Tensor  # i32 [S] (uint32 bits)
    filter_mask: torch.Tensor      # i32 [S] (uint32 bits)
    filter_group: torch.Tensor     # i32 [S]
    aabb: torch.Tensor           # f32 [S,4]
    fat_aabb: torch.Tensor       # f32 [S,4]
    alive: torch.Tensor          # bool [S]


@dataclasses.dataclass
class Contacts(_Tree):
    """Persistent contact table sorted by pair key (reference:
    src/contact.h:21-61), with the GJK warm-start cache
    (include/solver2d/distance.h:37-45) and the persistent color."""

    key: torch.Tensor            # i32 [C] shapeA * S + shapeB; INT32_MAX when empty
    shape_a: torch.Tensor        # i32 [C]
    shape_b: torch.Tensor        # i32 [C]
    body_a: torch.Tensor         # i32 [C]
    body_b: torch.Tensor         # i32 [C]
    friction: torch.Tensor       # f32 [C]
    restitution: torch.Tensor    # f32 [C]
    normal: torch.Tensor         # f32 [C,2]
    anchor_a: torch.Tensor       # f32 [C,2,2]
    anchor_b: torch.Tensor       # f32 [C,2,2]
    separation: torch.Tensor     # f32 [C,2]
    normal_impulse: torch.Tensor   # f32 [C,2]
    tangent_impulse: torch.Tensor  # f32 [C,2]
    point_id: torch.Tensor       # i32 [C,2]
    persisted: torch.Tensor      # bool [C,2]
    point_count: torch.Tensor    # i32 [C]
    # TGS_Sticky's persistent friction anchors (reference: manifold.h:19-46,
    # solve_tgs_sticky.c:87-135): [C, ...] under TGS_Sticky, [0, ...] else
    friction_normal_a: torch.Tensor  # f32 [C,2,2] per-point local normals
    friction_normal_b: torch.Tensor  # f32 [C,2,2]
    friction_anchor_a: torch.Tensor  # f32 [C,2,2]
    friction_anchor_b: torch.Tensor  # f32 [C,2,2]
    friction_persisted: torch.Tensor  # bool [C]
    cache_count: torch.Tensor    # i32 [C]
    cache_index_a: torch.Tensor  # i32 [C,3]
    cache_index_b: torch.Tensor  # i32 [C,3]
    color: torch.Tensor          # i32 [C] (-1 = unassigned)
    alive: torch.Tensor          # bool [C]


def sticky_width(contacts: Contacts) -> bool:
    """The sticky fields have the contact table's width (TGS_Sticky): read
    on the contact axis, which follows a batch's worlds axis."""
    return contacts.friction_persisted.shape[-1] == contacts.key.shape[-1]


@dataclasses.dataclass
class Joints(_Tree):
    """SoA revolute + mouse joints (reference: src/joint.h:28-102). The lane
    step solves no joints; the broadphase reads them for collide-connected
    suppression."""

    type: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    local_anchor_a: torch.Tensor
    local_anchor_b: torch.Tensor
    collide_connected: torch.Tensor
    reference_angle: torch.Tensor
    lower_angle: torch.Tensor
    upper_angle: torch.Tensor
    enable_limit: torch.Tensor
    enable_motor: torch.Tensor
    motor_speed: torch.Tensor
    max_motor_torque: torch.Tensor
    target: torch.Tensor
    hertz: torch.Tensor
    damping_ratio: torch.Tensor
    impulse: torch.Tensor
    motor_impulse: torch.Tensor
    lower_impulse: torch.Tensor
    upper_impulse: torch.Tensor
    color: torch.Tensor
    alive: torch.Tensor


@dataclasses.dataclass
class Diagnostics(_Tree):
    """Per-step counters (reference: include/solver2d/timer.h:8-17)."""

    contact_count: torch.Tensor    # i32 []
    pair_count: torch.Tensor       # i32 []
    pair_overflow: torch.Tensor    # bool []
    color_overflow: torch.Tensor   # i32 []
    max_penetration: torch.Tensor  # f32 []
    step_id: torch.Tensor          # i32 []


@dataclasses.dataclass
class State(_Tree):
    bodies: Bodies
    shapes: Shapes
    contacts: Contacts
    joints: Joints
    gravity: torch.Tensor  # f32 [2]
    diag: Diagnostics


_SUBTREES = {
    "bodies": Bodies, "shapes": Shapes, "contacts": Contacts,
    "joints": Joints, "diag": Diagnostics,
}


