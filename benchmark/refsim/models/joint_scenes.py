"""The reference's Bridge (samples/collection/sample_joints.cpp), as the
port's `models/joint_scenes.py` builds it. `bridge` returns the world and
its planks; the registered Bridge scene wraps it."""

from __future__ import annotations

from ..config import BodyType, SolverType
from ..ops import geometry
from ..world import World
from . import Scene, register_scene


def bridge(solver: SolverType, count: int = 160) -> tuple[World, list[int]]:
    """reference: sample_joints.cpp:14-90: `count` planks pinned to each
    other and, at both ends, to the (shapeless) static ground, body 0.
    Returns the world and the plank bodies."""
    w = World(solver=solver)
    ground = w.create_body(type=BodyType.STATIC)
    xbase = -80.0
    prev = ground
    ids = []
    for i in range(count):
        b = w.create_body(
            type=BodyType.DYNAMIC, position=(xbase + 0.5 + 1.0 * i, 20.0),
            linear_damping=0.1, angular_damping=0.1,
        )
        w.create_polygon_shape(b, geometry.box(0.5, 0.125), density=20.0)
        pivot = (xbase + 1.0 * i, 20.0)
        w.create_revolute_joint(
            prev, b,
            local_anchor_a=w.get_local_point(prev, pivot),
            local_anchor_b=w.get_local_point(b, pivot),
        )
        prev = b
        ids.append(b)
    pivot = (xbase + 1.0 * count, 20.0)
    w.create_revolute_joint(
        prev, ground,
        local_anchor_a=w.get_local_point(prev, pivot),
        local_anchor_b=w.get_local_point(ground, pivot),
    )
    return w, ids


@register_scene("Joints", "Bridge")
def bridge_scene(solver: SolverType, count: int = 160) -> Scene:
    """reference: sample_joints.cpp:14-90: 160 planks pinned at both ends."""
    w, ids = bridge(solver, count)
    return Scene(w, meta=dict(planks=ids))
