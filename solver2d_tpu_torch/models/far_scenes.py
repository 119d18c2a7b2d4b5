"""Far-from-origin float32 stress scenes (reference: samples/collection/sample_far.cpp).

An own copy of the JAX package's `models/far_scenes.py`. These exercise the
local-frame narrowphase (B transformed into A's frame) and
delta-position solvers at origins up to (100000, -80000) in float32."""

from __future__ import annotations

from ..config import PI, BodyType, SolverType
from ..ops import geometry
from ..world import World
from . import Scene, register_scene
from .human import spawn_human


@register_scene("Far", "Pyramid")
def far_pyramid(solver: SolverType, base_count: int = 10, origin=(100000.0, -80000.0)) -> Scene:
    """reference: sample_far.cpp:16-83"""
    ox, oy = origin
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(ox, oy - 1.0))
    w.create_polygon_shape(g, geometry.box(100.0, 1.0))
    h = 0.5
    shift = 1.25 * h
    ids = []
    for i in range(base_count):
        y = (2.0 * i + 1.0) * shift + 0.5
        for j in range(i, base_count):
            x = (i + 1.0) * shift + 2.0 * (j - i) * shift - h * base_count
            b = w.create_body(type=BodyType.DYNAMIC, position=(x + ox, y + oy))
            w.create_polygon_shape(b, geometry.square(h))
            ids.append(b)
    return Scene(w, meta=dict(boxes=ids, origin=origin))


@register_scene("Far", "Stack")
def far_stack(solver: SolverType, origin=(40000.0, -25000.0)) -> Scene:
    """reference: sample_far.cpp:85-159"""
    ox, oy = origin
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(ox, oy - 1.0))
    w.create_polygon_shape(g, geometry.box(10.0, 1.0))
    b = w.create_body(type=BodyType.DYNAMIC, position=(ox + 1.875, oy + 0.125))
    w.create_circle_shape(b, (0.0, 0.0), 0.1)
    b = w.create_body(type=BodyType.DYNAMIC, position=(ox - 1.875, oy + 0.15))
    w.create_polygon_shape(b, geometry.box(0.1, 0.125))
    b = w.create_body(type=BodyType.DYNAMIC, position=(ox + 0.0, oy + 0.325))
    w.create_polygon_shape(b, geometry.box(2.0, 0.05))
    b = w.create_body(type=BodyType.DYNAMIC, position=(ox - 0.5, oy + 0.9))
    w.create_polygon_shape(b, geometry.square(0.25))
    b = w.create_body(type=BodyType.DYNAMIC, position=(ox - 0.55, oy + 1.7))
    w.create_polygon_shape(b, geometry.square(0.5))
    return Scene(w, meta=dict(origin=origin))


@register_scene("Far", "Recovery")
def far_recovery(solver: SolverType, origin=(80000.0, -70000.0)) -> Scene:
    """reference: sample_far.cpp:161-217"""
    from .contact_scenes import _overlap_pyramid

    ox, oy = origin
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(ox, oy))
    w.create_segment_shape(g, (-40.0, 0.0), (40.0, 0.0))
    ids = _overlap_pyramid(w, origin=origin)
    return Scene(w, meta=dict(boxes=ids, origin=origin))


@register_scene("Far", "Ragdoll Pile")
def far_ragdoll_pile(solver: SolverType, origin=(6000.0, -1500.0)) -> Scene:
    """reference: sample_far.cpp:219-270 — six ragdolls into a static V."""
    ox, oy = origin
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(ox, oy - 1.0))
    w.create_polygon_shape(g, geometry.offset_box(10.0, 0.5, (-5.0, 2.0), -0.15 * PI))
    w.create_polygon_shape(g, geometry.offset_box(10.0, 0.5, (5.0, 2.0), 0.15 * PI))
    humans = []
    for i, (dx, dy) in enumerate([(0.0, 0.5), (-0.2, 1.0), (0.2, 1.0), (-0.4, 1.5), (0.4, 1.5), (0.0, 2.0)]):
        humans.append(spawn_human(w, (ox + dx, oy + dy), 1.0, i + 1))
    return Scene(w, meta=dict(humans=humans, origin=origin))


@register_scene("Joints", "Far Chain")
def far_chain(solver: SolverType, count: int = 40, origin=(40000.0, -35000.0)) -> Scene:
    """reference: sample_far.cpp:272-342 — capsule chain hanging far out."""
    ox, oy = origin
    w = World(solver=solver)
    ground = w.create_body(type=BodyType.STATIC, position=(ox, oy))
    hx = 0.1
    prev = ground
    prev_pivot_local = (0.0, count * hx)
    ids = []
    for i in range(count):
        b = w.create_body(
            type=BodyType.DYNAMIC,
            position=(ox + (1.0 + 2.0 * i) * hx, oy + count * hx),
            linear_damping=0.1, angular_damping=0.1,
        )
        w.create_capsule_shape(b, (-hx, 0.0), (hx, 0.0), 0.025, density=20.0)
        w.create_revolute_joint(prev, b, local_anchor_a=prev_pivot_local, local_anchor_b=(-hx, 0.0))
        prev = b
        prev_pivot_local = (hx, 0.0)
        ids.append(b)
    return Scene(w, meta=dict(links=ids, origin=origin))
