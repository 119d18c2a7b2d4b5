"""Joint scene catalog (reference: samples/collection/sample_joints.cpp).

An own copy of the JAX package's `models/joint_scenes.py`. `bridge` returns
the world and its planks; the registered Bridge scene wraps it."""

from __future__ import annotations

from ..config import BodyType, SolverType
from ..ops import geometry
from ..world import World
from . import Scene, register_scene
from .human import spawn_human


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


@register_scene("Joints", "Ball & Chain")
def ball_and_chain(solver: SolverType, count: int = 40) -> Scene:
    """reference: sample_joints.cpp:92-173 — 40 capsule links + an 8m ball."""
    w = World(solver=solver)
    ground = w.create_body(type=BodyType.STATIC)
    hx = 0.5
    prev = ground
    ids = []
    for i in range(count):
        b = w.create_body(
            type=BodyType.DYNAMIC, position=((1.0 + 2.0 * i) * hx, count * hx),
            linear_damping=0.1, angular_damping=0.1,
        )
        w.create_capsule_shape(b, (-hx, 0.0), (hx, 0.0), 0.125, density=20.0)
        pivot = ((2.0 * i) * hx, count * hx)
        w.create_revolute_joint(
            prev, b,
            local_anchor_a=w.get_local_point(prev, pivot),
            local_anchor_b=w.get_local_point(b, pivot),
        )
        prev = b
        ids.append(b)
    radius = 8.0
    ball = w.create_body(
        type=BodyType.DYNAMIC,
        position=((1.0 + 2.0 * count) * hx + radius - hx, count * hx),
        linear_damping=0.1, angular_damping=0.1,
    )
    w.create_circle_shape(ball, (0.0, 0.0), radius, density=20.0)
    pivot = ((2.0 * count) * hx, count * hx)
    w.create_revolute_joint(
        prev, ball,
        local_anchor_a=w.get_local_point(prev, pivot),
        local_anchor_b=w.get_local_point(ball, pivot),
    )
    return Scene(w, meta=dict(links=ids, ball=ball))


@register_scene("Joints", "Ragdoll")
def ragdoll(solver: SolverType) -> Scene:
    """reference: sample_joints.cpp:175-206"""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(0.0, -1.0))
    w.create_polygon_shape(g, geometry.box(20.0, 1.0))
    human = spawn_human(w, (0.0, 4.0), 1.0, 1)
    return Scene(w, meta=dict(human=human))


@register_scene("Joints", "Ragdoll Stress")
def ragdoll_stress(solver: SolverType, count: int = 32) -> Scene:
    """reference: sample_joints.cpp:208-362 — ragdolls dropped into a
    motorized pachinko. All humans are spawned at the start (the reference
    spawns one every 0.5 s and despawns below y=-25)."""
    w = World(solver=solver)
    ground = w.create_body(type=BodyType.STATIC)
    pts = [
        (-16.8672504, 31.088623), (16.8672485, 31.088623), (16.8672485, 17.1978741),
        (8.26824951, 11.906374), (16.8672485, 11.906374), (16.8672485, -0.661376953),
        (8.26824951, -5.953125), (16.8672485, -5.953125), (16.8672485, -13.229126),
        (3.63799858, -23.151123), (3.63799858, -31.088623), (-3.63800049, -31.088623),
        (-3.63800049, -23.151123), (-16.8672504, -13.229126), (-16.8672504, -5.953125),
        (-8.26825142, -5.953125), (-16.8672504, -0.661376953), (-16.8672504, 11.906374),
        (-8.26825142, 11.906374), (-16.8672504, 17.1978741),
    ]
    for i in range(len(pts)):
        w.create_capsule_shape(ground, pts[i], pts[(i + 1) % len(pts)], 0.5, friction=0.2)

    paddles = []
    sign, y = 1.0, 14.0
    for _ in range(3):
        b = w.create_body(type=BodyType.DYNAMIC, position=(0.0, y))
        w.create_polygon_shape(b, geometry.box(6.0, 0.5), friction=0.1, restitution=1.0)
        w.create_revolute_joint(
            ground, b, local_anchor_a=(0.0, y), local_anchor_b=(0.0, 0.0),
            enable_motor=True, motor_speed=5.0 * sign, max_motor_torque=200.0,
        )
        paddles.append(b)
        y -= 14.0
        sign = -sign

    humans = []
    side = -15.0
    for i in range(count):
        humans.append(spawn_human(w, (side, 28.0), 2.0, i + 1))
        side = -side

    return Scene(w, config_overrides=dict(max_colors=24, joint_max_colors=12),
                 meta=dict(humans=humans, paddles=paddles))


@register_scene("Joints", "Joint Grid")
def joint_grid(solver: SolverType, numk: int = 100, numi: int = 100) -> Scene:
    """reference: sample_joints.cpp:364-457 — NxN circle lattice of revolute
    joints; a band of static anchors in the middle of the top row."""
    w = World(solver=solver)
    rad, shift = 0.4, 1.0
    bodies = []
    index = 0
    for k in range(numk):
        for i in range(numi):
            static = (numk // 2 - 3 <= k <= numk // 2 + 3) and i == 0
            b = w.create_body(
                type=BodyType.STATIC if static else BodyType.DYNAMIC,
                position=(k * shift, -i * shift),
                gravity_scale=2.0,
            )
            w.create_circle_shape(b, (0.0, 0.0), rad, filter_category=2, filter_mask=0xFFFFFFFD)
            if i > 0:
                w.create_revolute_joint(
                    bodies[index - 1], b,
                    local_anchor_a=(0.0, -0.5 * shift), local_anchor_b=(0.0, 0.5 * shift),
                )
            if k > 0:
                w.create_revolute_joint(
                    bodies[index - numi], b,
                    local_anchor_a=(0.5 * shift, 0.0), local_anchor_b=(-0.5 * shift, 0.0),
                )
            bodies.append(b)
            index += 1
    return Scene(w, meta=dict(bodies=bodies, numk=numk, numi=numi))


@register_scene("Joints", "Stretched Chain")
def stretched_chain(solver: SolverType, count: int = 40) -> Scene:
    """reference: sample_joints.cpp:460-529 — non-colliding circles hanging
    from joints of length 1."""
    w = World(solver=solver)
    ground = w.create_body(type=BodyType.STATIC)
    length = 1.0
    base = length * count
    prev = ground
    prev_anchor = (0.0, base - 0.5 * length)
    y = base - 2.0 * length
    ids = []
    for _ in range(count):
        b = w.create_body(type=BodyType.DYNAMIC, position=(0.0, y))
        w.create_circle_shape(b, (0.0, 0.0), 0.2, filter_mask=0)
        w.create_revolute_joint(prev, b, local_anchor_a=prev_anchor, local_anchor_b=(0.0, 0.5 * length))
        prev = b
        prev_anchor = (0.0, -0.5 * length)
        y -= 2.0 * length
        ids.append(b)
    return Scene(w, meta=dict(links=ids))
