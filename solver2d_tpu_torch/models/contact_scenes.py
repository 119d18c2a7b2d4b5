"""Contact scene catalog (reference: samples/collection/sample_contact.cpp).

An own copy of the JAX package's `models/contact_scenes.py`: every scene
builds the reference constructor's bodies, shapes and parameters (file:line
cited per scene)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import PI, BodyType, SolverType
from ..ops import geometry
from ..ops.hull import compute_hull
from ..ops.math2d import sqrt
from ..world import World
from . import Scene, register_scene


def _ground_segment(w, half_width, friction=0.6, y=0.0):
    g = w.create_body(type=BodyType.STATIC)
    w.create_segment_shape(g, (-half_width, y), (half_width, y), friction=friction)
    return g


@register_scene("Contact", "Single Box")
def single_box(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:14-51"""
    w = World(solver=solver)
    extent = 1.0
    _ground_segment(w, 66.0 * extent, friction=0.5)
    b = w.create_body(type=BodyType.DYNAMIC, position=(0.0, 4.0))
    w.create_polygon_shape(b, geometry.box(extent, extent), friction=0.5)
    return Scene(w, meta=dict(box=b))


@register_scene("Contact", "Warm Start Energy")
def warm_start_energy(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:53-120 — the heavy top circle is
    destroyed at step 120 to expose warm-start overshoot."""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC)
    w.create_segment_shape(g, (-10.0, 0.0), (10.0, 0.0))
    ids = []
    for y, density in [(0.5, 1.0), (1.5, 1.0), (2.5, 100.0)]:
        b = w.create_body(type=BodyType.DYNAMIC, position=(0.0, y))
        w.create_circle_shape(b, (0.0, 0.0), 0.5, density=density)
        ids.append(b)
    top = ids[-1]

    def on_step(state, i):
        if i == 120:
            from ..utils.runtime import destroy_body

            return destroy_body(state, top)
        return None

    return Scene(w, on_step=on_step, meta=dict(top=top, stack=ids[:2]))


@register_scene("Contact", "High Mass Ratio 1")
def high_mass_ratio_1(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:122-189 — three pyramids with a heavy
    capstone (100x, 200x, 300x)."""
    w = World(solver=solver)
    extent = 1.0
    _ground_segment(w, 66.0 * extent, friction=0.5)
    for j in range(3):
        count0 = 10
        offset = -20.0 * extent + 2.0 * (count0 + 1.0) * extent * j
        y = extent
        count = count0
        while count > 0:
            for i in range(count):
                coeff = i - 0.5 * count
                yy = y + 2.0 if count == 1 else y
                b = w.create_body(type=BodyType.DYNAMIC, position=(2.0 * coeff * extent + offset, yy))
                density = (j + 1.0) * 100.0 if count == 1 else 1.0
                w.create_polygon_shape(b, geometry.box(extent, extent), friction=0.5, density=density)
            count -= 1
            y += 2.0 * extent
    return Scene(w)


def _high_mass_ratio_23(solver, thick_ground: bool) -> Scene:
    w = World(solver=solver)
    extent = 1.0
    if thick_ground:
        g = w.create_body(type=BodyType.STATIC, position=(0.0, -2.0))
        w.create_polygon_shape(g, geometry.box(40.0, 2.0))
    else:
        g = w.create_body(type=BodyType.STATIC)
        w.create_segment_shape(g, (-20.0, 0.0), (20.0, 0.0))
    small = geometry.box(0.5 * extent, 0.5 * extent)
    big = geometry.box(10.0 * extent, 10.0 * extent)
    for pos, geom in [((-9.0, 0.5), small), ((9.0, 0.5), small), ((0.0, 26.0), big)]:
        b = w.create_body(type=BodyType.DYNAMIC, position=pos)
        w.create_polygon_shape(b, geom)
    return Scene(w)


@register_scene("Contact", "High Mass Ratio 2")
def high_mass_ratio_2(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:191-244 — big box on two small boxes."""
    return _high_mass_ratio_23(solver, thick_ground=False)


@register_scene("Contact", "High Mass Ratio 3")
def high_mass_ratio_3(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:246-299 — same with thick box ground."""
    return _high_mass_ratio_23(solver, thick_ground=True)


@register_scene("Contact", "Friction Ramp")
def friction_ramp(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:301-366"""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC)
    w.create_segment_shape(g, (-40.0, 0.0), (40.0, 0.0), friction=0.2)
    for hx, hy, c, a in [
        (13.0, 0.25, (-4.0, 22.0), -0.25),
        (0.25, 1.0, (10.5, 19.0), 0.0),
        (13.0, 0.25, (4.0, 14.0), 0.25),
        (0.25, 1.0, (-10.5, 11.0), 0.0),
        (13.0, 0.25, (-4.0, 6.0), -0.25),
    ]:
        w.create_polygon_shape(g, geometry.offset_box(hx, hy, c, a), friction=0.2)
    frictions = [0.75, 0.5, 0.35, 0.1, 0.0]
    ids = []
    for i, mu in enumerate(frictions):
        b = w.create_body(type=BodyType.DYNAMIC, position=(-15.0 + 4.0 * i, 28.0))
        w.create_polygon_shape(b, geometry.box(0.5, 0.5), friction=mu, density=25.0)
        ids.append(b)
    return Scene(w, meta=dict(boxes=ids, frictions=frictions))


def _overlap_pyramid(w, origin=(0.0, 0.0)):
    """Pyramid spawned 25% overlapped (sample_contact.cpp:368-418)."""
    base_count, overlap, extent = 4, 0.25, 0.5
    fraction = 1.0 - overlap
    y = extent
    ids = []
    for i in range(base_count):
        x = fraction * extent * (i - base_count)
        for j in range(i, base_count):
            b = w.create_body(type=BodyType.DYNAMIC, position=(x + origin[0], y + origin[1]))
            w.create_polygon_shape(b, geometry.square(extent))
            ids.append(b)
            x += 2.0 * fraction * extent
        y += 2.0 * fraction * extent
    return ids


@register_scene("Contact", "Overlap Recovery")
def overlap_recovery(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:368-418"""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC)
    w.create_segment_shape(g, (-40.0, 0.0), (40.0, 0.0))
    ids = _overlap_pyramid(w)
    return Scene(w, meta=dict(boxes=ids))


@register_scene("Contact", "Vertical Stack")
def vertical_stack(solver: SolverType, row_count: int = 15) -> Scene:
    """reference: sample_contact.cpp:420-497 — 15 boxes, alternating 1cm shift."""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(0.0, -1.0))
    w.create_polygon_shape(g, geometry.box(100.0, 1.0))
    offset = 0.01
    ids = []
    for i in range(row_count):
        shift = -offset if i % 2 == 0 else offset
        b = w.create_body(type=BodyType.DYNAMIC, position=(shift, 0.55 + 1.1 * i))
        w.create_polygon_shape(b, geometry.box(0.5, 0.5), friction=0.3)
        ids.append(b)
    return Scene(w, meta=dict(boxes=ids))


def pyramid_world(solver: SolverType, base_count: int) -> tuple[World, list[int]]:
    """reference: sample_contact.cpp:499-561 (release base 100 -> 5050 boxes).
    Body 0 is the ground; boxes follow row by row."""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(0.0, -1.0))
    w.create_polygon_shape(g, geometry.box(100.0, 1.0))
    h = 0.5
    ids = []
    for i in range(base_count):
        y = (2.0 * i + 1.0) * h
        for j in range(i, base_count):
            x = (i + 1.0) * h + 2.0 * (j - i) * h - h * base_count
            b = w.create_body(type=BodyType.DYNAMIC, position=(x, y))
            w.create_polygon_shape(b, geometry.square(h))
            ids.append(b)
    return w, ids


@register_scene("Contact", "Pyramid")
def pyramid(solver: SolverType, base_count: int = 20) -> Scene:
    w, ids = pyramid_world(solver, base_count)
    return Scene(w, meta=dict(boxes=ids, base_count=base_count))


@register_scene("Contact", "Rush")
def rush(solver: SolverType, count: int = 400) -> Scene:
    """reference: sample_contact.cpp:563-663 — force-driven circles converge
    on a static circle; forces applied every step via pre_step."""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC)
    w.create_circle_shape(g, (0.0, 0.0), 0.5, friction=0.2, density=100.0)
    distance, angle = 5.0, 0.0
    ids = []
    for _ in range(count):
        b = w.create_body(
            type=BodyType.DYNAMIC,
            position=(distance * np.cos(angle), distance * np.sin(angle)),
            gravity_scale=0.0,
        )
        w.create_circle_shape(b, (0.0, 0.0), 0.5, friction=0.2, density=100.0)
        ids.append(b)
        angle += 1.0 / distance
        distance += 0.05

    def pre_step(state):
        """Every live dynamic body of every world of the [W, ...] batch is
        pulled toward the origin with a force of 1000."""
        p = state.bodies.position
        dist = sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1])
        dyn = (state.bodies.type == 2) & state.bodies.alive & (dist >= 0.1)
        # a tensor numerator: `1000.0 / x` would multiply by x's reciprocal
        scale = torch.where(dist >= 0.1, dist.new_tensor(1000.0) / torch.clamp(dist, min=0.1), 0.0)
        force = torch.where(dyn[..., None], -scale[..., None] * p, 0.0)
        return dataclasses.replace(state, bodies=dataclasses.replace(state.bodies, force=force))

    return Scene(w, pre_step=pre_step, meta=dict(circles=ids))


@register_scene("Contact", "Arch")
def arch(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:665-759"""
    ps1 = np.array([
        [16.0, 0.0], [14.93803712795643, 5.133601056842984],
        [13.79871746027416, 10.24928069555078], [12.56252963284711, 15.34107019122473],
        [11.20040987372525, 20.39856541571217], [9.66521217819836, 25.40369899225096],
        [7.87179930638133, 30.3179337000085], [5.635199558196225, 35.03820717801641],
        [2.405937953536585, 39.09554102558315]]) * 0.25
    ps2 = np.array([
        [24.0, 0.0], [22.33619528222415, 6.02299846205841],
        [20.54936888969905, 12.00964361211476], [18.60854610798073, 17.9470321677465],
        [16.46769273811807, 23.81367936585418], [14.05325025774858, 29.57079353071012],
        [11.23551045834022, 35.13775818285372], [7.752568160730571, 40.30450679009583],
        [3.016931552701656, 44.28891593799322]]) * 0.25

    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC)
    w.create_segment_shape(g, (-100.0, 0.0), (100.0, 0.0), friction=0.6)

    def add_hull(pts):
        h = compute_hull(pts)
        assert h is not None
        b = w.create_body(type=BodyType.DYNAMIC)
        w.create_polygon_shape(b, geometry.polygon(h), friction=0.6)

    for i in range(8):
        add_hull([ps1[i], ps2[i], ps2[i + 1], ps1[i + 1]])
    for i in range(8):
        add_hull([
            [-ps2[i][0], ps2[i][1]], [-ps1[i][0], ps1[i][1]],
            [-ps1[i + 1][0], ps1[i + 1][1]], [-ps2[i + 1][0], ps2[i + 1][1]]])
    add_hull([ps1[8], ps2[8], [-ps2[8][0], ps2[8][1]], [-ps1[8][0], ps1[8][1]]])
    for i in range(4):
        b = w.create_body(type=BodyType.DYNAMIC, position=(0.0, 0.5 + ps2[8][1] + 1.0 * i))
        w.create_polygon_shape(b, geometry.box(2.0, 0.5), friction=0.6)
    return Scene(w)


@register_scene("Contact", "Double Domino")
def double_domino(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:761-812 — first domino gets an impulse."""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(0.0, -1.0))
    w.create_polygon_shape(g, geometry.box(100.0, 1.0))
    count = 15
    x = -0.5 * count
    ids = []
    for i in range(count):
        b = w.create_body(type=BodyType.DYNAMIC, position=(x, 0.5))
        w.create_polygon_shape(b, geometry.box(0.125, 0.5), friction=0.6)
        if i == 0:
            w.apply_linear_impulse(b, (0.2, 0.0), (x, 1.0))
        ids.append(b)
        x += 1.0
    return Scene(w, meta=dict(dominoes=ids))


@register_scene("Contact", "Confined")
def confined(solver: SolverType, grid_count: int = 25) -> Scene:
    """reference: sample_contact.cpp:814-886 — 625 zero-gravity circles in a
    capsule-walled box."""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC)
    for p1, p2 in [
        ((-10.5, 0.0), (10.5, 0.0)),
        ((-10.5, 0.0), (-10.5, 20.5)),
        ((10.5, 0.0), (10.5, 20.5)),
        ((-10.5, 20.5), (10.5, 20.5)),
    ]:
        w.create_capsule_shape(g, p1, p2, 0.5)
    ids = []
    for column in range(grid_count):
        for row in range(grid_count):
            x = -8.75 + column * 18.0 / grid_count
            y = 1.5 + row * 18.0 / grid_count
            b = w.create_body(type=BodyType.DYNAMIC, position=(x, y), gravity_scale=0.0)
            w.create_circle_shape(b, (0.0, 0.0), 0.5)
            ids.append(b)
    return Scene(w, meta=dict(circles=ids))


@register_scene("Contact", "Card House")
def card_house(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:888-963 (from PEEL)"""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC, position=(0.0, -2.0))
    w.create_polygon_shape(g, geometry.box(40.0, 2.0), friction=0.7)
    card_height = 0.2
    card_thickness = 0.001
    angle0 = 25.0 * PI / 180.0
    angle1 = -25.0 * PI / 180.0
    angle2 = 0.5 * PI
    card = geometry.box(card_thickness, card_height)
    nb, z0 = 5, 0.0
    y = card_height - 0.02
    while nb:
        z = z0
        for i in range(nb):
            if i != nb - 1:
                b = w.create_body(type=BodyType.DYNAMIC, position=(z + 0.25, y + card_height - 0.015), angle=angle2)
                w.create_polygon_shape(b, card, friction=0.7)
            b = w.create_body(type=BodyType.DYNAMIC, position=(z, y), angle=angle1)
            w.create_polygon_shape(b, card, friction=0.7)
            z += 0.175
            b = w.create_body(type=BodyType.DYNAMIC, position=(z, y), angle=angle0)
            w.create_polygon_shape(b, card, friction=0.7)
            z += 0.175
        y += card_height * 2.0 - 0.03
        z0 += 0.175
        nb -= 1
    return Scene(w)


@register_scene("Contact", "Circle Stack")
def circle_stack(solver: SolverType) -> Scene:
    """reference: sample_contact.cpp:965-1010"""
    w = World(solver=solver)
    g = w.create_body(type=BodyType.STATIC)
    w.create_segment_shape(g, (-40.0, 0.0), (40.0, 0.0))
    ids = []
    for i in range(10):
        b = w.create_body(type=BodyType.DYNAMIC, position=(0.0, 4.0 + 3.0 * i))
        w.create_circle_shape(b, (0.0, 0.0), 1.0)
        ids.append(b)
    return Scene(w, meta=dict(circles=ids))
