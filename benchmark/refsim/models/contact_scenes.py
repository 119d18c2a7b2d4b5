"""The reference's Pyramid (samples/collection/sample_contact.cpp), as the
port's `models/contact_scenes.py` builds it: the bodies, shapes and
parameters of the reference's constructor."""

from __future__ import annotations

from ..config import BodyType, SolverType
from ..ops import geometry
from ..world import World
from . import Scene, register_scene


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
