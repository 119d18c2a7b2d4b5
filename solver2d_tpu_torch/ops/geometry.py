"""Shape construction (host, numpy), mass properties, and batched AABBs.

Constructors emit the unified padded rounded-polygon form (verts[8],
normals[8], count, radius) of reference src/geometry.c:22-115; mass
properties follow src/geometry.c:117-286.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MAX_POLYGON_VERTICES, ShapeType
from . import math2d as m


@dataclasses.dataclass
class ShapeGeom:
    """Host-side unified shape geometry (numpy)."""

    verts: np.ndarray    # [8,2]
    normals: np.ndarray  # [8,2]
    count: int
    radius: float
    source_type: int     # ShapeType


def _pad(a: np.ndarray) -> np.ndarray:
    """Pad to 8 rows with the last vertex, so support functions over all 8
    rows never pick garbage."""
    out = np.zeros((MAX_POLYGON_VERTICES, 2), np.float32)
    out[: len(a)] = a
    if len(a) > 0:
        out[len(a):] = a[-1]
    return out


def polygon(points, radius: float = 0.0) -> ShapeGeom:
    """Convex polygon from CCW points (reference: src/geometry.c:22-47)."""
    pts = np.asarray(points, np.float64)
    count = len(pts)
    assert 3 <= count <= MAX_POLYGON_VERTICES
    normals = np.zeros_like(pts)
    for i in range(count):
        edge = pts[(i + 1) % count] - pts[i]
        n = np.linalg.norm(edge)
        assert n > 1e-9, "zero-length polygon edge"
        e = edge / n
        normals[i] = [e[1], -e[0]]
    return ShapeGeom(
        _pad(pts.astype(np.float32)), _pad(normals.astype(np.float32)), count, float(radius),
        ShapeType.POLYGON,
    )


def box(hx: float, hy: float, radius: float = 0.0) -> ShapeGeom:
    """(reference: src/geometry.c:54-78)"""
    return polygon([(-hx, -hy), (hx, -hy), (hx, hy), (-hx, hy)], radius)


def square(h: float) -> ShapeGeom:
    return box(h, h)


def offset_box(hx: float, hy: float, center, angle: float) -> ShapeGeom:
    """A box rotated by `angle` about its center, moved to `center`
    (reference: src/geometry.c:80-98)."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    pts = np.array([(-hx, -hy), (hx, -hy), (hx, hy), (-hx, hy)], np.float64)
    return polygon(pts @ R.T + np.asarray(center, np.float64))


def circle(point, radius: float) -> ShapeGeom:
    """One vertex and a radius."""
    p = np.asarray(point, np.float32).reshape(1, 2)
    return ShapeGeom(_pad(p), _pad(np.array([[0.0, 1.0]])), 1, float(radius), ShapeType.CIRCLE)


def capsule(p1, p2, radius: float, source_type=ShapeType.CAPSULE) -> ShapeGeom:
    """Two vertices and a radius (reference: src/geometry.c:100-115)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    axis = p2 - p1
    n = np.linalg.norm(axis)
    if n < 1e-12:
        raise ValueError("degenerate capsule")
    axis = axis / n
    normal = np.array([axis[1], -axis[0]])
    verts = _pad(np.stack([p1, p2]).astype(np.float32))
    normals = _pad(np.stack([normal, -normal]).astype(np.float32))
    return ShapeGeom(verts, normals, 2, float(radius), source_type)


def segment(p1, p2) -> ShapeGeom:
    """A capsule of radius 0 (reference: src/manifold.c:232-238)."""
    return capsule(p1, p2, 0.0, source_type=ShapeType.SEGMENT)


@dataclasses.dataclass
class MassData:
    mass: float
    center: np.ndarray  # [2]
    inertia: float      # about the shape's local origin


def compute_mass(geom: ShapeGeom, density: float) -> MassData:
    """Mass properties of a shape about its local origin in float64, as the
    JAX package's `compute_mass` (reference: src/geometry.c:117-286): a
    circle (count 1), a capsule or segment (count 2) or a rounded polygon.
    The `World` takes it where the JAX `World` does (`defer_mass=False`, a
    build-time `apply_linear_impulse`); the float32 masses of `freeze` come
    from the scene compiler (`native.compile_scene`)."""
    count, radius = geom.count, geom.radius
    pts = geom.verts[:count].astype(np.float64)
    rr = radius * radius
    if count == 1:
        mass = density * np.pi * rr
        return MassData(mass, pts[0].copy(), mass * (0.5 * rr + pts[0] @ pts[0]))
    if count == 2:
        length = np.linalg.norm(pts[1] - pts[0])
        ll = length * length
        mass = density * (np.pi * radius + 2.0 * length) * radius
        return MassData(mass, 0.5 * (pts[0] + pts[1]), mass * (0.5 * (rr + ll) + (4.0 * rr + ll) / 12.0))
    if radius > 0.0:
        normals = geom.normals[:count].astype(np.float64)
        out = np.zeros_like(pts)
        for i in range(count):
            n1, n2 = normals[count - 1 if i == 0 else i - 1], normals[i]
            mid = n1 + n2
            mid = mid / max(np.linalg.norm(mid), 1e-12)
            sin_half = mid[0] * n1[0] - mid[1] * -n1[1]
            offset = radius / sin_half if sin_half > 1e-7 else radius
            out[i] = pts[i] + offset * mid
        pts = out
    center, area, inertia = np.zeros(2), 0.0, 0.0
    r, inv3 = pts[0], 1.0 / 3.0
    for i in range(1, count - 1):
        e1, e2 = pts[i] - r, pts[i + 1] - r
        D = e1[0] * e2[1] - e1[1] * e2[0]
        area += 0.5 * D
        center += 0.5 * D * inv3 * (e1 + e2)
        intx2 = e1[0] ** 2 + e2[0] * e1[0] + e2[0] ** 2
        inty2 = e1[1] ** 2 + e2[1] * e1[1] + e2[1] ** 2
        inertia += (0.25 * inv3 * D) * (intx2 + inty2)
    mass = density * area
    center /= area
    world_center = r + center
    inertia = density * inertia + mass * (world_center @ world_center - center @ center)
    return MassData(mass, world_center, inertia)


def compute_aabbs(verts, radius, origin, rot):
    """World AABBs [..., S, 4] = (lo.x, lo.y, hi.x, hi.y) of unified shapes:
    min/max over the padded vertices (padding repeats a real vertex), then
    inflate by the radius (reference: src/geometry.c:288-341).
    verts [..., S, 8, 2]; radius [..., S]; origin, rot [..., S, 2]."""
    world = origin[..., None, :] + m.rotate(rot[..., None, :], verts)
    lo = world.amin(dim=-2) - radius[..., None]
    hi = world.amax(dim=-2) + radius[..., None]
    return torch.cat([lo, hi], dim=-1)
