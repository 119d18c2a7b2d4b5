"""Shape construction (host, numpy), mass properties, and batched AABBs.

Constructors emit the unified padded rounded-polygon form (verts[8],
normals[8], count, radius) of reference src/geometry.c:22-115; mass
properties follow src/geometry.c:117-286.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MAX_POLYGON_VERTICES, PI, ShapeType
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
    """Mass properties of a shape about its local origin: a circle (count
    1), a capsule or segment (count 2) or a rounded polygon (reference:
    src/geometry.c:117-286). The arithmetic is float32, operation for
    operation as the scene compiler csrc/s2native.cpp (`s2n_shape_mass`)
    computes it, so that a frozen world's masses and inertias equal the JAX
    package's to the bit."""
    f = np.float32
    count = geom.count
    radius = f(geom.radius)
    density = f(density)
    pts = geom.verts[:count].astype(f)
    rr = radius * radius
    if count == 1:
        mass = density * f(PI) * rr
        c = pts[0]
        return MassData(mass, c.copy(), mass * (f(0.5) * rr + (c[0] * c[0] + c[1] * c[1])))
    if count == 2:
        dx, dy = pts[1][0] - pts[0][0], pts[1][1] - pts[0][1]
        length = np.sqrt(dx * dx + dy * dy)
        ll = length * length
        mass = density * (f(PI) * radius + f(2) * length) * radius
        center = np.array([f(0.5) * (pts[0][0] + pts[1][0]), f(0.5) * (pts[0][1] + pts[1][1])], f)
        box_inertia = (f(4) * rr + ll) / f(12)
        return MassData(mass, center, mass * (f(0.5) * (rr + ll) + box_inertia))
    if radius > 0:
        # push vertices out along the corner bisectors (geometry.c:203-225)
        normals = geom.normals[:count].astype(f)
        out = np.zeros_like(pts)
        for i in range(count):
            n1, n2 = normals[count - 1 if i == 0 else i - 1], normals[i]
            mid_x, mid_y = n1[0] + n2[0], n1[1] + n2[1]
            ml = np.sqrt(mid_x * mid_x + mid_y * mid_y)
            if ml > f(1e-12):
                mid_x, mid_y = mid_x / ml, mid_y / ml
            sin_half = mid_x * n1[0] - mid_y * -n1[1]
            offset = radius / sin_half if sin_half > f(1.1920929e-07) else radius
            out[i] = (pts[i][0] + offset * mid_x, pts[i][1] + offset * mid_y)
        pts = out

    cx = cy = area = inertia = f(0)
    rx, ry = pts[0]
    inv3 = f(1) / f(3)
    for i in range(1, count - 1):
        e1x, e1y = pts[i][0] - rx, pts[i][1] - ry
        e2x, e2y = pts[i + 1][0] - rx, pts[i + 1][1] - ry
        D = e1x * e2y - e1y * e2x
        tri = f(0.5) * D
        area += tri
        cx += tri * inv3 * (e1x + e2x)
        cy += tri * inv3 * (e1y + e2y)
        intx2 = e1x * e1x + e2x * e1x + e2x * e2x
        inty2 = e1y * e1y + e2y * e1y + e2y * e2y
        inertia += (f(0.25) * inv3 * D) * (intx2 + inty2)

    mass = density * area
    inv_area = f(1) / area if area > f(1e-12) else f(0)
    cx, cy = cx * inv_area, cy * inv_area
    wx, wy = rx + cx, ry + cy
    inertia *= density
    inertia += mass * ((wx * wx + wy * wy) - (cx * cx + cy * cy))
    return MassData(mass, np.array([wx, wy], f), inertia)


def compute_mass_f64(geom: ShapeGeom, density: float) -> MassData:
    """`compute_mass` in float64, as the JAX `World` computes a body's mass
    when a build-time call needs it before freezing (its
    `apply_linear_impulse`): the same formulas, rounded once at the end."""
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
