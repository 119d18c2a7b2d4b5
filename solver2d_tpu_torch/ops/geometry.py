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


@dataclasses.dataclass
class MassData:
    mass: float
    center: np.ndarray  # [2]
    inertia: float      # about the shape's local origin


def compute_mass(geom: ShapeGeom, density: float) -> MassData:
    """Mass properties of a rounded polygon (reference: src/geometry.c:154-286).
    The port builds polygons only (count >= 3)."""
    count = geom.count
    radius = geom.radius
    verts = geom.verts[:count].astype(np.float64)

    pts = verts.copy()
    if radius > 0.0:
        # push vertices out along the corner bisectors (geometry.c:203-225)
        normals = geom.normals[:count].astype(np.float64)
        out = np.zeros_like(pts)
        for i in range(count):
            j = count - 1 if i == 0 else i - 1
            n1, n2 = normals[j], normals[i]
            mid = n1 + n2
            mid = mid / max(np.linalg.norm(mid), 1e-12)
            t1 = np.array([-n1[1], n1[0]])
            sin_half = mid[0] * t1[1] - mid[1] * t1[0]
            offset = radius / sin_half if sin_half > 1e-7 else radius
            out[i] = pts[i] + offset * mid
        pts = out

    center = np.zeros(2)
    area = 0.0
    inertia = 0.0
    r = pts[0]
    inv3 = 1.0 / 3.0
    for i in range(1, count - 1):
        e1 = pts[i] - r
        e2 = pts[i + 1] - r
        D = e1[0] * e2[1] - e1[1] * e2[0]
        tri_area = 0.5 * D
        area += tri_area
        center += tri_area * inv3 * (e1 + e2)
        intx2 = e1[0] ** 2 + e2[0] * e1[0] + e2[0] ** 2
        inty2 = e1[1] ** 2 + e2[1] * e1[1] + e2[1] ** 2
        inertia += (0.25 * inv3 * D) * (intx2 + inty2)

    mass = density * area
    assert area > 1e-12
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
