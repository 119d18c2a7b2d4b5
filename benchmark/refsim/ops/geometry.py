"""Shape construction (host, numpy) and batched AABBs.

Constructors emit the unified padded rounded-polygon form (verts[8],
normals[8], count, radius) of reference src/geometry.c:22-115; the mass
properties are the scene compiler's (`native.compile_scene`).
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


def compute_aabbs(verts, radius, origin, rot):
    """World AABBs [..., S, 4] = (lo.x, lo.y, hi.x, hi.y) of unified shapes:
    min/max over the padded vertices (padding repeats a real vertex), then
    inflate by the radius (reference: src/geometry.c:288-341).
    verts [..., S, 8, 2]; radius [..., S]; origin, rot [..., S, 2]."""
    world = origin[..., None, :] + m.rotate(rot[..., None, :], verts)
    lo = world.amin(dim=-2) - radius[..., None]
    hi = world.amax(dim=-2) + radius[..., None]
    return torch.cat([lo, hi], dim=-1)
