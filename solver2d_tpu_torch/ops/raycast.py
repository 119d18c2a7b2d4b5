"""Shape raycasts and point tests, batched over leading dims.

An own copy of the JAX package's `ops/raycast.py` (reference:
src/geometry.c:343-730): circle (Ray Tracing Gems precision form),
capsule, segment, convex polygon (slab clipping), each one vectorized
function of the unified padded shape; the JAX functions are one shape
under `vmap`, these take a batch. The same operations in the same order,
so results equal the JAX package's on the same inputs. `queries.py` fans
a ray out over a world's shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import HUGE, MAX_POLYGON_VERTICES
from . import math2d as m
from .distance import gjk


class RayHit(NamedTuple):
    hit: torch.Tensor       # bool [...]
    fraction: torch.Tensor  # f32 [...]
    point: torch.Tensor     # [..., 2]
    normal: torch.Tensor    # [..., 2]
    shape: torch.Tensor     # i32 [...] (world raycast only; -1 = none)


def _hit(ok, frac, point, normal):
    """The miss values where not ok: fraction 1, point and normal 0."""
    ok2 = ok[..., None]
    return ok, torch.where(ok, frac, 1.0), torch.where(ok2, point, 0.0), torch.where(ok2, normal, 0.0)


def raycast_circle(p1, p2, max_fraction, center, radius):
    """reference: src/geometry.c:391-448"""
    s = p1 - center
    length, d = m.get_length_and_normalize(p2 - p1)
    t = -m.dot(s, d)
    c = s + t[..., None] * d
    cc = m.dot(c, c)
    rr = radius * radius
    h = m.sqrt(torch.clamp(rr - cc, min=0.0))
    fraction = t - h
    ok = (length > 0.0) & (cc <= rr) & (fraction >= 0.0) & (fraction <= max_fraction * length)
    hit_point = s + fraction[..., None] * d
    normal = m.normalize(hit_point)
    point = center + radius[..., None] * normal
    frac = fraction / torch.where(length > 0, length, 1.0)
    return _hit(ok, frac, point, normal)


def raycast_polygon(p1, p2, max_fraction, verts, count, radius):
    """Slab clipping against the half-planes (reference:
    src/geometry.c:656-730). A rounded polygon casts its zero-radius core,
    as in the JAX package; shapes of fewer than 3 vertices take the circle
    and capsule casts (`raycast_shape`)."""
    lanes = torch.arange(MAX_POLYGON_VERTICES, device=verts.device)
    cnt = count[..., None]
    nxt = torch.where(lanes + 1 < cnt, lanes + 1, 0)
    edges = torch.gather(verts, -2, nxt[..., None].expand(verts.shape)) - verts
    normals = m.normalize(m.cross_vs(edges, 1.0))

    d = p2 - p1
    num = m.dot(verts - p1[..., None, :], normals)
    den = m.dot(normals, d[..., None, :])

    valid = lanes < cnt
    # parallel and outside: a miss
    parallel_out = valid & (den == 0.0) & (num < 0.0)

    frac = num / torch.where(den != 0.0, den, 1.0)
    is_lower = valid & (den < 0.0)
    is_upper = valid & (den > 0.0)

    lower = torch.where(is_lower, frac, 0.0).amax(dim=-1)
    lower_frac = torch.where(is_lower, frac, float("-inf"))
    lower_idx = torch.argmax(lower_frac, dim=-1)
    upper = torch.where(is_upper, frac, max_fraction).amin(dim=-1)

    ok = (
        ~parallel_out.any(dim=-1)
        & (lower <= upper)
        & (lower <= max_fraction)
        & is_lower.any(dim=-1)
        & (lower_frac.amax(dim=-1) >= 0.0)
    )
    point = p1 + lower[..., None] * d
    normal = torch.gather(normals, -2, lower_idx[..., None, None].expand(normals.shape[:-2] + (1, 2)))[..., 0, :]
    return _hit(ok, lower, point, normal)


def raycast_capsule(p1, p2, max_fraction, v1, v2, radius):
    """A capsule is a segment with a radius: its two end circles and the
    slab between them (the behaviour of src/geometry.c:450-581)."""
    axis_len, a = m.get_length_and_normalize(v2 - v1)

    # the side slab: the segment's planes offset by the radius
    n_side = torch.stack([a[..., 1], -a[..., 0]], dim=-1)  # right perp
    ray_len, u = m.get_length_and_normalize(p2 - p1)
    den = m.cross(a, u)

    q = p1 - v1
    qa = m.dot(q, a)
    qp = q - qa[..., None] * a
    r = radius[..., None]
    inside = m.dot(qp, qp) < radius * radius

    # the two candidate side lines at +-radius
    b1 = q - r * n_side
    b2 = q + r * n_side
    inv_den = 1.0 / torch.where(den != 0.0, den, 1.0)
    s21 = (a[..., 0] * b1[..., 1] - b1[..., 0] * a[..., 1]) * inv_den
    s22 = (a[..., 0] * b2[..., 1] - b2[..., 0] * a[..., 1]) * inv_den
    take1 = s21 < s22
    s2_ = torch.where(take1, s21, s22)
    b = torch.where(take1[..., None], b1, b2)
    n_hit = torch.where(take1[..., None], n_side, -n_side)
    s1 = (-b[..., 0] * u[..., 1] + u[..., 0] * b[..., 1]) * inv_den

    side_valid = ((den != 0.0) & (s2_ >= 0.0) & (s2_ <= max_fraction * ray_len) & (s1 >= 0.0)
                  & (s1 <= axis_len) & ~inside)
    side_frac = s2_ / torch.where(ray_len > 0, ray_len, 1.0)
    side_point = v1 + s1[..., None] * a + r * n_hit

    # the end circles
    ok1, f1, pt1, n1 = raycast_circle(p1, p2, max_fraction, v1, radius)
    ok2, f2, pt2, n2 = raycast_circle(p1, p2, max_fraction, v2, radius)

    # the nearest of the valid candidates (the first on ties)
    fs = torch.stack([torch.where(side_valid, side_frac, HUGE), torch.where(ok1, f1, HUGE),
                      torch.where(ok2, f2, HUGE)], dim=-1)
    best = torch.argmin(fs, dim=-1)
    ok = fs.amin(dim=-1) < HUGE

    def pick(xs):
        x = torch.stack(xs, dim=-2)
        return torch.gather(x, -2, best[..., None, None].expand(x.shape[:-2] + (1, 2)))[..., 0, :]

    frac = torch.gather(fs, -1, best[..., None])[..., 0]
    return _hit(ok, frac, pick([side_point, pt1, pt2]), pick([n_hit, n1, n2]))


def raycast_shape(p1, p2, max_fraction, verts, count, radius):
    """The cast of a unified shape by its vertex count: 1 a circle, 2 a
    capsule or segment, else a polygon."""
    c = raycast_circle(p1, p2, max_fraction, verts[..., 0, :], radius)
    s = raycast_capsule(p1, p2, max_fraction, verts[..., 0, :], verts[..., 1, :], radius)
    p = raycast_polygon(p1, p2, max_fraction, verts, count, radius)
    is_circle, is_seg = count == 1, count == 2

    def sel(xc, xs, xp):
        ic, iseg = (is_circle, is_seg) if xc.dim() == count.dim() else (is_circle[..., None], is_seg[..., None])
        return torch.where(ic, xc, torch.where(iseg, xs, xp))

    return tuple(sel(*xs) for xs in zip(c, s, p))


def point_in_shape(point, verts, count, radius):
    """Local-space point test (reference: src/geometry.c:343-389): the GJK
    distance from the point to the shape's core within its radius."""
    lead = count.shape
    pverts = point[..., None, :].expand(lead + (MAX_POLYGON_VERTICES, 2))
    ones = torch.ones(lead, dtype=torch.int32, device=count.device)
    zeros3 = torch.zeros(lead + (3,), dtype=torch.int32, device=count.device)
    out = gjk(pverts, ones, verts, count, ones * 0, zeros3, zeros3)
    return out.distance <= radius
