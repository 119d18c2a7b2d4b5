"""The batched scene compiler: mass properties of every body and the first
AABBs of every shape, in one call.

An own copy of the JAX package's `native.py` API, whose C++ library
(`csrc/s2native.cpp`, loaded through ctypes) it replaces with batched
tensor ops on the host: no compiler is needed. The float32 arithmetic follows the C++ operation for operation
(reference: src/geometry.c:117-286 shape mass, src/body.c:152-218 body
mass, src/shape.c:48-67 AABBs), so the results are the C++'s to the bit:

- every shape's mass, center and inertia at once, its polygon's triangle
  fan unrolled over the 8 vertex slots with the shorter fans masked;
- per-body sums in shape order: the k-th shape of each body is added in
  the k-th round, where each body appears at most once (no atomics, no
  free-order `index_add_`);
- the AABB's sine and cosine in float64 rounded to float32
  (`math2d.make_rot`), where the C++ calls `std::sin` and `std::cos` in
  float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import PI
from .ops import math2d

F32 = torch.float32
_EPS = 1.1920929e-07


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device="cpu")


def _c(value):
    return torch.tensor(value, dtype=F32)


def _dot(ax, ay, bx, by):
    return ax * bx + ay * by


def _shape_masses(verts, normals, count, radius, density):
    """(mass [N], center [N, 2], inertia [N]) of N shapes about their local
    origins: `s2n_shape_mass` of csrc/s2native.cpp on every shape."""
    n = count.shape[0]
    vx, vy = verts[..., 0], verts[..., 1]
    rr = radius * radius
    pi = _c(PI)

    # circle (count 1)
    c_mass = density * pi * rr
    c_inertia = c_mass * (_c(0.5) * rr + _dot(vx[:, 0], vy[:, 0], vx[:, 0], vy[:, 0]))

    # capsule (count 2)
    dx, dy = vx[:, 1] - vx[:, 0], vy[:, 1] - vy[:, 0]
    length = math2d.sqrt(_dot(dx, dy, dx, dy))
    ll = length * length
    k_mass = density * (pi * radius + _c(2.0) * length) * radius
    k_center = torch.stack([_c(0.5) * (vx[:, 0] + vx[:, 1]), _c(0.5) * (vy[:, 0] + vy[:, 1])], dim=-1)
    k_inertia = k_mass * (_c(0.5) * (rr + ll) + (_c(4.0) * rr + ll) / _c(12.0))

    # rounded polygon: vertices pushed out along the corner bisectors
    # (geometry.c:203-225) where the radius is positive
    slots = torch.arange(8)
    prev = torch.where(slots[None] == 0, count[:, None] - 1, slots[None] - 1).clamp(min=0).long()
    n1x, n1y = torch.gather(normals[..., 0], 1, prev), torch.gather(normals[..., 1], 1, prev)
    n2x, n2y = normals[..., 0], normals[..., 1]
    mx, my = n1x + n2x, n1y + n2y
    ml = math2d.sqrt(_dot(mx, my, mx, my))
    big = ml > _c(1e-12)
    mx, my = torch.where(big, mx / ml, mx), torch.where(big, my / ml, my)
    sin_half = mx * n1x - my * -n1y
    r8 = radius[:, None].expand(n, 8)
    offset = torch.where(sin_half > _c(_EPS), r8 / sin_half, r8)
    pushed = (radius > 0)[:, None]
    px = torch.where(pushed, vx + offset * mx, vx)
    py = torch.where(pushed, vy + offset * my, vy)

    # the triangle fan from vertex 0, in vertex order
    zero = torch.zeros(n, dtype=F32)
    cx, cy, area, inertia = zero, zero, zero, zero
    rx, ry = px[:, 0], py[:, 0]
    inv3 = _c(1.0) / _c(3.0)
    for i in range(1, 7):
        live = i < count - 1
        e1x, e1y = px[:, i] - rx, py[:, i] - ry
        e2x, e2y = px[:, i + 1] - rx, py[:, i + 1] - ry
        d = e1x * e2y - e1y * e2x
        tri = _c(0.5) * d
        intx2 = e1x * e1x + e2x * e1x + e2x * e2x
        inty2 = e1y * e1y + e2y * e1y + e2y * e2y
        area = torch.where(live, area + tri, area)
        cx = torch.where(live, cx + tri * inv3 * (e1x + e2x), cx)
        cy = torch.where(live, cy + tri * inv3 * (e1y + e2y), cy)
        inertia = torch.where(live, inertia + (_c(0.25) * inv3 * d) * (intx2 + inty2), inertia)
    p_mass = density * area
    inv_area = torch.where(area > _c(1e-12), torch.ones_like(area) / area, zero)
    cx, cy = cx * inv_area, cy * inv_area
    wx, wy = rx + cx, ry + cy
    p_inertia = inertia * density + p_mass * (_dot(wx, wy, wx, wy) - _dot(cx, cy, cx, cy))

    circle, capsule = count == 1, count == 2
    mass = torch.where(circle, c_mass, torch.where(capsule, k_mass, p_mass))
    center = torch.where(circle[:, None], verts[:, 0], torch.where(capsule[:, None], k_center,
                                                                   torch.stack([wx, wy], dim=-1)))
    inertia = torch.where(circle, c_inertia, torch.where(capsule, k_inertia, p_inertia))
    return mass, center, inertia


def _sum_in_shape_order(body, values, n_bodies):
    """Per-body sums [n_bodies, k] of values [N, k] of shapes of `body` [N]
    (each in range), added in shape order from 0: round k adds each body's
    k-th shape."""
    out = torch.zeros((n_bodies, values.shape[1]), dtype=values.dtype)
    if body.numel() == 0:
        return out
    order = torch.sort(body, stable=True).indices
    sorted_body = body[order]
    _, counts = torch.unique_consecutive(sorted_body, return_counts=True)
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rank = torch.empty_like(body)
    rank[order] = torch.arange(body.numel()) - starts
    for k in range(int(counts.max())):
        sel = rank == k
        b = body[sel]
        out[b] = out[b] + values[sel]
    return out


def compile_scene(verts, normals, counts, radii, densities, shape_body,
                  body_origin, body_angle, body_type, speculative, aabb_margin):
    """Mass properties of every body and the AABB and fat AABB of every
    shape (`s2n_compile_scene` of csrc/s2native.cpp). Shapes: verts and
    normals [S, 8, 2], counts, radii, densities, shape_body [S]; bodies:
    body_origin [B, 2], body_angle, body_type [B]. Returns a dict of float32
    numpy arrays: mass, inv_mass, inertia, inv_inertia [B], local_center
    [B, 2], aabb and fat_aabb [S, 4]."""
    verts = _t(verts, F32).reshape(-1, 8, 2)
    normals = _t(normals, F32).reshape(-1, 8, 2)
    counts = _t(counts, torch.int32).reshape(-1)
    radii = _t(radii, F32).reshape(-1)
    densities = _t(densities, F32).reshape(-1)
    shape_body = _t(shape_body, torch.int64).reshape(-1)
    body_angle = _t(body_angle, F32).reshape(-1)
    body_origin = _t(body_origin, F32).reshape(-1, 2)
    body_type = _t(body_type, torch.int32).reshape(-1)
    n_bodies = body_angle.shape[0]
    has_body = shape_body >= 0
    sb = shape_body.clamp(min=0)

    # accumulate the shapes of dynamic bodies (body.c:152-218)
    stype = torch.where(has_body, body_type[sb] if n_bodies else torch.zeros_like(counts), -1)
    adds = has_body & (stype == 2) & (densities != 0)
    m, c, inertia = _shape_masses(verts[adds], normals[adds], counts[adds], radii[adds], densities[adds])
    sums = _sum_in_shape_order(shape_body[adds], torch.stack([m, m * c[:, 0], m * c[:, 1], inertia], dim=-1),
                               n_bodies)
    mass, lcx, lcy, inertia = sums.unbind(-1)
    pos = mass > 0
    inv_mass = torch.where(pos, torch.ones_like(mass) / mass, 0.0)
    lcx, lcy = torch.where(pos, lcx * inv_mass, lcx), torch.where(pos, lcy * inv_mass, lcy)
    i_c = inertia - mass * (lcx * lcx + lcy * lcy)
    pos_i = i_c > 0
    inertia = torch.where(pos_i, i_c, 0.0)
    inv_inertia = torch.where(pos_i, torch.ones_like(i_c) / i_c, 0.0)

    # world AABBs and fat AABBs (shape.c:48-67)
    rot = math2d.make_rot(body_angle)[sb] if n_bodies else torch.zeros((len(counts), 2))
    origin = body_origin[sb] if n_bodies else torch.zeros((len(counts), 2))
    sn, cs = rot[:, 0:1], rot[:, 1:2]
    vx, vy = verts[..., 0], verts[..., 1]
    wx = cs * vx - sn * vy + origin[:, 0:1]
    wy = sn * vx + cs * vy + origin[:, 1:2]
    live = torch.arange(8)[None] < counts.clamp(min=1)[:, None]
    big = torch.tensor(1e30, dtype=F32)
    r = (radii + _c(float(np.float32(speculative))))
    lo = torch.stack([torch.where(live, wx, big).amin(1), torch.where(live, wy, big).amin(1)], -1) - r[:, None]
    hi = torch.stack([torch.where(live, wx, -big).amax(1), torch.where(live, wy, -big).amax(1)], -1) + r[:, None]
    aabb = torch.where(has_body[:, None], torch.cat([lo, hi], -1), 0.0)
    margin = torch.where(has_body & (stype == 0), _c(0.0), _c(float(np.float32(aabb_margin))))[:, None]
    fat = torch.cat([aabb[:, :2] - margin, aabb[:, 2:] + margin], -1)

    def np32(x):
        return x.to(F32).numpy().copy()

    return dict(
        mass=np32(mass), inv_mass=np32(inv_mass), inertia=np32(inertia), inv_inertia=np32(inv_inertia),
        local_center=np32(torch.stack([lcx, lcy], -1)), aabb=np32(aabb), fat_aabb=np32(fat),
    )


