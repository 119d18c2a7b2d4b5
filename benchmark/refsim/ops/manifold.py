"""The contact manifold's layout: K2's shape table rows (`geom_rows`) and
its lane-major outputs as a per-pair manifold (`from_lanes`). The
narrowphase itself is K2's plain twin (`narrow_lanes.collide_lanes_plain`,
reference: src/manifold.c:509-650).
"""

from __future__ import annotations

from typing import NamedTuple

import torch



class ManifoldOut(NamedTuple):
    """One manifold per pair, the JAX package's fields (`manifold.py:39-48`)."""

    normal: torch.Tensor       # [..., 2] world
    anchor_a: torch.Tensor     # [..., 2, 2] local to body A's origin frame
    anchor_b: torch.Tensor     # [..., 2, 2] local to body B's origin frame
    separation: torch.Tensor   # [..., 2]
    point_id: torch.Tensor     # [..., 2] i32
    point_count: torch.Tensor  # [...] i32
    cache_count: torch.Tensor  # [...] i32, the updated GJK cache
    cache_ia: torch.Tensor     # [..., 3]
    cache_ib: torch.Tensor     # [..., 3]


def from_lanes(fout, iout, cout) -> ManifoldOut:
    """K2's outputs [W, 12|3|7, C] as per-contact fields [W, C, ...]."""
    f = fout.transpose(1, 2)  # [W, C, 12]
    i = iout.transpose(1, 2)
    c = cout.transpose(1, 2)
    return ManifoldOut(
        normal=f[..., 0:2],
        anchor_a=f[..., 2:6].reshape(f.shape[:2] + (2, 2)),
        anchor_b=f[..., 6:10].reshape(f.shape[:2] + (2, 2)),
        separation=f[..., 10:12],
        point_id=i[..., 0:2],
        point_count=i[..., 2],
        cache_count=c[..., 0],
        cache_ia=c[..., 1:4],
        cache_ib=c[..., 4:7],
    )


def geom_rows(verts, normals, count, radius):
    """K2's shape rows [..., 34]: vx, vy, nx, ny (8 each), count, radius."""
    return torch.cat(
        [verts[..., 0], verts[..., 1], normals[..., 0], normals[..., 1],
         count[..., None].to(torch.float32), radius[..., None].to(torch.float32)],
        dim=-1,
    )


