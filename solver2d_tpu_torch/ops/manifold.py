"""The per-pair contact manifold: the JAX package's `ops/manifold.py` API
over the lane-batched narrowphase.

`collide` takes one pair of rounded polygons per element of any leading
batch shape (the JAX function is written for one pair and vmapped), packs
the pairs into K2's lane layout (a shape table with A's rows then B's, one
world of N contact slots) and runs the narrowphase: K2
(`ops/narrow_cuda.collide`, `csrc/narrow.cu`) on CUDA tensors, its plain
twin (`narrow_lanes.collide_lanes_plain`) on CPU tensors. The math is K2's:
GJK with a warm cache, the SAT fallback, clipping and feature ids
(reference: src/manifold.c:509-650).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import narrow_cuda


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


def collide(
    va, na, ca, ra,        # shape A: verts [..., 8, 2], normals [..., 8, 2], count [...], radius [...]
    vb, nb, cb, rb,        # shape B in its own frame
    pa, qa, pb, qb,        # body origin transforms: positions [..., 2], rotations (sin, cos) [..., 2]
    cache_count, cache_ia, cache_ib,  # the GJK cache: [...], [..., 3], [..., 3]
    gjk_iters: int = 20,
) -> ManifoldOut:
    """The contact manifold of each pair of a batch of any leading shape,
    through one launch of K2 (its twin on the CPU)."""
    batch = tuple(ca.shape)
    n = 1
    for d in batch:
        n *= d
    f32, i32 = torch.float32, torch.int32

    def flat(x, tail, dtype):
        return torch.as_tensor(x).to(dtype).reshape((n,) + tail)

    rows_a = geom_rows(flat(va, (8, 2), f32), flat(na, (8, 2), f32), flat(ca, (), i32), flat(ra, (), f32))
    rows_b = geom_rows(flat(vb, (8, 2), f32), flat(nb, (8, 2), f32), flat(cb, (), i32), flat(rb, (), f32))
    geom = torch.cat([rows_a, rows_b]).contiguous()
    dev = geom.device
    sa = torch.arange(n, dtype=i32, device=dev)

    def lanes(*xs):  # [n, k] pieces -> [1, k, n]
        return torch.cat(xs, dim=-1).t()[None].contiguous()

    pose_a = lanes(flat(pa, (2,), f32), flat(qa, (2,), f32))
    pose_b = lanes(flat(pb, (2,), f32), flat(qb, (2,), f32))
    cache = lanes(flat(cache_count, (1,), i32), flat(cache_ia, (3,), i32), flat(cache_ib, (3,), i32))
    out = from_lanes(*narrow_cuda.collide(geom, sa, sa + n, pose_a, pose_b, cache, gjk_iters))
    return ManifoldOut(*(x[0].reshape(batch + tuple(x.shape[2:])) for x in out))
