"""GJK closest distance with a warm-start simplex cache, and the closest
points of two segments.

An own copy of the JAX package's `ops/distance.py` (reference:
src/distance.c:16-636), batched over a leading axis where the JAX function
is one pair under `vmap`: Voronoi-region simplex solves with barycentric
coordinates, support-duplicate termination, and a {count, indexA[3],
indexB[3]} cache. The sequential control flow is a static unroll of
`max_iters` trips with a per-pair "done" mask, as there, so every pair
runs the same operations and the results equal the JAX function's.

Shapes come as padded vertex arrays [..., 8, 2] in one frame (the caller
puts B into A's frame first, as s2CollidePolygons does,
reference: src/manifold.c:515-531).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math2d as m

_EPS = 1.1920929e-07  # FLT_EPSILON
MAX_ITERS = 20
I32 = torch.int32


class GJKOutput(NamedTuple):
    point_a: torch.Tensor        # [..., 2]
    point_b: torch.Tensor        # [..., 2]
    distance: torch.Tensor       # [...]
    cache_count: torch.Tensor    # [...] i32 (simplex vertex count)
    cache_index_a: torch.Tensor  # [..., 3] i32
    cache_index_b: torch.Tensor  # [..., 3] i32
    iterations: torch.Tensor     # [...] i32


def _take(x, idx):
    """Row n of x [N, V(, 2)] at idx [N, K]: [N, K(, 2)]. Negative indices
    wrap and indices past the end clamp, as the JAX package's gathers do."""
    n = x.shape[1]
    idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1).long()
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return torch.gather(x, 1, idx)


def _const(values, like, dtype):
    return torch.tensor(values, dtype=dtype, device=like.device).expand(like.shape[0], -1)


def _vdot(a, b):
    """a . b as the JAX package's `jnp.dot` of two 2-vectors computes it
    under `vmap` on the CPU: a fused multiply-add of the second product
    onto the rounded first, fma(a.y, b.y, a.x * b.x). In float64 the
    product a.y * b.y is exact, and rounding the float64 sum to float32
    gives the fused result unless that sum was itself rounded onto a
    float32 halfway point."""
    p0 = (a[..., 0] * b[..., 0]).double()
    return (p0 + a[..., 1].double() * b[..., 1].double()).to(a.dtype)


def _support(verts, count, d):
    """Index of the support vertex [N] (the first maximum over the real
    vertices; reference: src/distance.c:116-131)."""
    scores = verts[..., 0] * d[:, None, 0] + verts[..., 1] * d[:, None, 1]
    lane = torch.arange(verts.shape[1], device=verts.device)
    scores = torch.where(lane < count[:, None], scores, float("-inf"))
    return torch.argmax(scores, dim=1).to(I32)


def _solve_simplex2(w):
    """Line-segment Voronoi solve (reference: src/distance.c:333-365):
    (perm [N, 3], barycentric a [N, 3], count [N])."""
    w1, w2 = w[:, 0], w[:, 1]
    e12 = w2 - w1
    d12_2 = -_vdot(w1, e12)
    d12_1 = _vdot(w2, e12)
    s = d12_1 + d12_2
    inv = 1.0 / torch.where(s != 0.0, s, 1.0)
    a_edge = torch.stack([d12_1 * inv, d12_2 * inv, torch.zeros_like(s)], dim=-1)
    in_w1 = d12_2 <= 0.0
    in_w2 = ~in_w1 & (d12_1 <= 0.0)
    vertex = (in_w1 | in_w2)[:, None]
    perm = torch.where(in_w2[:, None], _const([1, 1, 2], w, I32), _const([0, 1, 2], w, I32))
    a = torch.where(vertex, _const([1.0, 0.0, 0.0], w, w.dtype), a_edge)
    count = torch.where(vertex[:, 0], 1, 2).to(I32)
    return perm, a, count


# the triangle solve's cases in the reference's priority order: w1, e12,
# e13, w2, w3, e23, interior; each case's vertex permutation and count
_PERMS3 = [[0, 1, 2], [0, 1, 2], [0, 2, 1], [1, 1, 2], [2, 1, 2], [2, 1, 0], [0, 1, 2]]
_COUNTS3 = [1, 2, 2, 1, 1, 2, 3]


def _solve_simplex3(w):
    """Triangle Voronoi solve (reference: src/distance.c:367-474)."""
    w1, w2, w3 = w[:, 0], w[:, 1], w[:, 2]
    e12 = w2 - w1
    d12_1 = _vdot(w2, e12)
    d12_2 = -_vdot(w1, e12)
    e13 = w3 - w1
    d13_1 = _vdot(w3, e13)
    d13_2 = -_vdot(w1, e13)
    e23 = w3 - w2
    d23_1 = _vdot(w3, e23)
    d23_2 = -_vdot(w2, e23)
    n123 = m.cross(e12, e13)
    d123_1 = n123 * m.cross(w2, w3)
    d123_2 = n123 * m.cross(w3, w1)
    d123_3 = n123 * m.cross(w1, w2)

    conds = torch.stack([
        (d12_2 <= 0.0) & (d13_2 <= 0.0),
        (d12_1 > 0.0) & (d12_2 > 0.0) & (d123_3 <= 0.0),
        (d13_1 > 0.0) & (d13_2 > 0.0) & (d123_2 <= 0.0),
        (d12_1 <= 0.0) & (d23_2 <= 0.0),
        (d13_1 <= 0.0) & (d23_1 <= 0.0),
        (d23_1 > 0.0) & (d23_2 > 0.0) & (d123_1 <= 0.0),
        torch.ones_like(d12_1, dtype=torch.bool),
    ], dim=-1)
    case = torch.argmax(conds.to(I32), dim=1)

    def safe_inv(x):
        return 1.0 / torch.where(x != 0.0, x, 1.0)

    zero = torch.zeros_like(d12_1)
    one = torch.ones_like(d12_1)
    a12 = torch.stack([d12_1, d12_2, zero], dim=-1) * safe_inv(d12_1 + d12_2)[:, None]
    a13 = torch.stack([d13_1, d13_2, zero], dim=-1) * safe_inv(d13_1 + d13_2)[:, None]
    # e23 after perm [2, 1]: new v1 = old v3 (a = d23_2), new v2 = old v2
    a23 = torch.stack([d23_2, d23_1, zero], dim=-1) * safe_inv(d23_1 + d23_2)[:, None]
    a123 = torch.stack([d123_1, d123_2, d123_3], dim=-1) * safe_inv(d123_1 + d123_2 + d123_3)[:, None]
    vert = torch.stack([one, zero, zero], dim=-1)
    bary = torch.stack([vert, a12, a13, vert, vert, a23, a123], dim=1)  # [N, 7, 3]
    perms = torch.tensor(_PERMS3, dtype=I32, device=w.device)
    counts = torch.tensor(_COUNTS3, dtype=I32, device=w.device)
    return perms[case], bary[torch.arange(w.shape[0], device=w.device), case], counts[case]


def _search_direction(w, count):
    """(reference: src/distance.c:227-254)"""
    d1 = -w[:, 0]
    e12 = w[:, 1] - w[:, 0]
    sgn = m.cross(e12, -w[:, 0])
    d2 = torch.where((sgn > 0.0)[:, None], m.cross_sv(1.0, e12), m.cross_vs(e12, 1.0))
    return torch.where((count == 1)[:, None], d1, d2)


def _solve(w, count):
    """The simplex solve of a count-1, -2 or -3 simplex: (perm, bary, count)."""
    perm2, a2, cnt2 = _solve_simplex2(w)
    perm3, a3, cnt3 = _solve_simplex3(w)
    c1, c2 = (count == 1)[:, None], (count == 2)[:, None]
    perm = torch.where(c1, _const([0, 1, 2], w, I32), torch.where(c2, perm2, perm3))
    bary = torch.where(c1, _const([1.0, 0.0, 0.0], w, w.dtype), torch.where(c2, a2, a3))
    new_count = torch.where(c1[:, 0], 1, torch.where(c2[:, 0], cnt2, cnt3)).to(I32)
    return perm, bary, new_count


def gjk(verts_a, count_a, verts_b, count_b, cache_count, cache_ia, cache_ib, max_iters: int = MAX_ITERS) -> GJKOutput:
    """GJK of every pair of a batch in a common frame.

    verts_a, verts_b [..., 8, 2] padded; count_a, count_b [...]; the
    warm-start cache: cache_count [...], cache_ia, cache_ib [..., 3].
    max_iters: the support-call budget (the reference's 20,
    distance.c:504)."""
    lead = count_a.shape
    n = count_a.numel()
    va = verts_a.reshape(n, -1, 2)
    vb = verts_b.reshape(n, -1, 2)
    ca, cb = count_a.reshape(n), count_b.reshape(n)
    cc = cache_count.reshape(n)
    lanes = torch.arange(3, device=va.device)

    # the simplex from the cache (reference: src/distance.c:172-213)
    use_cache = cc > 0
    ia = torch.where(use_cache[:, None], cache_ia.reshape(n, 3), 0).to(I32)
    ib = torch.where(use_cache[:, None], cache_ib.reshape(n, 3), 0).to(I32)
    count = torch.where(use_cache, cc, 1).to(I32)
    wa, wb = _take(va, ia), _take(vb, ib)
    w = wb - wa
    bary = _const([1.0, 0.0, 0.0], va, va.dtype)
    done = torch.zeros(n, dtype=torch.bool, device=va.device)
    iters = torch.zeros(n, dtype=I32, device=va.device)

    for _ in range(max_iters):
        save_ia, save_ib, save_count = ia, ib, count
        perm, new_a, new_count = _solve(w, count)
        d3, d2 = done[:, None, None], done[:, None]
        wa = torch.where(d3, wa, _take(wa, perm))
        wb = torch.where(d3, wb, _take(wb, perm))
        w = torch.where(d3, w, _take(w, perm))
        ia = torch.where(d2, ia, _take(ia, perm))
        ib = torch.where(d2, ib, _take(ib, perm))
        bary = torch.where(d2, bary, new_a)
        count = torch.where(done, count, new_count)

        # a triangle holds the origin
        done = done | (count == 3)
        d = _search_direction(w, count)
        done = done | (_vdot(d, d) < _EPS * _EPS)

        sia = _support(va, ca, -d)
        sib = _support(vb, cb, d)
        dup = ((sia[:, None] == save_ia) & (sib[:, None] == save_ib) & (lanes < save_count[:, None])).any(dim=1)
        iters = torch.where(done, iters, iters + 1)
        done = done | dup

        new_wa = _take(va, sia[:, None])
        new_wb = _take(vb, sib[:, None])
        app = ~done
        lane_hit = app[:, None] & (lanes == count[:, None])
        lh = lane_hit[..., None]
        wa = torch.where(lh, new_wa, wa)
        wb = torch.where(lh, new_wb, wb)
        w = torch.where(lh, new_wb - new_wa, w)
        ia = torch.where(lane_hit, sia[:, None], ia)
        ib = torch.where(lane_hit, sib[:, None], ib)
        count = torch.where(app, count + 1, count).to(I32)

    # the final solve: a trip budget spent right after an append leaves the
    # last vertex without a weight; re-solving a solved simplex is idempotent
    perm, bary, count = _solve(w, count)
    wa, wb = _take(wa, perm), _take(wb, perm)
    ia, ib = _take(ia, perm), _take(ib, perm)

    mask = (lanes < count[:, None])[..., None]
    bwa = bary[..., None] * wa
    bwa_m = bwa * mask
    bwb_m = bary[..., None] * wb * mask
    three = (count == 3)[:, None]
    point_a = torch.where(three, bwa[:, 0] + bwa[:, 1] + bwa[:, 2], bwa_m[:, 0] + bwa_m[:, 1] + bwa_m[:, 2])
    # reference: src/distance.c:297-302 takes a's point for both at count 3
    point_b = torch.where(three, point_a, bwb_m[:, 0] + bwb_m[:, 1] + bwb_m[:, 2])
    distance = m.length(point_b - point_a)
    return GJKOutput(
        point_a.reshape(lead + (2,)), point_b.reshape(lead + (2,)), distance.reshape(lead),
        count.reshape(lead), ia.reshape(lead + (3,)), ib.reshape(lead + (3,)), iters.reshape(lead),
    )


def segment_distance(p1, q1, p2, q2):
    """Closest points of two segments (reference: src/distance.c:16-89).
    Returns (closest1, closest2, fraction1, fraction2, distance_squared)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    dd1 = m.dot(d1, d1)
    dd2 = m.dot(d2, d2)
    rd1 = m.dot(r, d1)
    rd2 = m.dot(r, d2)
    eps_sqr = _EPS * _EPS

    def clamp01(x):
        return torch.clamp(x, 0.0, 1.0)

    safe1 = torch.where(dd1 != 0, dd1, 1.0)
    safe2 = torch.where(dd2 != 0, dd2, 1.0)
    # degenerate cases
    f1_deg1 = clamp01(-rd1 / safe1)
    f2_deg2 = clamp01(rd2 / safe2)

    d12 = m.dot(d1, d2)
    denom = dd1 * dd2 - d12 * d12
    f1 = torch.where(denom != 0.0, clamp01((d12 * rd2 - rd1 * dd2) / torch.where(denom != 0.0, denom, 1.0)), 0.0)
    f2 = (d12 * f1 + rd2) / safe2
    # clamping f2 requires a redo on f1
    f1 = torch.where(f2 < 0.0, clamp01(-rd1 / safe1), torch.where(f2 > 1.0, clamp01((d12 - rd1) / safe1), f1))
    f2 = clamp01(f2)

    both_deg = (dd1 < eps_sqr) & (dd2 < eps_sqr)
    deg1 = (dd2 < eps_sqr) & ~both_deg  # segment 2 degenerate
    deg2 = (dd1 < eps_sqr) & ~both_deg  # segment 1 degenerate
    fraction1 = torch.where(both_deg, 0.0, torch.where(deg1, f1_deg1, torch.where(deg2, 0.0, f1)))
    fraction2 = torch.where(both_deg, 0.0, torch.where(deg1, 0.0, torch.where(deg2, f2_deg2, f2)))

    c1 = p1 + fraction1[..., None] * d1
    c2 = p2 + fraction2[..., None] * d2
    return c1, c2, fraction1, fraction2, m.dot(c2 - c1, c2 - c1)
