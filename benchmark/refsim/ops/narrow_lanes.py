"""Lane-major narrowphase, the plain PyTorch twin of kernel K2.

Port of the JAX package's `ops/narrow_lanes.py:collide_lanes`: GJK with a
warm-start simplex cache (reference: src/distance.c:91-636), SAT max
separation, reference/incident clipping and the circle paths
(src/manifold.c:16-650), over tensors whose dim 0 is the row axis (8 vertex
rows or 1 scalar row) and whose other dims broadcast: shared geometry
[rows, 1, C] meets per-world poses [1, W, C]. Every argmax and gather is a
running compare-select over rows (first index wins a tie), in the same
operation order as the JAX function; `csrc/narrow.cu` repeats that order
per thread, so the two agree bit for bit on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import LINEAR_SLOP, SPECULATIVE_DISTANCE
from . import math2d as m

_EPS = 1.1920929e-07
_BIG = 1e30
I32 = torch.int32


def _rows_iota(x):
    return torch.arange(x.shape[0], dtype=I32, device=x.device).reshape((-1,) + (1,) * (x.dim() - 1))


def _pick(v, idx):
    """v [R, ...]; idx [1, ...] in [0, R) -> [1, ...] (row select)."""
    out = v[0:1]
    for j in range(1, v.shape[0]):
        out = torch.where(idx == j, v[j:j + 1], out)
    return out


def _pick3(vals, idx):
    return torch.where(idx == 2, vals[2], torch.where(idx == 1, vals[1], vals[0]))


def _sel_case(case, vals):
    out = vals[-1]
    for c in range(len(vals) - 2, -1, -1):
        out = torch.where(case == c, vals[c], out)
    return out


def _const_by_case(case, table):
    out = torch.full_like(case, table[-1])
    for c in range(len(table) - 2, -1, -1):
        out = torch.where(case == c, table[c], out)
    return out


def _normalize2(x, y, eps=1e-12):
    l = m.sqrt(x * x + y * y)
    inv = torch.where(l > eps, 1.0 / torch.clamp(l, min=eps), 0.0)
    return x * inv, y * inv, l


def _argmax_rows(score, count, limit_count=True):
    """Running (first max, value) over rows of score [8, ...], rows masked
    to < count."""
    if limit_count:
        score = torch.where(_rows_iota(score) < count, score, -_BIG)
    best_i = torch.zeros_like(score[0:1], dtype=I32)
    best_s = score[0:1]
    for j in range(1, score.shape[0]):
        t = score[j:j + 1] > best_s
        best_i = torch.where(t, j, best_i)
        best_s = torch.where(t, score[j:j + 1], best_s)
    return best_i, best_s


def _argmin_rows(score, count):
    idx, val = _argmax_rows(-torch.where(_rows_iota(score) < count, score, _BIG), count, limit_count=False)
    return idx, -val


def _support(vx, vy, count, dx, dy):
    """First-max support index (reference: src/distance.c:116-131)."""
    score = vx * dx + vy * dy
    score = torch.where(_rows_iota(score) < count, score, -float("inf"))
    idx, _ = _argmax_rows(score, count, limit_count=False)
    return idx


class GJKLanes(NamedTuple):
    pax: torch.Tensor
    pay: torch.Tensor
    pbx: torch.Tensor
    pby: torch.Tensor
    distance: torch.Tensor
    count: torch.Tensor
    ia: tuple
    ib: tuple


def _solve_simplex2(w0x, w0y, w1x, w1y):
    """reference: src/distance.c:333-365"""
    e12x, e12y = w1x - w0x, w1y - w0y
    d12_2 = -(w0x * e12x + w0y * e12y)
    d12_1 = w1x * e12x + w1y * e12y
    s = d12_1 + d12_2
    inv = 1.0 / torch.where(s != 0.0, s, 1.0)

    in_w1 = d12_2 <= 0.0
    in_w2 = (~in_w1) & (d12_1 <= 0.0)
    vertex = in_w1 | in_w2

    zero_i = torch.zeros_like(w0x, dtype=I32)
    perm = (torch.where(in_w2, 1, zero_i), zero_i + 1, zero_i + 2)
    a = (
        torch.where(vertex, 1.0, d12_1 * inv),
        torch.where(vertex, 0.0, d12_2 * inv),
        torch.zeros_like(w0x),
    )
    count = torch.where(vertex, 1, 2).to(I32)
    return perm, a, count


def _solve_simplex3(w0x, w0y, w1x, w1y, w2x, w2y):
    """reference: src/distance.c:367-474"""
    e12x, e12y = w1x - w0x, w1y - w0y
    d12_1 = w1x * e12x + w1y * e12y
    d12_2 = -(w0x * e12x + w0y * e12y)
    e13x, e13y = w2x - w0x, w2y - w0y
    d13_1 = w2x * e13x + w2y * e13y
    d13_2 = -(w0x * e13x + w0y * e13y)
    e23x, e23y = w2x - w1x, w2y - w1y
    d23_1 = w2x * e23x + w2y * e23y
    d23_2 = -(w1x * e23x + w1y * e23y)
    n123 = e12x * e13y - e12y * e13x
    d123_1 = n123 * (w1x * w2y - w1y * w2x)
    d123_2 = n123 * (w2x * w0y - w2y * w0x)
    d123_3 = n123 * (w0x * w1y - w0y * w1x)

    c_w1 = (d12_2 <= 0.0) & (d13_2 <= 0.0)
    c_e12 = (d12_1 > 0.0) & (d12_2 > 0.0) & (d123_3 <= 0.0)
    c_e13 = (d13_1 > 0.0) & (d13_2 > 0.0) & (d123_2 <= 0.0)
    c_w2 = (d12_1 <= 0.0) & (d23_2 <= 0.0)
    c_w3 = (d13_1 <= 0.0) & (d23_1 <= 0.0)
    c_e23 = (d23_1 > 0.0) & (d23_2 > 0.0) & (d123_1 <= 0.0)

    # case 0 w1, 1 e12, 2 e13, 3 w2, 4 w3, 5 e23, 6 interior (priority order)
    case = torch.full_like(d12_1, 6, dtype=I32)
    for c, cond in reversed(list(enumerate([c_w1, c_e12, c_e13, c_w2, c_w3, c_e23]))):
        case = torch.where(cond, c, case)

    def safe_inv(x):
        return 1.0 / torch.where(x != 0.0, x, 1.0)

    i12 = safe_inv(d12_1 + d12_2)
    i13 = safe_inv(d13_1 + d13_2)
    i23 = safe_inv(d23_1 + d23_2)
    i123 = safe_inv(d123_1 + d123_2 + d123_3)

    one = torch.ones_like(d12_1)
    zero = torch.zeros_like(d12_1)
    bary0 = _sel_case(case, [one, d12_1 * i12, d13_1 * i13, one, one, d23_2 * i23, d123_1 * i123])
    bary1 = _sel_case(case, [zero, d12_2 * i12, d13_2 * i13, zero, zero, d23_1 * i23, d123_2 * i123])
    bary2 = _sel_case(case, [zero, zero, zero, zero, zero, zero, d123_3 * i123])

    perm0 = _const_by_case(case, [0, 0, 0, 1, 2, 2, 0])
    perm1 = _const_by_case(case, [1, 1, 2, 1, 1, 1, 1])
    perm2 = _const_by_case(case, [2, 2, 1, 2, 2, 0, 2])
    count = _const_by_case(case, [1, 2, 2, 1, 1, 2, 3])
    return (perm0, perm1, perm2), (bary0, bary1, bary2), count


def gjk_lanes(vax, vay, ca, vbx, vby, cb, cache_count, ia_in, ib_in, max_iters: int) -> GJKLanes:
    """Lane-major GJK with `max_iters` fixed trips (finished lanes are
    masked). vax/vay/vbx/vby: [8, ...]; ca/cb/cache_count: [1, ...] i32;
    ia_in/ib_in: 3-tuples of [1, ...] i32."""
    use = cache_count > 0
    zero_i = torch.zeros_like(ca)
    ia = [torch.where(use, ia_in[i], zero_i) for i in range(3)]
    ib = [torch.where(use, ib_in[i], zero_i) for i in range(3)]
    count = torch.where(use, cache_count, 1).to(I32)
    wax = [_pick(vax, ia[i]) for i in range(3)]
    way = [_pick(vay, ia[i]) for i in range(3)]
    wbx = [_pick(vbx, ib[i]) for i in range(3)]
    wby = [_pick(vby, ib[i]) for i in range(3)]
    bary = [torch.ones_like(vax[0:1]), torch.zeros_like(vax[0:1]), torch.zeros_like(vax[0:1])]
    done = torch.zeros_like(use)

    def solve(wax, way, wbx, wby, ia, ib, count):
        wx = [wbx[i] - wax[i] for i in range(3)]
        wy = [wby[i] - way[i] for i in range(3)]
        perm2, a2, cnt2 = _solve_simplex2(wx[0], wy[0], wx[1], wy[1])
        perm3, a3, cnt3 = _solve_simplex3(wx[0], wy[0], wx[1], wy[1], wx[2], wy[2])
        is1 = count == 1
        is2 = count == 2
        perm = [torch.where(is1, i, torch.where(is2, perm2[i], perm3[i])) for i in range(3)]
        one0 = [torch.ones_like(a2[0]), torch.zeros_like(a2[0]), torch.zeros_like(a2[0])]
        newa = [torch.where(is1, one0[i], torch.where(is2, a2[i], a3[i])) for i in range(3)]
        newc = torch.where(is1, 1, torch.where(is2, cnt2, cnt3)).to(I32)
        pwax = [_pick3(wax, perm[i]) for i in range(3)]
        pway = [_pick3(way, perm[i]) for i in range(3)]
        pwbx = [_pick3(wbx, perm[i]) for i in range(3)]
        pwby = [_pick3(wby, perm[i]) for i in range(3)]
        pia = [_pick3(ia, perm[i]) for i in range(3)]
        pib = [_pick3(ib, perm[i]) for i in range(3)]
        return pwax, pway, pwbx, pwby, pia, pib, newa, newc

    for _ in range(max_iters):
        save_ia, save_ib, save_count = ia, ib, count
        pwax, pway, pwbx, pwby, pia, pib, newa, newc = solve(wax, way, wbx, wby, ia, ib, count)
        nd = ~done
        wax = [torch.where(nd, pwax[i], wax[i]) for i in range(3)]
        way = [torch.where(nd, pway[i], way[i]) for i in range(3)]
        wbx = [torch.where(nd, pwbx[i], wbx[i]) for i in range(3)]
        wby = [torch.where(nd, pwby[i], wby[i]) for i in range(3)]
        ia = [torch.where(nd, pia[i], ia[i]) for i in range(3)]
        ib = [torch.where(nd, pib[i], ib[i]) for i in range(3)]
        bary = [torch.where(nd, newa[i], bary[i]) for i in range(3)]
        count = torch.where(nd, newc, count)

        done = done | (count == 3)

        # search direction (reference: src/distance.c:227-254)
        w0x, w0y = wbx[0] - wax[0], wby[0] - way[0]
        w1x, w1y = wbx[1] - wax[1], wby[1] - way[1]
        e12x, e12y = w1x - w0x, w1y - w0y
        sgn = e12x * (-w0y) - e12y * (-w0x)
        d2x = torch.where(sgn > 0.0, -e12y, e12y)
        d2y = torch.where(sgn > 0.0, e12x, -e12x)
        dx = torch.where(count == 1, -w0x, d2x)
        dy = torch.where(count == 1, -w0y, d2y)
        done = done | (dx * dx + dy * dy < _EPS * _EPS)

        sia = _support(vax, vay, ca, -dx, -dy)
        sib = _support(vbx, vby, cb, dx, dy)
        dup = torch.zeros_like(done)
        for i in range(3):
            dup = dup | ((sia == save_ia[i]) & (sib == save_ib[i]) & (i < save_count))
        done = done | dup

        app = ~done
        new_wax, new_way = _pick(vax, sia), _pick(vay, sia)
        new_wbx, new_wby = _pick(vbx, sib), _pick(vby, sib)
        for i in range(3):
            hit = app & (count == i)
            wax[i] = torch.where(hit, new_wax, wax[i])
            way[i] = torch.where(hit, new_way, way[i])
            wbx[i] = torch.where(hit, new_wbx, wbx[i])
            wby[i] = torch.where(hit, new_wby, wby[i])
            ia[i] = torch.where(hit, sia, ia[i])
            ib[i] = torch.where(hit, sib, ib[i])
        count = torch.where(app, count + 1, count)

    # final solve: idempotent on a solved simplex; needed when the budget
    # ran out right after an append
    wax, way, wbx, wby, ia, ib, bary, count = solve(wax, way, wbx, wby, ia, ib, count)

    pax = torch.zeros_like(wax[0])
    pay = torch.zeros_like(pax)
    pbx = torch.zeros_like(pax)
    pby = torch.zeros_like(pax)
    for i in range(3):
        mask = (i < count).to(torch.float32)
        pax = pax + bary[i] * wax[i] * mask
        pay = pay + bary[i] * way[i] * mask
        pbx = pbx + bary[i] * wbx[i] * mask
        pby = pby + bary[i] * wby[i] * mask
    # count 3: interior, both points are point A (distance.c:297-302)
    pbx = torch.where(count == 3, pax, pbx)
    pby = torch.where(count == 3, pay, pby)
    distance = m.sqrt((pbx - pax) ** 2 + (pby - pay) ** 2)
    return GJKLanes(pax, pay, pbx, pby, distance, count, tuple(ia), tuple(ib))


def _find_max_sep(v1x, v1y, n1x, n1y, c1, v2x, v2y, c2):
    """reference: src/manifold.c:402-438"""
    rowdot = n1x * v1x + n1y * v1y
    best = None
    for j in range(8):
        sj = n1x * v2x[j:j + 1] + n1y * v2y[j:j + 1] - rowdot
        sj = torch.where(j < c2, sj, _BIG)
        best = sj if best is None else torch.minimum(best, sj)
    idx, val = _argmax_rows(best, c1)
    return val, idx


def _incident_edge(sdx, sdy, nx, ny, count):
    """Most anti-parallel edge (reference: src/manifold.c:456-489)."""
    idx, _ = _argmin_rows(nx * sdx + ny * sdy, count)
    return idx


def _clip_polygons(vax, vay, nax, nay, ca, ra, vbx, vby, nbx, nby, cb, rb, edge_a, edge_b, flip):
    """reference: src/manifold.c:248-399"""
    i11 = torch.where(flip, edge_b, edge_a)
    cnt1 = torch.where(flip, cb, ca)
    i12 = torch.where(i11 + 1 < cnt1, i11 + 1, 0)
    i21 = torch.where(flip, edge_a, edge_b)
    cnt2 = torch.where(flip, ca, cb)
    i22 = torch.where(i21 + 1 < cnt2, i21 + 1, 0)

    def pick_ab(xb, xa, idx):
        return torch.where(flip, _pick(xb, idx), _pick(xa, idx))

    nx = pick_ab(nbx, nax, i11)
    ny = pick_ab(nby, nay, i11)
    v11x, v11y = pick_ab(vbx, vax, i11), pick_ab(vby, vay, i11)
    v12x, v12y = pick_ab(vbx, vax, i12), pick_ab(vby, vay, i12)
    v21x, v21y = pick_ab(vax, vbx, i21), pick_ab(vay, vby, i21)
    v22x, v22y = pick_ab(vax, vbx, i22), pick_ab(vay, vby, i22)
    r1 = torch.where(flip, rb, ra)
    r2 = torch.where(flip, ra, rb)

    tx, ty = -ny, nx
    lower1 = torch.zeros_like(nx)
    upper1 = (v12x - v11x) * tx + (v12y - v11y) * ty
    upper2 = (v21x - v11x) * tx + (v21y - v11y) * ty
    lower2 = (v22x - v11x) * tx + (v22y - v11y) * ty
    d21 = upper2 - lower2

    safe_d21 = torch.where(d21 != 0.0, d21, 1.0)
    frac_l = (lower1 - lower2) / safe_d21
    cl = (lower2 < lower1) & (d21 > _EPS)
    v_lx = torch.where(cl, v22x + frac_l * (v21x - v22x), v22x)
    v_ly = torch.where(cl, v22y + frac_l * (v21y - v22y), v22y)
    frac_u = (upper1 - lower2) / safe_d21
    cu = (upper2 > upper1) & (d21 > _EPS)
    v_ux = torch.where(cu, v22x + frac_u * (v21x - v22x), v21x)
    v_uy = torch.where(cu, v22y + frac_u * (v21y - v22y), v21y)

    sep_l = (v_lx - v11x) * nx + (v_ly - v11y) * ny
    sep_u = (v_ux - v11x) * nx + (v_uy - v11y) * ny

    # midpoints accounting for radii (manifold.c:335-337)
    v_lx = v_lx + 0.5 * (r1 - r2 - sep_l) * nx
    v_ly = v_ly + 0.5 * (r1 - r2 - sep_l) * ny
    v_ux = v_ux + 0.5 * (r1 - r2 - sep_u) * nx
    v_uy = v_uy + 0.5 * (r1 - r2 - sep_u) * ny
    radius = r1 + r2

    p0x = torch.where(flip, v_ux, v_lx)
    p0y = torch.where(flip, v_uy, v_ly)
    p1x = torch.where(flip, v_lx, v_ux)
    p1y = torch.where(flip, v_ly, v_uy)
    s0 = torch.where(flip, sep_u, sep_l) - radius
    s1 = torch.where(flip, sep_l, sep_u) - radius

    def mk_id(a, b):
        return (a << 8) | b

    id0 = torch.where(flip, mk_id(i21, i12), mk_id(i11, i22))
    id1 = torch.where(flip, mk_id(i22, i11), mk_id(i12, i21))
    onx = torch.where(flip, -nx, nx)
    ony = torch.where(flip, -ny, ny)
    return onx, ony, (p0x, p0y, p1x, p1y), (s0, s1), (id0, id1)


class ManifoldLanes(NamedTuple):
    normal_x: torch.Tensor
    normal_y: torch.Tensor
    a0x: torch.Tensor
    a0y: torch.Tensor
    a1x: torch.Tensor
    a1y: torch.Tensor
    b0x: torch.Tensor
    b0y: torch.Tensor
    b1x: torch.Tensor
    b1y: torch.Tensor
    sep0: torch.Tensor
    sep1: torch.Tensor
    pid0: torch.Tensor
    pid1: torch.Tensor
    count: torch.Tensor
    cache_count: torch.Tensor
    ia: tuple
    ib: tuple


def collide_lanes(
    vax, vay, nax, nay, ca, ra,
    vbx, vby, nbx, nby, cb, rb,
    pax_t, pay_t, qas, qac, pbx_t, pby_t, qbs, qbc,
    cache_count, ia_in, ib_in,
    gjk_iters: int,
) -> ManifoldLanes:
    """Unified narrowphase of two rounded convex polygons, lane-major.
    v*/n*: [8, ...]; every other argument [1, ...]."""
    # B into A's frame (reference: src/manifold.c:515-525)
    xqs = qac * qbs - qas * qbc
    xqc = qac * qbc + qas * qbs
    dxp, dyp = pbx_t - pax_t, pby_t - pay_t
    xpx = qac * dxp + qas * dyp
    xpy = -qas * dxp + qac * dyp
    vblx = xpx + (xqc * vbx - xqs * vby)
    vbly = xpy + (xqs * vbx + xqc * vby)
    nblx = xqc * nbx - xqs * nby
    nbly = xqs * nbx + xqc * nby

    radius = ra + rb
    is_circle_a = ca == 1
    is_circle_b = cb == 1

    out = gjk_lanes(vax, vay, ca, vblx, vbly, cb, cache_count, ia_in, ib_in, gjk_iters)
    dist = out.distance

    # circle-circle (manifold.c:16-48)
    pAx, pAy = vax[0:1], vay[0:1]
    pBx, pBy = vblx[0:1], vbly[0:1]
    n_ccx, n_ccy, d_cc = _normalize2(pBx - pAx, pBy - pAy)
    sep_cc = d_cc - radius
    cAx, cAy = pAx + ra * n_ccx, pAy + ra * n_ccy
    cBx, cBy = pBx - rb * n_ccx, pBy - rb * n_ccy
    mid_ccx, mid_ccy = 0.5 * (cAx + cBx), 0.5 * (cAy + cBy)

    # polygon-circle (manifold.c:113-222)
    flip_pc = is_circle_a
    vpx = torch.where(flip_pc, vblx, vax)
    vpy = torch.where(flip_pc, vbly, vay)
    npx = torch.where(flip_pc, nblx, nax)
    npy = torch.where(flip_pc, nbly, nay)
    cp = torch.where(flip_pc, cb, ca)
    rp = torch.where(flip_pc, rb, ra)
    rc = torch.where(flip_pc, ra, rb)
    ccx = torch.where(flip_pc, vax[0:1], vblx[0:1])
    ccy = torch.where(flip_pc, vay[0:1], vbly[0:1])

    seps = (ccx - vpx) * npx + (ccy - vpy) * npy
    norm_idx, sep_pc0 = _argmax_rows(seps, cp)

    i1 = norm_idx
    i2 = torch.where(i1 + 1 < cp, i1 + 1, 0)
    v1x, v1y = _pick(vpx, i1), _pick(vpy, i1)
    v2x, v2y = _pick(vpx, i2), _pick(vpy, i2)
    u1 = (ccx - v1x) * (v2x - v1x) + (ccy - v1y) * (v2y - v1y)
    u2 = (ccx - v2x) * (v1x - v2x) + (ccy - v2y) * (v1y - v2y)

    nv1x, nv1y, _ = _normalize2(ccx - v1x, ccy - v1y)
    nv2x, nv2y, _ = _normalize2(ccx - v2x, ccy - v2y)
    sep_v1 = (ccx - v1x) * nv1x + (ccy - v1y) * nv1y
    sep_v2 = (ccx - v2x) * nv2x + (ccy - v2y) * nv2y

    case_v1 = (u1 < 0.0) & (sep_pc0 > _EPS)
    case_v2 = (u2 < 0.0) & (sep_pc0 > _EPS) & ~case_v1

    nfx, nfy = _pick(npx, norm_idx), _pick(npy, norm_idx)
    n_pcx = torch.where(case_v1, nv1x, torch.where(case_v2, nv2x, nfx))
    n_pcy = torch.where(case_v1, nv1y, torch.where(case_v2, nv2y, nfy))
    sep_pc = torch.where(case_v1, sep_v1, torch.where(case_v2, sep_v2, sep_pc0))
    v_nx = torch.where(case_v1, v1x, torch.where(case_v2, v2x, v1x))
    v_ny = torch.where(case_v1, v1y, torch.where(case_v2, v2y, v1y))

    proj = (ccx - v1x) * nfx + (ccy - v1y) * nfy
    cA_fx = ccx + (rp - proj) * nfx
    cA_fy = ccy + (rp - proj) * nfy
    cA_vx = v_nx + rp * n_pcx
    cA_vy = v_ny + rp * n_pcy
    is_vert = case_v1 | case_v2
    cA_px = torch.where(is_vert, cA_vx, cA_fx)
    cA_py = torch.where(is_vert, cA_vy, cA_fy)
    cB_px = ccx - rc * n_pcx
    cB_py = ccy - rc * n_pcy
    mid_pcx, mid_pcy = 0.5 * (cA_px + cB_px), 0.5 * (cA_py + cB_py)
    sep_out_pc = torch.where(
        is_vert, (cB_px - cA_px) * n_pcx + (cB_py - cA_py) * n_pcy, sep_pc - radius
    )
    n_pc_ax = torch.where(flip_pc, -n_pcx, n_pcx)
    n_pc_ay = torch.where(flip_pc, -n_pcy, n_pcy)

    # polygon-polygon: SAT fallback (manifold.c:441-493)
    sepA, edgeA_s = _find_max_sep(vax, vay, nax, nay, ca, vblx, vbly, cb)
    sepB, edgeB_s = _find_max_sep(vblx, vbly, nblx, nbly, cb, vax, vay, ca)
    flip_sat = sepB > sepA
    inc_a = _incident_edge(_pick(nblx, edgeB_s), _pick(nbly, edgeB_s), nax, nay, ca)
    inc_b = _incident_edge(_pick(nax, edgeA_s), _pick(nay, edgeA_s), nblx, nbly, cb)
    edgeA_sat = torch.where(flip_sat, inc_a, edgeA_s)
    edgeB_sat = torch.where(flip_sat, edgeB_s, inc_b)
    n_satx, n_saty, a_sat, s_sat, id_sat = _clip_polygons(
        vax, vay, nax, nay, ca, ra, vblx, vbly, nblx, nbly, cb, rb, edgeA_sat, edgeB_sat, flip_sat
    )

    # vertex-vertex (cache count 1, manifold.c:559-577)
    n_vvx, n_vvy, _ = _normalize2(out.pbx - out.pax, out.pby - out.pay)
    mid_vvx = out.pbx + 0.5 * (ra - rb - dist) * n_vvx
    mid_vvy = out.pby + 0.5 * (ra - rb - dist) * n_vvy
    sep_vv = dist - radius
    id_vv = (out.ia[0] << 8) | out.ib[0]

    # edge-vertex via the GJK features (manifold.c:580-637)
    a1, a2 = out.ia[0], out.ia[1]
    b1, b2 = out.ib[0], out.ib[1]
    one_on_a = a1 == a2

    axbx, axby = out.pax - out.pbx, out.pay - out.pby
    dot_b1 = axbx * _pick(nblx, b1) + axby * _pick(nbly, b1)
    dot_b2 = axbx * _pick(nblx, b2) + axby * _pick(nbly, b2)
    edge_b_ref = torch.where(dot_b1 > dot_b2, b1, b2)
    rbx_ax = _pick(nblx, edge_b_ref)
    rby_ax = _pick(nbly, edge_b_ref)
    ea1 = a1
    ea2 = torch.where(ea1 == 0, ca - 1, ea1 - 1)
    da1 = rbx_ax * _pick(nax, ea1) + rby_ax * _pick(nay, ea1)
    da2 = rbx_ax * _pick(nax, ea2) + rby_ax * _pick(nay, ea2)
    edge_a_inc = torch.where(da1 < da2, ea1, ea2)

    axax, axay = out.pbx - out.pax, out.pby - out.pay
    dot_a1 = axax * _pick(nax, a1) + axay * _pick(nay, a1)
    dot_a2 = axax * _pick(nax, a2) + axay * _pick(nay, a2)
    edge_a_ref = torch.where(dot_a1 > dot_a2, a1, a2)
    rax_ax = _pick(nax, edge_a_ref)
    ray_ax = _pick(nay, edge_a_ref)
    eb1 = b1
    eb2 = torch.where(eb1 == 0, cb - 1, eb1 - 1)
    db1 = rax_ax * _pick(nblx, eb1) + ray_ax * _pick(nbly, eb1)
    db2 = rax_ax * _pick(nblx, eb2) + ray_ax * _pick(nbly, eb2)
    edge_b_inc = torch.where(db1 < db2, eb1, eb2)

    edge_a_clip = torch.where(one_on_a, edge_a_inc, edge_a_ref)
    edge_b_clip = torch.where(one_on_a, edge_b_ref, edge_b_inc)
    n_clx, n_cly, a_clip, s_clip, id_clip = _clip_polygons(
        vax, vay, nax, nay, ca, ra, vblx, vbly, nblx, nbly, cb, rb, edge_a_clip, edge_b_clip, one_on_a
    )

    # select the path (mirrors manifold.collide)
    circle_pair = is_circle_a & is_circle_b
    circle_one = is_circle_a ^ is_circle_b
    poly_pair = ~(circle_pair | circle_one)

    use_sat = poly_pair & (dist < 0.1 * LINEAR_SLOP)
    use_vv = poly_pair & ~use_sat & (out.count == 1)
    use_clip = poly_pair & ~use_sat & ~use_vv

    def by_path(cc, pc, sat, vv, clip):
        return torch.where(
            circle_pair, cc,
            torch.where(circle_one, pc, torch.where(use_sat, sat, torch.where(use_vv, vv, clip))),
        )

    normal_lx = by_path(n_ccx, n_pc_ax, n_satx, n_vvx, n_clx)
    normal_ly = by_path(n_ccy, n_pc_ay, n_saty, n_vvy, n_cly)
    a0x = by_path(mid_ccx, mid_pcx, a_sat[0], mid_vvx, a_clip[0])
    a0y = by_path(mid_ccy, mid_pcy, a_sat[1], mid_vvy, a_clip[1])
    a1x = torch.where(use_sat, a_sat[2], a_clip[2])
    a1y = torch.where(use_sat, a_sat[3], a_clip[3])
    sep0 = by_path(sep_cc, sep_out_pc, s_sat[0], sep_vv, s_clip[0])
    sep1 = torch.where(use_sat, s_sat[1], s_clip[1])
    zero_i = torch.zeros_like(ca)
    pid0 = torch.where(use_sat, id_sat[0], torch.where(use_clip, id_clip[0], torch.where(use_vv, id_vv, zero_i)))
    pid1 = torch.where(use_sat, id_sat[1], id_clip[1])

    two_points = use_sat | use_clip
    any_circle = circle_pair | circle_one
    cull0 = (any_circle & (sep0 > SPECULATIVE_DISTANCE)) | (
        (~any_circle) & (dist > radius + SPECULATIVE_DISTANCE)
    )
    count = torch.where(cull0, 0, torch.where(two_points, 2, 1)).to(I32)

    # local anchor B = inv_rotate(xq, anchorA - xp) (manifold.c:552, :645)
    def to_b(ax, ay):
        rx, ry = ax - xpx, ay - xpy
        return xqc * rx + xqs * ry, -xqs * rx + xqc * ry

    b0x, b0y = to_b(a0x, a0y)
    b1x, b1y = to_b(a1x, a1y)

    # normal to world: rotate(qa, n)
    nwx = qac * normal_lx - qas * normal_ly
    nwy = qas * normal_lx + qac * normal_ly

    return ManifoldLanes(
        normal_x=nwx, normal_y=nwy,
        a0x=a0x, a0y=a0y, a1x=a1x, a1y=a1y,
        b0x=b0x, b0y=b0y, b1x=b1x, b1y=b1y,
        sep0=sep0, sep1=sep1,
        pid0=pid0, pid1=pid1, count=count,
        cache_count=out.count, ia=out.ia, ib=out.ib,
    )


def collide_lanes_plain(geom, sa, sb, pa, pb, cache, gjk_iters: int):
    """The plain version of K2, same contract as `ops.narrow_cuda.collide`.

    geom [S, 34] f32: per shape vx(8) vy(8) nx(8) ny(8) count radius;
    sa, sb [C] i32: the shapes of each contact (shared by all worlds);
    pa, pb [W, 4, C] f32: endpoint body poses (px, py, sin, cos);
    cache [W, 7, C] i32: GJK cache (count, ia0..2, ib0..2).
    Returns fout [W, 12, C] f32 (normal, anchor A p0 p1, anchor B p0 p1,
    separations), iout [W, 3, C] i32 (point ids, point count) and
    cout [W, 7, C] i32 (the next GJK cache)."""
    W, _, C = pa.shape
    ga = geom[sa].t()[:, None, :]
    gb = geom[sb].t()[:, None, :]
    pa = pa.transpose(0, 1)
    pb = pb.transpose(0, 1)
    cache = cache.transpose(0, 1)

    def unpack(g):
        return g[0:8], g[8:16], g[16:24], g[24:32], g[32:33].to(I32), g[33:34]

    res = collide_lanes(
        *unpack(ga), *unpack(gb),
        pa[0:1], pa[1:2], pa[2:3], pa[3:4],
        pb[0:1], pb[1:2], pb[2:3], pb[3:4],
        cache[0:1], (cache[1:2], cache[2:3], cache[3:4]), (cache[4:5], cache[5:6], cache[6:7]),
        gjk_iters=gjk_iters,
    )

    def rows(xs):
        return torch.cat([x.expand(1, W, C) for x in xs], dim=0).transpose(0, 1).contiguous()

    fout = rows([
        res.normal_x, res.normal_y, res.a0x, res.a0y, res.a1x, res.a1y,
        res.b0x, res.b0y, res.b1x, res.b1y, res.sep0, res.sep1,
    ])
    iout = rows([res.pid0, res.pid1, res.count])
    cout = rows([res.cache_count, *res.ia, *res.ib])
    return fout, iout, cout
