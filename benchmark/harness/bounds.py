"""The least time of the port's two kernels on the inputs of a run.

A copy of the bound arithmetic that `chip_smoke.py` used for K2 (the
narrowphase, `csrc/narrow.cu`) and K1 (the fused soft solve,
`csrc/fused_solve.cu`), kept here so that later changes to the program
cannot move the yardstick. The GJK trips a slot runs come from the
reference's own lane-major GJK (`refsim.ops.narrow_lanes.gjk_lanes`).
"""

from __future__ import annotations

import torch

from refsim.config import LINEAR_SLOP, SolverType
from refsim.ops.narrow_lanes import gjk_lanes
from refsim.solvers.fused_solve import C_ACTIVE, J_ACTIVE
from refsim.solvers.scripts import SOLVER_SCRIPTS

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: HBM 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# lanes a GJK pass of `k2_work` holds at once
_CHUNK = 1 << 19


def k2_work(args, gjk_iters: int) -> dict:
    """What each (world, slot) of K2 does on its inputs `args` = (geom,
    sa, sb, pa, pb, cache) (layouts in `refsim.ops.narrow_lanes.
    collide_lanes_plain`): its GJK trips (it runs trips until its simplex
    stops changing, and one more to see it, at most gjk_iters), its
    manifold path, and its shapes' vertex counts. Returns a dict of [W, C]
    tensors: trips, ca, cb, and the path masks sat, vv (vertex-vertex), ev
    (edge-vertex clip), cc (two circles), pc (polygon and circle)."""
    geom, sa, sb, pa, pb, cache = args
    W, _, C = pa.shape
    ga, gb = geom[sa].t()[:, None, :], geom[sb].t()[:, None, :]
    ca, cb = ga[32:33].to(torch.int32), gb[32:33].to(torch.int32)

    def gjk(w, c0, c1, iters):
        a, b, k = pa[w, :, c0:c1][:, None], pb[w, :, c0:c1][:, None], cache[w, :, c0:c1][:, None]
        gas, gbs = ga[..., c0:c1], gb[..., c0:c1]
        qas, qac, qbs, qbc = a[2:3], a[3:4], b[2:3], b[3:4]
        xqs, xqc = qac * qbs - qas * qbc, qac * qbc + qas * qbs
        dxp, dyp = b[0:1] - a[0:1], b[1:2] - a[1:2]
        xpx, xpy = qac * dxp + qas * dyp, -qas * dxp + qac * dyp
        vbx, vby = gbs[0:8], gbs[8:16]
        return gjk_lanes(gas[0:8], gas[8:16], ca[..., c0:c1], xpx + (xqc * vbx - xqs * vby),
                         xpy + (xqs * vbx + xqc * vby), cb[..., c0:c1], k[0:1], (k[1:2], k[2:3], k[3:4]),
                         (k[4:5], k[5:6], k[6:7]), iters)

    def key(g):
        return torch.cat([g.count, *g.ia, *g.ib])

    trips = torch.empty((W, C), dtype=torch.int32, device=pa.device)
    dist = torch.empty((W, C), dtype=torch.float32, device=pa.device)
    count = torch.empty((W, C), dtype=torch.int32, device=pa.device)
    for w in range(W):
        for c0 in range(0, C, _CHUNK):
            c1 = min(C, c0 + _CHUNK)
            final = gjk(w, c0, c1, gjk_iters)
            want = key(final)
            settled = torch.full((c1 - c0,), gjk_iters, dtype=torch.int32, device=pa.device)
            for k in range(gjk_iters - 1, -1, -1):
                same = (key(gjk(w, c0, c1, k)) == want).all(0)[0]
                settled = torch.where(same, torch.full_like(settled, k), settled)
            trips[w, c0:c1] = torch.clamp(settled + 1, max=gjk_iters)
            dist[w, c0:c1] = final.distance[0, 0]
            count[w, c0:c1] = final.count[0, 0]
    ca, cb = ca[0].expand(W, C), cb[0].expand(W, C)
    circle_a, circle_b = ca == 1, cb == 1
    poly = ~circle_a & ~circle_b
    sat = poly & (dist < 0.1 * LINEAR_SLOP)
    vv = poly & ~sat & (count == 1)
    return dict(trips=trips, ca=ca, cb=cb, sat=sat, vv=vv, ev=poly & ~sat & ~vv, cc=circle_a & circle_b,
                pc=circle_a ^ circle_b)


def k2_ops(work: dict) -> float:
    """The float operations K2's function needs on these inputs, at most:
    each operation of the kernel's own code counted once, for the GJK
    trips a slot runs (each charged a 3-point simplex solve) and the one
    manifold path it takes, its scans over its shapes' own vertex counts."""
    ca, cb, trips = work["ca"].double(), work["cb"].double(), work["trips"].double()
    solve = 54.0  # w = B - A (6), the 3-point barycentric solve (48)
    trip = solve + 15.0 + 2.0 + 3.0 * (ca + cb)  # solve, search direction, two support scans
    clip = 63.0  # clip_polygons
    ev = 28.0 + clip  # reference and incident edges from the GJK features; every non-SAT path fills its second point
    path = (work["sat"] * (7.0 * (ca + cb) + 10.0 * ca * cb + clip)  # two max-separation scans, incident edges
            + work["vv"] * (ev + 21.0) + work["ev"] * ev + work["cc"] * (ev + 23.0)
            + work["pc"] * (ev + 69.0 + 5.0 * torch.where(work["ca"] == 1, cb, ca)))
    # B into A's frame (15) and B's vertices and normals (14 each), the
    # closing solve, the witness points and distance (42), the outputs (25)
    per_slot = 15.0 + 14.0 * cb + trips * trip + solve + 42.0 + path + 25.0
    return float(per_slot.sum())


def k2_bytes(args) -> int:
    """The bytes K2's function must move: per slot two poses and the GJK
    cache in, 12 floats and 10 ints out; the shape indices and the shape
    rows once."""
    geom, _, _, pa, _, _ = args
    W, _, C = pa.shape
    return W * C * (2 * 16 + 28) + W * C * 88 + C * 8 + geom.shape[0] * 34 * 4


def k2_bound(args, ops: float):
    """K2's least time on these inputs: its bytes (`k2_bytes`) over the
    memory rate, or `ops` float operations (`k2_ops`) over the fp32 rate,
    whichever is larger. Returns (ms, "bytes" or "ops", bytes, ops)."""
    nbytes = k2_bytes(args)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_F32_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "ops"), nbytes, ops


def k1_contact_columns(solver: SolverType, warm_start: bool) -> int:
    """The float columns of a contact row that K1's script for `solver`
    reads: TGS_Soft all but r_a0, r_b0 and the separation (15-24);
    SoftStep all but the separation (23-24); PGS_Soft all but the adjusted
    separation (25-26), and without the warm start not the local anchors
    (7-14) either, which only its warm start rotates."""
    mode = SOLVER_SCRIPTS[solver].mode
    if mode.current_vel_anchors:
        return 37 - 10
    if mode.sep_from_delta:
        return 37 - 2
    return 37 - 2 - (0 if warm_start else 8)


def k1_bytes(x, solver: SolverType, warm_start: bool) -> int:
    """The bytes K1's function must move on its inputs `x` (the program's
    `FusedInputs`): the int row of every contact and joint slot (to find
    the live ones); for each active contact the float columns the script
    reads and its 4 impulses in and out; for each live joint its 23 float
    columns and 5 impulses in and out; the body state in and out and the
    body constants; h and 1/h."""
    n_c = int(((x.cint[..., 3] & C_ACTIVE) != 0).sum())
    n_j = int(((x.jint[..., 3] & J_ACTIVE) != 0).sum())
    slots = (x.cint.numel() + x.jint.numel()) * 4
    contacts = n_c * (k1_contact_columns(solver, warm_start) + 2 * 4) * 4
    joints_ = n_j * (23 + 2 * 5) * 4
    bodies = (2 * x.bs.numel() + x.body_const.numel()) * 4
    return slots + contacts + joints_ + bodies + x.scal.numel() * 4


def k1_bound_ms(x, solver: SolverType, warm_start: bool) -> float:
    """K1's least time: its bytes over the memory rate (K1 is bound by
    bytes on every path; its float operations are not counted)."""
    return k1_bytes(x, solver, warm_start) / PEAK_BYTES_S * 1e3
