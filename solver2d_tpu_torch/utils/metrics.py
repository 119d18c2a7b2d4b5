"""Scene metrics, per world of a [W, ...] batch (analog of s2Statistics,
reference: include/solver2d/timer.h:8-17, src/world.c:565-579), and the GJK
counters. An own copy of the JAX package's `utils/metrics.py`."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import math2d as m


@dataclasses.dataclass
class Statistics:
    body_count: int
    shape_count: int
    contact_count: int
    joint_count: int
    pair_count: int
    max_penetration: float
    kinetic_energy: float
    color_overflow: int
    pair_overflow: bool
    step_id: int
    # table capacities: used / capacity is each table's headroom
    body_capacity: int = 0
    shape_capacity: int = 0
    contact_capacity: int = 0
    joint_capacity: int = 0

    @property
    def utilization(self) -> dict:
        """used / capacity per table (contacts by pair_count, the step's
        peak demand on the table)."""

        def frac(used, cap):
            return used / cap if cap else 0.0

        return {
            "bodies": frac(self.body_count, self.body_capacity),
            "shapes": frac(self.shape_count, self.shape_capacity),
            "contacts": frac(self.pair_count, self.contact_capacity),
            "joints": frac(self.joint_count, self.joint_capacity),
        }


def statistics(batch, world: int = 0) -> Statistics:
    """The counters of one world of a [W, ...] batch, on the host."""
    b, d = batch.bodies, batch.diag
    return Statistics(
        body_count=int(b.alive[world].sum()),
        shape_count=int(batch.shapes.alive[world].sum()),
        contact_count=int(d.contact_count[world]),
        joint_count=int(batch.joints.alive[world].sum()),
        pair_count=int(d.pair_count[world]),
        max_penetration=float(d.max_penetration[world]),
        kinetic_energy=float(kinetic_energy(batch)[world]),
        color_overflow=int(d.color_overflow[world]),
        pair_overflow=bool(d.pair_overflow[world]),
        step_id=int(d.step_id[world]),
        body_capacity=int(b.alive.shape[-1]),
        shape_capacity=int(batch.shapes.alive.shape[-1]),
        contact_capacity=int(batch.contacts.key.shape[-1]),
        joint_capacity=int(batch.joints.alive.shape[-1]),
    )


def kinetic_energy(batch):
    """Total kinetic energy of each world's live dynamic bodies [W]."""
    b = batch.bodies
    dyn = (b.type == 2) & b.alive
    lin = 0.5 * b.mass * (b.v[..., 0] * b.v[..., 0] + b.v[..., 1] * b.v[..., 1])
    ang = 0.5 * b.inertia * b.w * b.w
    return torch.where(dyn, lin + ang, 0.0).sum(dim=-1)


def max_penetration(batch):
    """Each world's deepest touching contact point of the last step [W]."""
    return batch.diag.max_penetration


def joint_error(batch):
    """Per world of a [W, ...] batch: the largest point-to-point separation
    of a live revolute joint (the JAX package's `utils/metrics.py:
    joint_error`)."""
    j, b = batch.joints, batch.bodies
    worlds = torch.arange(j.body_a.shape[0], device=j.body_a.device)[:, None]
    pa = b.origin[worlds, j.body_a] + m.rotate(b.rot[worlds, j.body_a], j.local_anchor_a)
    pb = b.origin[worlds, j.body_b] + m.rotate(b.rot[worlds, j.body_b], j.local_anchor_b)
    # math2d.length, not torch.linalg.vector_norm, which rounds differently
    # from the JAX package's norm on the CPU
    err = m.length(pb - pa)
    return torch.where(j.alive & (j.type == 0), err, 0.0).amax(dim=-1)


@dataclasses.dataclass
class GJKStats:
    """The S2_GJK_DEBUG counters (reference: src/distance.c:480-482,
    :572-574, :597-599): calls, total support iterations, the most
    iterations of a call, and the pairs that enter with a warm simplex
    cache. Computed on demand, never in the step; they size
    `SimConfig.gjk_iters` by data."""

    calls: int        # live pairs evaluated (s2_gjkCalls)
    iters: int        # total support iterations (s2_gjkIters)
    max_iters: int    # the worst pair (s2_gjkMaxIters)
    cache_hits: int   # pairs entering with a warm simplex cache


def gjk_stats(batch, gjk_iters: int = 20, cold: bool = False, world: int = 0) -> GJKStats:
    """Run GJK again over one world's contact table on the inputs the
    narrowphase reads, and count its convergence.

    As in the reference's counters, `iterations` counts the support trips
    beyond the warm-started simplex (distance.c:572-599): a settled contact
    whose cached simplex already holds the origin counts 0. `cold=True`
    zeroes the caches and measures the budget from scratch, the number
    that sizes `SimConfig.gjk_iters`."""
    from ..ops.distance import gjk

    one = batch if batch.bodies.type.dim() == 1 else batch.map(lambda x: x[world])
    shapes, bodies, con = one.shapes, one.bodies, one.contacts
    sa, sb = con.shape_a.long(), con.shape_b.long()
    ba, bb = con.body_a.long(), con.body_b.long()
    xp, xq = m.inv_mul_transforms(bodies.origin[ba], bodies.rot[ba], bodies.origin[bb], bodies.rot[bb])
    vb = xp[:, None, :] + m.rotate(xq[:, None, :], shapes.verts[sb])
    cache_count = torch.zeros_like(con.cache_count) if cold else con.cache_count
    out = gjk(shapes.verts[sa], shapes.count[sa], vb, shapes.count[sb], cache_count, con.cache_index_a,
              con.cache_index_b, max_iters=gjk_iters)
    live = con.alive
    iters = torch.where(live, out.iterations, 0)
    return GJKStats(
        calls=int(live.sum()),
        iters=int(iters.sum()),
        max_iters=int(iters.max()),
        cache_hits=int((live & (cache_count > 0)).sum()),
    )
