"""Scene metrics, per world of a [W, ...] batch (analog of s2Statistics,
reference: include/solver2d/timer.h:8-17, src/world.c:565-579). An own copy
of the JAX package's `utils/metrics.py` (:15-85) and `joint_error`."""

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
    err = torch.linalg.vector_norm(pb - pa, dim=-1)
    return torch.where(j.alive & (j.type == 0), err, 0.0).amax(dim=-1)
