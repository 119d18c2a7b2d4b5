"""Scene metrics read by the tests and chip_smoke.py."""

from __future__ import annotations

import torch

from ..ops import math2d as m


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
