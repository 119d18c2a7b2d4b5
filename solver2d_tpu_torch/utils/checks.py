"""Failure detection and recovery.

An own copy of the JAX package's `utils/checks.py`, the analog of the
reference's debug validators (reference: src/core.h:69-84,
src/dynamic_tree.c:900-1014, src/broad_phase.c:395-430): a health check of
each world (non-finite values, runaway speed) with a per-world reset, for
the few worlds of thousands that blow up in a long rollout; a structural
validation of one world's tables on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import State, world_to_numpy


def world_health(state: State, max_speed: float = 1e4):
    """Health of each world: [W] bools for a [W, ...] batch (the JAX
    function under `vmap`), a 0-dim bool for one world."""
    b = state.bodies
    lead = b.type.dim() - 1  # 1 for a batch, 0 for one world

    def all_finite(x):
        f = torch.isfinite(x)
        return f.flatten(lead).all(dim=-1) if lead else f.all()

    finite = all_finite(b.position) & all_finite(b.v) & all_finite(b.w) & all_finite(b.rot)
    speed2 = torch.where(b.alive, b.v[..., 0] * b.v[..., 0] + b.v[..., 1] * b.v[..., 1], 0.0)
    return finite & (speed2.amax(dim=-1) < max_speed**2)


def reset_unhealthy_worlds(batch: State, initial: State) -> State:
    """The batch with each unhealthy world replaced by that world of
    `initial` (both [W, ...], for example the frozen start batch)."""
    healthy = world_health(batch)

    def sel(cur, init):
        return torch.where(healthy.reshape((-1,) + (1,) * (cur.dim() - 1)), cur, init)

    return batch.map(sel, initial)


def validate_state(state: State, config, world: int = 0) -> list[str]:
    """Structural validation of one world (the analog of
    s2ValidateBroadphase), read on the host through `to_numpy`: a list of
    violations, empty when the world is valid."""
    s = world_to_numpy(state, world)
    problems = []
    shapes, bodies, con = s["shapes"], s["bodies"], s["contacts"]
    alive_shapes = shapes["alive"]
    if np.any(alive_shapes & ~bodies["alive"][shapes["body"]]):
        problems.append("shape alive but body dead")
    calive = con["alive"]
    keys = con["key"][calive]
    if len(keys) and np.any(np.diff(np.sort(keys)) == 0):
        problems.append("duplicate contact keys")
    expect = con["shape_a"] * config.max_shapes + con["shape_b"]
    if np.any(calive & (con["key"] != expect)):
        problems.append("contact key mismatch")
    pc = con["point_count"]
    if np.any(calive & ((pc < 0) | (pc > 2))):
        problems.append("bad point count")
    if np.any(~calive & (pc > 0)):
        problems.append("dead contact with points")
    return problems


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_color_disjointness(body_a, body_b, color, active, dynamic_mask, n_colors) -> bool:
    """Test-time invariant: within each color but the last (which may
    overflow by design), no two active constraints share a dynamic body,
    the property that makes colored Gauss-Seidel equal sequential
    Gauss-Seidel. Takes tensors or arrays of one world."""
    body_a, body_b = _np(body_a), _np(body_b)
    color, active = _np(color), _np(active)
    dynamic_mask = _np(dynamic_mask)
    for k in range(n_colors - 1):
        sel = active & (color == k)
        seen = set()
        for a, b in zip(body_a[sel], body_b[sel]):
            for x in (a, b):
                if dynamic_mask[x]:
                    if x in seen:
                        return False
                    seen.add(x)
    return True
