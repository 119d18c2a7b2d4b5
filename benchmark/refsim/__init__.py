"""The benchmark's plain reference: a frozen copy of the plain PyTorch path
of `solver2d_tpu_torch` (its per-world step, the scene builders and the
`World.freeze` that derives masses, tables and capacities), with the two
kernels replaced by their plain twins (`ops/narrow_cuda.py`,
`solvers/fused_cuda.py`), no CUDA graphs, and only what the benchmark's
cells run: the Pyramid and the Bridge, the grid and the sweep-and-prune
broadphase, incremental and MIS colours, the fused route and the XLA
route's PGS_NGS_Block on the dense layout (`step.step` refuses the rest).

It imports nothing of `solver2d_tpu_torch`, of the JAX package or of JAX,
and later changes to the program do not reach it. Every tensor stays on
the device the caller freezes to; the benchmark runs it on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import SimConfig, SolverType
from .models import SCENES
from .state import State
from .step import step

__all__ = ["SCENES", "SimConfig", "SolverType", "State", "apply_velocity_deltas", "replicate", "step"]


def replicate(state: State, n: int) -> State:
    """Tile one world into an [n, ...] batch (fresh memory)."""
    return state.map(lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous())


def apply_velocity_deltas(batch: State, dv, dw) -> State:
    """The batch with dv [W, B, 2] and dw [W, B] added to the velocities of
    its live dynamic bodies."""
    b = batch.bodies
    dyn = (b.type == 2) & b.alive
    bodies = dataclasses.replace(
        b,
        v=torch.where(dyn[..., None], b.v + dv.to(b.v.device), b.v),
        w=torch.where(dyn, b.w + dw.to(b.w.device), b.w),
    )
    return dataclasses.replace(batch, bodies=bodies)
