"""World batches: a leading worlds dim on every tensor of the state."""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import State
from ..step import step


def replicate(state: State, n: int) -> State:
    """Tile one world into an [n, ...] batch (fresh memory)."""
    return state.map(lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous())


def batch_states(states: list[State]) -> State:
    """Stack same-capacity worlds into a [W, ...] batch."""
    return states[0].map(lambda *xs: torch.stack(xs), *states[1:])


def batched_step(config: SimConfig):
    """Returns step(batch, dt) -> batch: the per-world step (each world with
    its own pairs, colors and fused solve) on an [W, ...] batch; the
    counterpart of the JAX package's vmapped `step`."""

    def run(batch: State, dt: float) -> State:
        return step(batch, dt, config)

    return run
