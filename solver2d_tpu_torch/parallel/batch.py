"""World batches: a leading worlds dim on every tensor of the state."""

from __future__ import annotations

from ..state import State


def replicate(state: State, n: int) -> State:
    """Tile one world into an [n, ...] lockstep batch (fresh memory)."""
    return state.map(lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous())
