"""Checkpoint and resume of a state as a flat `.npz` file.

An own copy of the JAX package's `save_npz` and `load_npz`, with the same
keys ("bodies.v", ..., "gravity") and dtypes (filter bits as uint32), so
that a file either package writes loads in the other. A state of one
world or a [W, ...] batch is saved as it is. The JAX package's orbax
checkpoints have no counterpart here.
"""

from __future__ import annotations

import numpy as np

from ..state import State, state_from_numpy, to_numpy

_GROUPS = ("bodies", "shapes", "contacts", "joints", "diag")


def save_npz(path: str, state: State):
    flat = {}
    tree = to_numpy(state)
    for group in _GROUPS:
        for name, a in tree[group].items():
            flat[f"{group}.{name}"] = a
    flat["gravity"] = tree["gravity"]
    np.savez_compressed(path, **flat)


def load_npz(path: str, device="cuda") -> State:
    """The state saved at `path`, on `device`."""
    with np.load(path) as data:
        tree = {group: {} for group in _GROUPS}
        for key in data.files:
            if key == "gravity":
                tree["gravity"] = data[key]
            else:
                group, name = key.split(".", 1)
                tree[group][name] = data[key]
    return state_from_numpy(tree, device)
