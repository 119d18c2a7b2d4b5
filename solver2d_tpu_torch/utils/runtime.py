"""Runtime changes to a frozen state: the fixed-capacity analog of the
reference's pool free (reference: src/pool.c, src/body.c:65-150 destroy).
A body is taken out by clearing alive masks. An own copy of the JAX
package's `utils/runtime.py:destroy_body`, for one world or a [W, ...]
batch (the same body in every world)."""

from __future__ import annotations

import dataclasses

from ..state import State


def destroy_body(state: State, body_idx: int) -> State:
    """Disable a body, its shapes, its joints and its contacts."""
    alive = state.bodies.alive.clone()
    alive[..., body_idx] = False
    shapes, joints, contacts = state.shapes, state.joints, state.contacts
    joint_dead = (joints.body_a == body_idx) | (joints.body_b == body_idx)
    contact_dead = (contacts.body_a == body_idx) | (contacts.body_b == body_idx)
    return dataclasses.replace(
        state,
        bodies=dataclasses.replace(state.bodies, alive=alive),
        shapes=dataclasses.replace(shapes, alive=shapes.alive & (shapes.body != body_idx)),
        joints=dataclasses.replace(joints, alive=joints.alive & ~joint_dead),
        contacts=dataclasses.replace(contacts, alive=contacts.alive & ~contact_dead),
    )
