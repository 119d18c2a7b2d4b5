"""The per-world slice as a whole: 3 steps of the port's `batched_step`
(K1 and K2 through their plain twins on the CPU) on a batch of two worlds
that differ in their initial velocities, against the JAX package's
per-world `step` on each world, op by op, on the base-3 pyramid and on the
4-plank Bridge with a mouse joint, under TGS_Soft, SoftStep and PGS_Soft;
and on the Bridge whose mouse joint's body A is a dynamic plank.

The JAX step runs its XLA solver (see tests/torch_parity.py); floats are
held to `torch_parity.WORLD_TOL` (exact on the pyramid, 1e-6 on the
Bridge); integers
(pair keys, point ids, GJK caches, colors, counts) are equal, and the
Bridge's `joint_error` is the JAX metric's. Each case checks one world of
the batch, so that the cases share out JAX's cost."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.step import step as jax_step
from solver2d_tpu.utils.metrics import joint_error as jax_joint_error
from solver2d_tpu_torch import batched_step, state_from_numpy, to_numpy
from solver2d_tpu_torch.utils.metrics import joint_error
from torch_parity import (
    DT, WORLD_TOL, assert_tree_close, jax_world_scene, jax_worlds, np_tree, port_config, stack,
)

torch.set_num_threads(1)
W = 2
STEPS = 3


def _check_steps(scene, world, solver="TGS_SOFT"):
    jstate, jcfg = jax_world_scene(scene)
    jcfg = jcfg.replace(solver=JSolver[solver])
    worlds = jax_worlds(jstate, W)
    batch = state_from_numpy(stack(worlds), device="cpu")
    step = batched_step(port_config(jcfg))
    ref = worlds[world]
    for _ in range(STEPS):
        with jax.disable_jit():
            ref = jax_step(ref, jnp.float32(DT), jcfg)
        batch = step(batch, DT)
        got = {g: {k: v[world] for k, v in d.items()} for g, d in to_numpy(batch).items() if isinstance(d, dict)}
        assert_tree_close(got, np_tree(ref), WORLD_TOL[scene])
        assert int(batch.diag.color_overflow[world]) == 0
    assert not torch.equal(batch.bodies.v[0], batch.bodies.v[1])
    if scene == "pyramid":
        assert int(batch.diag.contact_count[world]) > 0
    else:
        assert float(batch.joints.motor_impulse[world, 5].abs()) > 0  # the mouse joint
        err = float(joint_error(batch)[world])
        np.testing.assert_allclose(err, float(jax_joint_error(ref)), **WORLD_TOL[scene])
        assert err > 0
    return batch


@pytest.mark.parametrize("scene,world", [("pyramid", 0), ("pyramid", 1), ("bridge", 0), ("bridge", 1)])
def test_batched_step_matches_jax_step(scene, world):
    _check_steps(scene, world)


@pytest.mark.parametrize("solver", ["SOFT_STEP", "PGS_SOFT"])
@pytest.mark.parametrize("scene", ["pyramid", "bridge"])
def test_batched_step_matches_jax_step_per_solver(scene, solver):
    _check_steps(scene, 1, solver)


@pytest.mark.parametrize("solver", ["TGS_SOFT", "SOFT_STEP", "PGS_SOFT"])
def test_batched_step_mouse_joint_on_dynamic_body_a(solver):
    """The mouse joint's body A is plank 1: the joint reads its velocity and
    never moves it, as the JAX package's does."""
    batch = _check_steps("bridge_dyn_a", 1, solver)
    assert int(batch.joints.body_a[1, 5]) == 1 and int(batch.bodies.type[1, 1]) == 2
