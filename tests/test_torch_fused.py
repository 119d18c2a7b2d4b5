"""The per-world solve of the port (solvers/loops.solve_tgs_soft_fused, whose
fused solve runs the plain twin of K1 on the CPU) against the JAX package's
TGS_Soft solve, on the state of the base-3 pyramid and of the 4-plank Bridge
with a mouse joint after two steps.

The JAX reference is the XLA solver (`loops.solve_tgs_soft` with
`use_pallas_solver=False`): the fused TPU kernel reuses its per-constraint
code and differs from it only in the order of the warm-start sums. Floats
are held to `torch_parity.WORLD_TOL`: exact on the pyramid, 1e-6 on the
Bridge. One case holds
the twin against the JAX fused kernel itself, run in Pallas interpret mode
on the Bridge after one step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.solvers import loops as jloops
from solver2d_tpu.step import _pre_solve as jax_pre_solve
from solver2d_tpu.step import step as jax_step
from solver2d_tpu_torch.solvers import loops as ploops
from solver2d_tpu_torch.solvers.common import BodyMap
from solver2d_tpu_torch.state import Bodies, Contacts, Joints, from_numpy
from torch_parity import (
    DT, WORLD_TOL, jax_colors, jax_world_scene, np_tree, port_config,
)

torch.set_num_threads(1)


def _solve_both(scene, pallas_interpret=False, steps=2):
    jstate, jcfg = jax_world_scene(scene)
    with jax.disable_jit():
        for _ in range(steps):
            jstate = jax_step(jstate, jnp.float32(DT), jcfg)
        contacts, _, _ = jax_pre_solve(jstate, jcfg)
        contacts, joints, colors = jax_colors(jstate, contacts, jcfg)
        scfg = jcfg.replace(use_pallas_solver=True) if pallas_interpret else jcfg
        ref = jloops.solve_tgs_soft(jstate.bodies, contacts, joints, colors, jstate.gravity, jnp.float32(DT), scfg)

    def t(x):
        return torch.from_numpy(np.array(x))[None]

    def tree(cls, x):
        return from_numpy(cls, np_tree(x), "cpu").map(lambda v: v[None])

    ccolor, cmap, jcolor, jmap = colors
    got = ploops.solve_tgs_soft_fused(
        tree(Bodies, jstate.bodies), tree(Contacts, contacts), tree(Joints, joints),
        t(ccolor), BodyMap(t(cmap.slot), t(cmap.winner)), t(jcolor), BodyMap(t(jmap.slot), t(jmap.winner)),
        t(jstate.gravity), torch.tensor(DT, dtype=torch.float32), port_config(jcfg),
    )
    return got, ref


def _check(got, ref, tol):
    (pb, pc, pj), (jb, jc, jj) = got, ref
    for part, jpart, names in (
        (pb, jb, ("position", "origin", "rot", "v", "w")),
        (pc, jc, ("normal_impulse", "tangent_impulse")),
        (pj, jj, ("impulse", "motor_impulse", "lower_impulse", "upper_impulse")),
    ):
        for name in names:
            np.testing.assert_allclose(getattr(part, name)[0].numpy(), np.asarray(getattr(jpart, name)),
                                       err_msg=name, **tol)


@pytest.mark.parametrize("scene", ["pyramid", "bridge"])
def test_fused_solve_matches_jax_tgs_soft(scene):
    got, ref = _solve_both(scene)
    _check(got, ref, WORLD_TOL[scene])
    if scene == "pyramid":
        assert (np.asarray(ref[1].normal_impulse) > 0).any()
    else:
        assert (np.abs(np.asarray(ref[2].impulse)) > 0).any()
        assert np.asarray(ref[2].motor_impulse)[5] != 0  # the mouse joint's angular damping ran


def test_fused_solve_matches_jax_fused_kernel_interpreted():
    """One step first (warm impulses), then the Pallas kernel interpreted:
    about 40 s on the CPU."""
    _check(*_solve_both("bridge", pallas_interpret=True, steps=1), WORLD_TOL["bridge"])
