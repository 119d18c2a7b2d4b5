"""The per-world solve of the port (solvers/loops.solve_*_fused, whose fused
solve runs the plain twin of K1 on the CPU) against the JAX package's
TGS_Soft, SoftStep and PGS_Soft solves, on the state of the base-3 pyramid
and of the 4-plank Bridge with a mouse joint after two steps.

The JAX reference is the XLA solver (`loops.solve_tgs_soft`,
`solve_soft_step`, `solve_pgs_soft` with `use_pallas_solver=False`): the
fused TPU kernel reuses its per-constraint code and differs from it only in
the order of the warm-start sums. Floats are held to
`torch_parity.WORLD_TOL`: exact on the pyramid, 1e-6 on the Bridge. Other
cases hold the twin against the JAX fused kernel itself, run in Pallas
interpret mode on the Bridge after one step, in each script."""

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
    DT, WORLD_TOL, cheap_compiles, jax_colors, jax_world_scene, np_tree, port_config,
)

torch.set_num_threads(1)

SOLVES = {
    "TGS_SOFT": (jloops.solve_tgs_soft, ploops.solve_tgs_soft_fused),
    "SOFT_STEP": (jloops.solve_soft_step, ploops.solve_soft_step_fused),
    "PGS_SOFT": (jloops.solve_pgs_soft, ploops.solve_pgs_soft_fused),
}


def _solve_both(scene, solver="TGS_SOFT", pallas_interpret=False, steps=2):
    jsolve, psolve = SOLVES[solver]
    jstate, jcfg = jax_world_scene(scene)
    with jax.disable_jit(), cheap_compiles():
        for _ in range(steps):
            jstate = jax_step(jstate, jnp.float32(DT), jcfg)
        contacts, _, _ = jax_pre_solve(jstate, jcfg)
        contacts, joints, colors = jax_colors(jstate, contacts, jcfg)
        scfg = jcfg.replace(use_pallas_solver=True) if pallas_interpret else jcfg
        ref = jsolve(jstate.bodies, contacts, joints, colors, jstate.gravity, jnp.float32(DT), scfg)

    def t(x):
        return torch.from_numpy(np.array(x))[None]

    def tree(cls, x):
        return from_numpy(cls, np_tree(x), "cpu").map(lambda v: v[None])

    ccolor, cmap, jcolor, jmap = colors
    got = psolve(
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


def _check_scene(scene, solver):
    got, ref = _solve_both(scene, solver)
    _check(got, ref, WORLD_TOL[scene])
    if scene == "pyramid":
        assert (np.asarray(ref[1].normal_impulse) > 0).any()
    else:
        assert (np.abs(np.asarray(ref[2].impulse)) > 0).any()
        assert np.asarray(ref[2].motor_impulse)[5] != 0  # the mouse joint's angular damping ran


@pytest.mark.parametrize("scene", ["pyramid", "bridge"])
def test_fused_solve_matches_jax_tgs_soft(scene):
    _check_scene(scene, "TGS_SOFT")


@pytest.mark.parametrize("scene", ["pyramid", "bridge"])
def test_fused_solve_matches_jax_soft_step(scene):
    _check_scene(scene, "SOFT_STEP")


@pytest.mark.parametrize("scene", ["pyramid", "bridge"])
def test_fused_solve_matches_jax_pgs_soft(scene):
    _check_scene(scene, "PGS_SOFT")


def test_fused_solve_matches_jax_fused_kernel_interpreted():
    """One step first (warm impulses), then the Pallas kernel interpreted
    in its TGS_Soft script: about 40 s on the CPU."""
    _check(*_solve_both("bridge", pallas_interpret=True, steps=1), WORLD_TOL["bridge"])


@pytest.mark.parametrize("solver", ["SOFT_STEP", "PGS_SOFT"])
def test_fused_solve_matches_jax_fused_kernel_interpreted_script(solver):
    """As above, in the kernel's SoftStep and PGS_Soft scripts."""
    _check(*_solve_both("bridge", solver, pallas_interpret=True, steps=1), WORLD_TOL["bridge"])


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("mode", ["TGS_SOFT", "SOFT_STEP", "PGS_SOFT"])
def test_solve_contact_core_matches_jax(mode, use_bias):
    """One contact solve of each soft mode on seeded random constraints and
    body rows: the same operations in the same order, so equal outputs."""
    from solver2d_tpu.solvers import contact_kernels as jck
    from solver2d_tpu.solvers.common import ContactCons as JCons
    from solver2d_tpu_torch.solvers import contact_kernels as pck
    from solver2d_tpu_torch.solvers.common import ContactCons

    C = 64
    rng = np.random.RandomState(7)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    ang = rng.uniform(-3, 3, C)
    normal = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    fields = dict(
        inv_mass_a=np.abs(f(C)), inv_i_a=np.abs(f(C)), inv_mass_b=np.abs(f(C)), inv_i_b=np.abs(f(C)),
        normal=normal, friction=np.abs(f(C, scale=0.5)), active=rng.rand(C) < 0.9, pmask=rng.rand(C, 2) < 0.8,
        local_anchor_a=f(C, 2, 2, scale=0.5), local_anchor_b=f(C, 2, 2, scale=0.5),
        r_a0=f(C, 2, 2, scale=0.5), r_b0=f(C, 2, 2, scale=0.5), separation=f(C, 2, scale=0.02),
        adjusted_separation=f(C, 2, scale=0.02), normal_mass=np.abs(f(C, 2)), tangent_mass=np.abs(f(C, 2)),
        bias_coef=np.abs(f(C, 2, scale=60)), mass_coef=np.abs(f(C, 2)), imp_coef=np.abs(f(C, 2)),
    )
    qa, qb = rng.uniform(-3, 3, C), rng.uniform(-3, 3, C)
    rows = [f(C, 2), f(C), f(C, 2), f(C), np.stack([np.sin(qa), np.cos(qa)], -1).astype(np.float32),
            np.stack([np.sin(qb), np.cos(qb)], -1).astype(np.float32), f(C, 2, scale=0.05), f(C, 2, scale=0.05),
            np.abs(f(C, 2)), f(C, 2)]
    inv_h = np.float32(240.0)
    idx = jnp.zeros(C, jnp.int32)
    with jax.disable_jit():
        ref = jck.solve_contact_core(JCons(ia=idx, ib=idx, **{k: jnp.asarray(v) for k, v in fields.items()}),
                                     *map(jnp.asarray, rows), getattr(jck, mode), jnp.float32(inv_h), use_bias)
    got = pck.solve_contact_core(ContactCons(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                                 *map(torch.from_numpy, rows), getattr(pck, mode), torch.tensor(inv_h), use_bias)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not np.array_equal(np.asarray(ref[4]), rows[8])  # normal impulses moved
