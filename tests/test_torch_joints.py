"""Port joints (solver2d_tpu_torch.solvers.joints) vs the JAX package's
`solvers/joints.py` on seeded random inputs: a joint table of revolute
joints with limits and motors on and off and some mouse joints, random body
rows, impulses and velocities. The operations are the same, in the same
order, so the outputs are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.solvers import joints as jjk
from solver2d_tpu.state import Bodies as JBodies
from solver2d_tpu.state import Joints as JJoints
from solver2d_tpu_torch.solvers import joints as pjk
from solver2d_tpu_torch.state import Bodies, Joints, from_numpy

torch.set_num_threads(1)
B, J = 12, 24
H, INV_H, HERTZ = np.float32(1 / 240), np.float32(240.0), np.float32(30.0)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    ang = rng.uniform(-3, 3, B)
    mass = rng.uniform(0.5, 3, B).astype(np.float32)
    static = rng.rand(B) < 0.2
    bodies = dict(
        type=np.where(static, 0, 2).astype(np.int32), origin=f(B, 2), position=f(B, 2), delta_pos=f(B, 2),
        delta_pos0=f(B, 2), rot=np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32), rot0=f(B, 2),
        local_center=f(B, 2, scale=0.1), v=f(B, 2), w=f(B), v0=f(B, 2), w0=f(B), force=f(B, 2), torque=f(B),
        mass=mass, inv_mass=np.where(static, 0, 1 / mass).astype(np.float32),
        inertia=(mass / 6).astype(np.float32), inv_inertia=np.where(static, 0, 6 / mass).astype(np.float32),
        linear_damping=f(B), angular_damping=f(B), gravity_scale=f(B), alive=np.ones(B, bool),
    )
    lo = rng.uniform(-1, 0.2, J).astype(np.float32)
    joints = dict(
        type=(rng.rand(J) < 0.25).astype(np.int32), body_a=rng.randint(0, B, J).astype(np.int32),
        body_b=rng.randint(0, B, J).astype(np.int32), local_anchor_a=f(J, 2, scale=0.5),
        local_anchor_b=f(J, 2, scale=0.5), collide_connected=rng.rand(J) < 0.5,
        reference_angle=f(J, scale=0.3), lower_angle=lo, upper_angle=(lo + rng.uniform(0, 1.5, J)).astype(np.float32),
        enable_limit=rng.rand(J) < 0.6, enable_motor=rng.rand(J) < 0.6, motor_speed=f(J),
        max_motor_torque=np.abs(f(J, scale=50)), target=f(J, 2), hertz=np.abs(f(J, scale=5)),
        damping_ratio=np.abs(f(J)), impulse=f(J, 2), motor_impulse=f(J), lower_impulse=np.abs(f(J)),
        upper_impulse=np.abs(f(J)), color=np.zeros(J, np.int32), alive=rng.rand(J) < 0.9,
    )
    state = dict(
        vA=f(J, 2), wA=f(J), vB=f(J, 2), wB=f(J), dcA=f(J, 2, scale=0.05), dcB=f(J, 2, scale=0.05),
    )
    qa, qb = rng.uniform(-3, 3, J), rng.uniform(-3, 3, J)
    state["qA"] = np.stack([np.sin(qa), np.cos(qa)], -1).astype(np.float32)
    state["qB"] = np.stack([np.sin(qb), np.cos(qb)], -1).astype(np.float32)
    return bodies, joints, state


def _prepare(seed):
    bodies, joints, state = _inputs(seed)
    jb = JBodies(**{k: jnp.asarray(v) for k, v in bodies.items()})
    jj = JJoints(**{k: jnp.asarray(v) for k, v in joints.items()})
    with jax.disable_jit():
        jcons, jimp = jjk.prepare_joints(jb, jj, h=jnp.float32(H), hertz=jnp.float32(HERTZ), soft=True, warm_start=True)
    pb = from_numpy(Bodies, bodies, "cpu").map(lambda x: x[None])
    pj = from_numpy(Joints, joints, "cpu").map(lambda x: x[None])
    pcons, pimp = pjk.prepare_joints(pb, pj, h=torch.tensor(H), hertz=torch.tensor(HERTZ), warm_start=True)
    return (jcons, jimp), (pcons, pimp), state


def _equal(got, ref, name):
    got = got[0].numpy()
    ref = np.asarray(ref)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.int32) != ref.view(np.int32), False, err_msg=name)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_joints_matches_jax(seed):
    (jcons, jimp), (pcons, pimp), _ = _prepare(seed)
    for name in pcons._fields:
        _equal(getattr(pcons, name), getattr(jcons, name), name)
    for name in pimp._fields:
        _equal(getattr(pimp, name), getattr(jimp, name), name)
    assert bool(pcons.is_mouse.any()) and bool((pcons.enable_limit & pcons.enable_motor).any())


@pytest.mark.parametrize("use_bias,solve_mouse", [(True, True), (False, False), (True, False)])
def test_solve_joint_core_matches_jax(use_bias, solve_mouse):
    (jcons, jimp), (pcons, pimp), s = _prepare(2)
    args = [s[k] for k in ("vA", "wA", "vB", "wB", "qA", "qB", "dcA", "dcB")]
    with jax.disable_jit():
        ref = jjk.solve_joint_core(jcons, *map(jnp.asarray, args), jimp, "soft", jnp.float32(H),
                                   jnp.float32(INV_H), use_bias, solve_mouse)
    got = pjk.solve_joint_core(pcons, *(torch.from_numpy(a)[None] for a in args), pimp, torch.tensor(H),
                               torch.tensor(INV_H), use_bias, solve_mouse)
    for i, name in enumerate(("vA", "wA", "vB", "wB", "new_impulse")):
        _equal(got[i], ref[i], name)
    for name in pimp._fields:
        _equal(getattr(got[5], name), getattr(ref[5], name), name)
    _equal(got[6], ref[6], "scope")
    # the limits and the motor moved impulses
    for name in ("motor", "lower", "upper"):
        assert not torch.equal(getattr(got[5], name), getattr(pimp, name)), name


def test_store_impulses_keeps_live_joints():
    (_, _), (pcons, pimp), _ = _prepare(3)
    bodies, joints, _ = _inputs(3)
    pj = from_numpy(Joints, joints, "cpu").map(lambda x: x[None])
    out = pjk.store_impulses(pj, pcons, pimp)
    live = pcons.active[..., None]
    assert torch.equal(out.impulse, torch.where(live, pimp.impulse, pj.impulse))
    assert torch.equal(out.lower_impulse, torch.where(pcons.active, pimp.lower, pj.lower_impulse))
    assert dataclasses.is_dataclass(out)


def test_mouse_joint_body_a_must_not_be_dynamic():
    """The port's world takes a mouse joint on a body A of any type, as the
    JAX package's does: no type is refused (the solve never moves A), and
    the joint's anchors are the JAX world's."""
    from solver2d_tpu.config import SolverType as JSolver
    from solver2d_tpu.models.joint_scenes import bridge as jax_bridge
    from solver2d_tpu_torch import SolverType, bridge

    world, planks = bridge(SolverType.TGS_SOFT, 4)
    jworld = jax_bridge(JSolver.TGS_SOFT, 4).world
    x, y = world.bodies[planks[1]].def_.position
    for a in (0, planks[0]):
        n = len(world.joints)
        assert world.create_mouse_joint(a, planks[1], (x, y + 1.0), 5.0, 0.7) == n
        jworld.create_mouse_joint(a, planks[1], (x, y + 1.0), 5.0, 0.7)
        for name in ("body_a", "body_b", "local_anchor_a", "local_anchor_b", "target"):
            np.testing.assert_allclose(getattr(world.joints[n], name), getattr(jworld.joints[n], name), err_msg=name)
    assert world.bodies[planks[0]].def_.type == 2
