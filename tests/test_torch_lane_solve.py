"""Port lane solve (solver2d_tpu_torch.solvers.lane_solve) vs the JAX package:
the shared structure and one lane_solve on identical inputs, with worlds
that differ in their values and one world whose slot does not match world
0's pair."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models.contact_scenes import pyramid_world as jax_pyramid
from solver2d_tpu.parallel import replicate_state
from solver2d_tpu.solvers import lane_solve as jls
from solver2d_tpu_torch import SolverType, pyramid_world, replicate, step_batch, to_numpy
from solver2d_tpu_torch.ops import broadphase as pbp
from solver2d_tpu_torch.solvers import lane_solve as pls
from solver2d_tpu_torch.step import update_manifolds_lane
from torch_parity import F32, assert_tree_close, np_tree, to_jax

torch.set_num_threads(1)
W = 2
CONFIGS = {
    "TGS_SOFT": dict(iterations=4, extra_iterations=2, gjk_iters=10, max_colors=9, contact_bucket_cap=-1),
    "SOFT_STEP": dict(iterations=4, extra_iterations=2, gjk_iters=10, max_colors=9, contact_bucket_cap=-1),
    "PGS_SOFT": dict(iterations=1, extra_iterations=1, gjk_iters=4, max_colors=4, contact_bucket_cap=-1),
}


def _inputs(solver):
    """A base-3 batch after one port step, then the next step's matched and
    collided contact table; world 1's values perturbed and one of its slots
    pointed at another body."""
    kw = CONFIGS[solver]
    pstate, pcfg = pyramid_world(SolverType[solver], 3)[0].freeze(device="cpu", **kw)
    jstate, jcfg = jax_pyramid(JSolver[solver], 3)[0].freeze(
        solve_joints=False, lane_solve=True, narrowphase="lanes", **kw
    )
    b = step_batch(replicate(pstate, W), 1 / 60, pcfg)
    s0 = b.shapes.map(lambda x: x[0])
    body0 = b.bodies.map(lambda x: x[0])
    pairs = pbp.find_pairs_grid(s0, body0.type, pbp.jointed_body_keys(b.joints.map(lambda x: x[0]), pcfg), pcfg)
    contacts = update_manifolds_lane(b, pbp.match_contacts_lane(b.contacts, pairs, s0), pcfg)
    rng = np.random.RandomState(0)
    bodies = dataclasses.replace(b.bodies, v=b.bodies.v + 0.01 * torch.from_numpy(
        rng.normal(size=tuple(b.bodies.v.shape)).astype(np.float32)) * (b.bodies.type[..., None] == 2))
    contacts.normal_impulse[1] += torch.from_numpy(rng.uniform(0, 0.1, tuple(contacts.normal_impulse[1].shape)).astype(np.float32))
    live = torch.nonzero(contacts.alive[1] & (contacts.point_count[1] > 0)).flatten()
    contacts.body_a[1, live[0]] = contacts.body_b[1, live[0]]
    return bodies, contacts, b.gravity, pcfg, jstate, jcfg


@pytest.mark.parametrize("solver", ["TGS_SOFT", "SOFT_STEP", "PGS_SOFT"])
def test_lane_solve_matches_jax(solver):
    bodies, contacts, gravity, pcfg, jstate, jcfg = _inputs(solver)
    jbatch = replicate_state(jstate, W)
    jb = to_jax(jbatch.bodies, to_numpy(bodies))
    jc = to_jax(jbatch.contacts, to_numpy(contacts))
    dyn0 = (bodies.type[0] == 2) & bodies.alive[0]
    with jax.disable_jit():
        jstruct = jls.build_lane_structure(jc, jnp.asarray(dyn0.numpy()), jcfg)
        jc = dataclasses.replace(jc, color=jnp.broadcast_to(jstruct.ccolor[None], jc.color.shape))
        jnb, jnc, jmis = jls.lane_solve(jb, jc, jstruct, jnp.asarray(gravity[0].numpy()), jnp.float32(1 / 60), jcfg)

    pstruct = pls.build_lane_structure(contacts, dyn0, pcfg)
    for name in pstruct._fields:
        np.testing.assert_array_equal(getattr(pstruct, name).numpy(), np.asarray(getattr(jstruct, name)), err_msg=name)
    contacts = dataclasses.replace(contacts, color=pstruct.ccolor[None].expand(W, -1).contiguous())
    pnb, pnc, pmis = pls.lane_solve(bodies, contacts, pstruct, gravity[0], torch.tensor(1 / 60, dtype=torch.float32), pcfg)
    np.testing.assert_array_equal(pmis.numpy(), np.asarray(jmis))
    # world 1's re-pointed slot is one more uncovered contact (uncolored
    # contacts count in both worlds: the JAX package's double count)
    assert int(pmis[1] - pmis[0]) == 1
    assert_tree_close(to_numpy(pnb), np_tree(jnb), F32)
    assert_tree_close(to_numpy(pnc), np_tree(jnc), F32)
