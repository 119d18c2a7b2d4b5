"""Port state and scene construction (solver2d_tpu_torch.world/state) vs the
JAX package: the frozen pyramid and Bridge, leaf by leaf and bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models.contact_scenes import pyramid_world as jax_pyramid
from solver2d_tpu.models.joint_scenes import bridge as jax_bridge
from solver2d_tpu.parallel import replicate_state
from solver2d_tpu_torch import SolverType, bridge, pyramid_world, replicate, state_from_numpy, to_numpy
from torch_parity import WORLD_KW, assert_tree_close, np_tree

torch.set_num_threads(1)

# masses and inertias are float32 on both sides, operation for operation
# (the JAX freeze's native scene compiler, csrc/s2native.cpp): every leaf
# is equal
EXACT = dict(rtol=0, atol=0)


@pytest.mark.parametrize("base", [3, 8, 20])
@pytest.mark.parametrize("solver", ["TGS_SOFT", "PGS_SOFT"])
def test_freeze_matches_jax(base, solver):
    kw = dict(contact_bucket_cap=-1)
    jstate, jcfg = jax_pyramid(JSolver[solver], base)[0].freeze(
        solve_joints=False, lane_solve=True, narrowphase="lanes", **kw
    )
    pstate, pcfg = pyramid_world(SolverType[solver], base)[0].freeze(
        device="cpu", solve_joints=False, narrowphase="lanes", **kw
    )
    for f in dataclasses.fields(pcfg):
        if f.name != "use_fused_solver":  # the port's own field: the lane step runs no K1
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert pcfg.use_fused_solver is False
    assert_tree_close(to_numpy(pstate), np_tree(jstate), EXACT)


@pytest.mark.parametrize("solver", ["SOFT_STEP", "PGS_SOFT"])
def test_freeze_bridge_matches_jax(solver):
    """The 160-plank Bridge, frozen for the per-world step."""
    jstate, _ = jax_bridge(JSolver[solver]).world.freeze(narrowphase="lanes", **WORLD_KW)
    pstate, _ = bridge(SolverType[solver])[0].freeze(device="cpu", lane_solve=False, **WORLD_KW)
    got = to_numpy(pstate)
    assert_tree_close(got, np_tree(jstate), EXACT)
    assert (got["bodies"]["inv_inertia"] > 0).sum() == 160


def test_state_round_trip_and_replicate():
    jstate, _ = jax_pyramid(JSolver.TGS_SOFT, 3)[0].freeze(
        contact_bucket_cap=-1, solve_joints=False, lane_solve=True, narrowphase="lanes"
    )
    jbatch = np_tree(replicate_state(jstate, 3))
    pbatch = replicate(state_from_numpy(np_tree(jstate), device="cpu"), 3)
    # exact: the port carries the JAX leaves bit for bit (uint32 filter bits too)
    assert_tree_close(to_numpy(pbatch), jbatch, dict(rtol=0, atol=0))
    back = state_from_numpy(to_numpy(pbatch), device="cpu")
    assert_tree_close(to_numpy(back), jbatch, dict(rtol=0, atol=0))
    assert to_numpy(back)["shapes"]["filter_mask"].dtype == np.uint32


def test_entry_points_default_to_the_card():
    """Without a card, freezing for the default device raises: no silent
    fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        pyramid_world(SolverType.TGS_SOFT, 3)[0].freeze(contact_bucket_cap=-1)
