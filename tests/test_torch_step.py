"""The port's slice as a whole: `step_batch` of solver2d_tpu_torch against
the JAX package's lane `step_batch` for 3 steps on the same batch.

The configuration is the lane dryrun scene of `__graft_entry__.py`
(base-3 pyramid, PGS_Soft, one iteration, GJK 4, bucket cap auto), at its
4 colors and at the bench's 9. Positions, impulses, colors and diagnostics
are compared after every step: integers exactly, floats at float32
round-off."""

import os
import sys

import jax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import lane_dryrun_state_cfg  # noqa: E402
from solver2d_tpu.parallel import replicate_state  # noqa: E402
from solver2d_tpu.step import step_batch as jax_step_batch  # noqa: E402
from solver2d_tpu_torch import SolverType, pyramid_world, replicate, step_batch, to_numpy  # noqa: E402
from torch_parity import F32, assert_tree_close, np_tree  # noqa: E402

torch.set_num_threads(1)
W = 2
STEPS = 3


@pytest.mark.parametrize("max_colors", [4, 9])
def test_step_batch_matches_jax(max_colors):
    jstate, jcfg = lane_dryrun_state_cfg()
    jcfg = jcfg.replace(max_colors=max_colors)
    pstate, pcfg = pyramid_world(SolverType.PGS_SOFT, 3)[0].freeze(
        device="cpu", iterations=jcfg.iterations, extra_iterations=jcfg.extra_iterations,
        gjk_iters=jcfg.gjk_iters, max_colors=max_colors, contact_bucket_cap=jcfg.contact_bucket_cap,
    )
    assert (pcfg.max_contacts, pcfg.contact_bucket_cap) == (jcfg.max_contacts, jcfg.contact_bucket_cap)
    jb = replicate_state(jstate, W)
    pb = replicate(pstate, W)
    for _ in range(STEPS):
        with jax.disable_jit():
            jb = jax_step_batch(jb, 1.0 / 60.0, jcfg)
        pb = step_batch(pb, 1.0 / 60.0, pcfg)
        ref = np_tree(jb)
        got = to_numpy(pb)
        assert_tree_close(got, ref, F32)
    assert got["diag"]["contact_count"][0] > 0
    assert (got["contacts"]["normal_impulse"] > 0).any()
