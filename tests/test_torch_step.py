"""The port's slice as a whole: `step_batch` of solver2d_tpu_torch against
the JAX package's lane `step_batch` for 3 steps on the same batch.

The configuration is the lane dryrun scene of `__graft_entry__.py`
(base-3 pyramid, PGS_Soft, one iteration, GJK 4, bucket cap auto), at its
4 colors and at the bench's 9, and the same scene under SoftStep (2
substeps, 9 colors). Positions, impulses, colors and diagnostics are
compared after every step: integers exactly, floats at float32 round-off.

The JAX lane step runs in JAX's default eager mode, not op by op under
`jax.disable_jit()` as the other port tests run JAX: the lane step has no
`lax.fori_loop` (its solver loops unroll in Python), so eager mode compiles
nothing larger than a jnp helper or a coloring round, and it dispatches its
helpers through their cached executables instead of retracing them at
every call; `cheap_compiles` compiles them at XLA's lowest optimization
level. From an empty compilation cache the two take a case from about 65 s
to about 45 s on one CPU core."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import lane_dryrun_state_cfg  # noqa: E402
from solver2d_tpu.config import SolverType as JSolver  # noqa: E402
from solver2d_tpu.parallel import replicate_state  # noqa: E402
from solver2d_tpu.step import step_batch as jax_step_batch  # noqa: E402
from solver2d_tpu_torch import SolverType, pyramid_world, replicate, step_batch, to_numpy  # noqa: E402
from torch_parity import F32, assert_tree_close, cheap_compiles, np_tree  # noqa: E402

torch.set_num_threads(1)
W = 2
STEPS = 3


def _check_steps(max_colors, solver="PGS_SOFT", **kw):
    jstate, jcfg = lane_dryrun_state_cfg()
    jcfg = jcfg.replace(max_colors=max_colors, solver=JSolver[solver], **kw)
    pstate, pcfg = pyramid_world(SolverType[solver], 3)[0].freeze(
        device="cpu", iterations=jcfg.iterations, extra_iterations=jcfg.extra_iterations,
        gjk_iters=jcfg.gjk_iters, max_colors=max_colors, contact_bucket_cap=jcfg.contact_bucket_cap,
    )
    assert (pcfg.max_contacts, pcfg.contact_bucket_cap) == (jcfg.max_contacts, jcfg.contact_bucket_cap)
    jb = replicate_state(jstate, W)
    pb = replicate(pstate, W)
    with cheap_compiles():
        for _ in range(STEPS):
            jb = jax_step_batch(jb, 1.0 / 60.0, jcfg)
            pb = step_batch(pb, 1.0 / 60.0, pcfg)
            ref = np_tree(jb)
            got = to_numpy(pb)
            assert_tree_close(got, ref, F32)
    assert got["diag"]["contact_count"][0] > 0
    assert (got["contacts"]["normal_impulse"] > 0).any()


@pytest.mark.parametrize("max_colors", [4, 9])
def test_step_batch_matches_jax(max_colors):
    _check_steps(max_colors)


def test_step_batch_matches_jax_soft_step():
    _check_steps(9, "SOFT_STEP", iterations=2)
