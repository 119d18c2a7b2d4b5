"""Port narrowphase: the plain twin of K2 (solver2d_tpu_torch.ops.
narrow_lanes) vs the JAX package's `collide_lanes_xla` and its Pallas kernel
in interpret mode, and the K2 wrapper on CPU tensors. K2 itself is held
against the twin on the card by tests/test_torch_card.py."""

import jax
import numpy as np
import pytest
import torch

from solver2d_tpu.ops.narrow_pallas import collide_lanes_pallas, collide_lanes_xla
from solver2d_tpu_torch.ops import narrow_cuda
from solver2d_tpu_torch.ops.narrow_lanes import collide_lanes_plain
from test_narrow_lanes import _lanes_inputs, _random_batch

torch.set_num_threads(1)
GJK_ITERS = 10


def _port_inputs(gaT, gbT, paT, pbT, cacheT):
    """The JAX lane inputs (per-contact geometry columns) as the port's
    shape table + shape indices with a worlds dim of 1."""
    n = gaT.shape[1]
    geom = torch.from_numpy(np.concatenate([np.asarray(gaT).T, np.asarray(gbT).T]))
    sa = torch.arange(n, dtype=torch.int32)
    return (
        geom, sa, sa + n,
        torch.from_numpy(np.array(paT))[None], torch.from_numpy(np.array(pbT))[None],
        torch.from_numpy(np.array(cacheT))[None],
    )


def _assert_same(port, ref):
    fout, iout, cout = (x[0].numpy() for x in port)
    rf, ri, rc = (np.asarray(x) for x in ref)
    # ids, point counts and GJK caches exactly; floats at f32 round-off
    np.testing.assert_array_equal(iout, ri)
    np.testing.assert_array_equal(cout, rc)
    np.testing.assert_allclose(fout, rf, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [3, 5])
def test_twin_matches_jax_random_pairs(seed):
    lanes = _lanes_inputs(*_random_batch(64, seed=seed))
    with jax.disable_jit():
        ref = collide_lanes_xla(*lanes, GJK_ITERS)
    _assert_same(collide_lanes_plain(*_port_inputs(*lanes), GJK_ITERS), ref)


def test_twin_matches_jax_warm_cache():
    """A second collide with the first call's GJK cache (warm start)."""
    lanes = _lanes_inputs(*_random_batch(64, seed=7))
    with jax.disable_jit():
        _, _, cout = collide_lanes_xla(*lanes, GJK_ITERS)
        lanes = lanes[:4] + (cout,)
        ref = collide_lanes_xla(*lanes, GJK_ITERS)
    assert (np.asarray(cout)[0] > 0).all()
    _assert_same(collide_lanes_plain(*_port_inputs(*lanes), GJK_ITERS), ref)


def test_twin_matches_pallas_interpret():
    """The TPU kernel K2 replaces, run in interpret mode, on 16 pairs. Two
    GJK trips: interpret mode costs about 10 s per trip on the CPU, and the
    trip count is a loop bound, not a different computation."""
    lanes = _lanes_inputs(*_random_batch(16, seed=11))
    ref = collide_lanes_pallas(*lanes, 2, interpret=True)
    _assert_same(collide_lanes_plain(*_port_inputs(*lanes), 2), ref)


def test_wrapper_runs_the_twin_on_cpu_tensors():
    lanes = _lanes_inputs(*_random_batch(16, seed=13))
    args = _port_inputs(*lanes)
    before = narrow_cuda.collide.launches
    got = narrow_cuda.collide(*args, GJK_ITERS)
    want = collide_lanes_plain(*args, GJK_ITERS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert narrow_cuda.collide.launches == before  # no kernel launched
