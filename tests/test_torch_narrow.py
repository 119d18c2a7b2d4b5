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


def test_update_manifolds_per_world_matches_jax():
    """Two worlds of the base-3 pyramid posed differently (seeded jitter of
    positions and angles), their own pairs, through the port's per-world
    narrowphase (the worlds flattened into one lane batch) and the JAX
    `update_manifolds(impl="lanes")` on each world: cold, then warm from
    the first call's caches. Integers equal, floats at f32 round-off."""
    import dataclasses

    import jax.numpy as jnp

    import solver2d_tpu_torch.step as pstep
    from solver2d_tpu.step import _pre_solve, update_manifolds
    from solver2d_tpu_torch.state import Contacts, from_numpy, state_from_numpy, to_numpy
    from torch_parity import jax_world_scene, np_tree, stack

    jstate, jcfg = jax_world_scene("pyramid")
    rng = np.random.RandomState(21)
    worlds = []
    for _ in range(2):
        b = jstate.bodies
        dyn = (np.asarray(b.type) == 2)[:, None]
        ang = rng.normal(scale=0.05, size=b.rot.shape[0]).astype(np.float32)
        rot = np.where(dyn, np.stack([np.sin(ang), np.cos(ang)], -1), np.asarray(b.rot)).astype(np.float32)
        org = (np.asarray(b.origin) + np.where(dyn, rng.normal(scale=0.03, size=b.origin.shape), 0)).astype(np.float32)
        worlds.append(dataclasses.replace(jstate, bodies=dataclasses.replace(b, origin=jnp.asarray(org), rot=jnp.asarray(rot))))
    refs, cold = [], []
    with jax.disable_jit():
        for s in worlds:
            contacts, _, _ = _pre_solve(s, jcfg)  # pairs, match and a first (cold) narrowphase
            cold.append(contacts)
            refs.append(update_manifolds(s, contacts, gjk_iters=jcfg.gjk_iters, impl="lanes"))
    batch = state_from_numpy(stack(worlds), "cpu")
    contacts = from_numpy(Contacts, stack(cold), "cpu")
    got = pstep.update_manifolds(batch, contacts, jcfg.gjk_iters, impl="lanes")
    for w in range(2):
        ref = np_tree(refs[w])
        for k, v in to_numpy(got).items():
            r = np.asarray(getattr(ref, k))
            if v.dtype.kind == "f":
                np.testing.assert_allclose(v[w], r, rtol=1e-5, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(v[w], r, err_msg=k)
    assert (got.point_count > 0).sum() > 0 and (got.cache_count[got.alive] > 0).all()
    assert not torch.equal(got.normal[0], got.normal[1])
    # the JAX package's per-pair "xla" narrowphase computes the same math:
    # the port runs K2 for it too; an unknown name raises
    xla = pstep.update_manifolds(batch, contacts, jcfg.gjk_iters, impl="xla")
    for k, v in to_numpy(got).items():
        np.testing.assert_array_equal(to_numpy(xla)[k], v, err_msg=k)
    with pytest.raises(ValueError):
        pstep.update_manifolds(batch, contacts, jcfg.gjk_iters, impl="gjk")
