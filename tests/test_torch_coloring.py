"""Port coloring (solver2d_tpu_torch.ops.coloring, solvers.common.
make_body_map) vs the JAX package on the same random constraint graphs.
Colors fix the Gauss-Seidel order, so every output must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.ops import coloring as jcol
from solver2d_tpu.solvers.common import make_body_map as j_make_body_map
from solver2d_tpu_torch.ops import coloring as pcol
from solver2d_tpu_torch.solvers.common import make_body_map as p_make_body_map

torch.set_num_threads(1)


def _graph(seed, N=600, B=120, K=9):
    rng = np.random.RandomState(seed)
    ba = rng.randint(0, B, N).astype(np.int32)
    bb = rng.randint(0, B, N).astype(np.int32)
    active = rng.rand(N) < 0.85
    dyn = rng.rand(B) < 0.9
    # carried colors: valid, out of range, and uncolored
    carried = rng.randint(-1, K + 3, N).astype(np.int32)
    return ba, bb, active, dyn, carried


def _t(x):
    return torch.from_numpy(np.array(x))


def test_hash_priority_wraps_like_jax():
    # idx * 2654435761 crosses a multiple of 2^31 about every 0.809 indices:
    # cover small indices densely and large ones near the int32 limit
    idx = np.concatenate([
        np.arange(0, 20000), np.arange(2**31 - 5000, 2**31 - 1),
        np.random.RandomState(0).randint(0, 2**31 - 1, 5000),
    ]).astype(np.int32)
    ref = np.asarray(jcol._hash_priority(jnp.asarray(idx)))
    got = pcol._hash_priority(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).all()


@pytest.mark.parametrize("seed,cap", [(0, 0), (1, 0), (2, 60), (3, 40)])
def test_assign_colors_matches_jax(seed, cap):
    ba, bb, active, dyn, carried = _graph(seed)
    B, K = 120, 9
    with jax.disable_jit():
        jc, jo = jcol.assign_colors(
            jnp.asarray(carried), jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(active),
            jnp.asarray(dyn), B, K, rounds=8, bucket_cap=cap,
        )
    pc, po = pcol.assign_colors(_t(carried), _t(ba), _t(bb), _t(active), _t(dyn), B, K, rounds=8, bucket_cap=cap)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert int(po) == int(jo)


@pytest.mark.parametrize("seed,cap", [(4, 40), (5, 80)])
def test_buckets_and_body_map_match_jax(seed, cap):
    ba, bb, active, dyn, carried = _graph(seed)
    B, K = 120, 9
    with jax.disable_jit():
        jc, _ = jcol.assign_colors(
            jnp.asarray(carried), jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(active),
            jnp.asarray(dyn), B, K, bucket_cap=cap,
        )
        jact = jnp.asarray(active) & (jc >= 0)
        jbucket, jnew, jdrop = jcol.build_color_buckets(jc, jact, K, cap)
        jbi = jnp.maximum(jbucket, 0)
        color_b = jnp.repeat(jnp.arange(K, dtype=jnp.int32), cap)
        jmap = j_make_body_map(
            jnp.asarray(ba)[jbi], jnp.asarray(bb)[jbi], color_b, jact[jbi] & (jbucket >= 0),
            jnp.asarray(dyn), B, K,
        )
    pc = _t(np.asarray(jc))
    pact = _t(active) & (pc >= 0)
    pbucket, pnew, pdrop = pcol.build_color_buckets(pc, pact, K, cap)
    np.testing.assert_array_equal(pbucket.numpy(), np.asarray(jbucket))
    np.testing.assert_array_equal(pnew.numpy(), np.asarray(jnew))
    assert int(pdrop) == int(jdrop)
    pbi = torch.clamp(pbucket, min=0)
    pmap = p_make_body_map(
        _t(ba)[pbi], _t(bb)[pbi], torch.arange(K, dtype=torch.int32).repeat_interleave(cap),
        pact[pbi] & (pbucket >= 0), _t(dyn), B, K,
    )
    np.testing.assert_array_equal(pmap.slot.numpy(), np.asarray(jmap.slot))
    np.testing.assert_array_equal(pmap.winner.numpy(), np.asarray(jmap.winner))


def test_assign_colors_and_body_map_per_world_match_jax():
    """A batch of two different graphs, colored at once (bucket_cap 0, as
    the per-world step colors contacts and joints), and their body maps
    with endpoints A written only where `write_a_extra` (mouse joints never
    write body A): each world equal to the JAX function on its own graph."""
    B, K = 120, 9
    graphs = [_graph(seed) for seed in (6, 7)]
    extra = [np.random.RandomState(s).rand(600) < 0.8 for s in (8, 9)]
    pc, po = pcol.assign_colors(*(torch.stack([_t(g[i]) for g in graphs]) for i in (4, 0, 1, 2, 3)), B, K)
    pact = torch.stack([_t(g[2]) for g in graphs]) & (pc >= 0)
    pmap = p_make_body_map(
        torch.stack([_t(g[0]) for g in graphs]), torch.stack([_t(g[1]) for g in graphs]), pc, pact,
        torch.stack([_t(g[3]) for g in graphs]), B, K, write_a_extra=torch.stack([_t(e) for e in extra]),
    )
    for w, (ba, bb, active, dyn, carried) in enumerate(graphs):
        with jax.disable_jit():
            jc, jo = jcol.assign_colors(
                jnp.asarray(carried), jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(active), jnp.asarray(dyn), B, K,
            )
            jmap = j_make_body_map(
                jnp.asarray(ba), jnp.asarray(bb), jc, jnp.asarray(active) & (jc >= 0), jnp.asarray(dyn), B, K,
                write_a_extra=jnp.asarray(extra[w]),
            )
        np.testing.assert_array_equal(pc[w].numpy(), np.asarray(jc))
        assert int(po[w]) == int(jo)
        np.testing.assert_array_equal(pmap.slot[w].numpy(), np.asarray(jmap.slot))
        np.testing.assert_array_equal(pmap.winner[w].numpy(), np.asarray(jmap.winner))
    assert not torch.equal(pc[0], pc[1])
