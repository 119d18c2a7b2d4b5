"""Port broadphase (solver2d_tpu_torch.ops.broadphase) vs the JAX package:
grid pairs, persistent lane matching, hashes and hysteresis, on the same
numpy inputs. Integer outputs are equal; carried values are copies."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models.contact_scenes import pyramid_world as jax_pyramid
from solver2d_tpu.ops import broadphase as jbp
from solver2d_tpu.parallel import replicate_state
from solver2d_tpu_torch import SolverType, pyramid_world
from solver2d_tpu_torch.ops import broadphase as pbp
from solver2d_tpu_torch.state import Contacts, Joints, Shapes, from_numpy, to_numpy
from torch_parity import assert_tree_close, np_tree

torch.set_num_threads(1)
EXACT = dict(rtol=0, atol=0)


def _scene(base, seed, jitter=0.06):
    """A frozen pyramid whose fat AABBs are shifted at random (pairs appear
    and vanish) and whose joints table holds a few live joints."""
    jstate, jcfg = jax_pyramid(JSolver.TGS_SOFT, base)[0].freeze(
        contact_bucket_cap=-1, solve_joints=False, lane_solve=True, narrowphase="lanes"
    )
    _, pcfg = pyramid_world(SolverType.TGS_SOFT, base)[0].freeze(device="cpu", contact_bucket_cap=-1)
    rng = np.random.RandomState(seed)
    fat = np.asarray(jstate.shapes.fat_aabb).copy()
    alive = np.asarray(jstate.shapes.alive)
    shift = rng.normal(scale=jitter, size=(fat.shape[0], 2)).astype(np.float32)
    fat[alive] += np.concatenate([shift, shift], axis=-1)[alive]
    nj = jstate.joints.alive.shape[0]
    nb = int(np.asarray(jstate.bodies.alive).sum())
    joints = dataclasses.replace(
        jstate.joints,
        body_a=jnp.asarray(rng.randint(0, nb, nj).astype(np.int32)),
        body_b=jnp.asarray(rng.randint(0, nb, nj).astype(np.int32)),
        alive=jnp.asarray(rng.rand(nj) < 0.7),
        collide_connected=jnp.asarray(rng.rand(nj) < 0.3),
    )
    jstate = dataclasses.replace(
        jstate, shapes=dataclasses.replace(jstate.shapes, fat_aabb=jnp.asarray(fat)), joints=joints
    )
    pstate = np_tree(jstate)
    return jstate, jcfg, pstate, pcfg


def _port_pairs(pstate, pcfg):
    shapes = from_numpy(Shapes, pstate.shapes, "cpu")
    body_type = torch.from_numpy(np.array(pstate.bodies.type))
    jointed = pbp.jointed_body_keys(from_numpy(Joints, pstate.joints, "cpu"), pcfg)
    return pbp.find_pairs_grid(shapes, body_type, jointed, pcfg), jointed


@pytest.mark.parametrize("base,seed", [(3, 0), (8, 1), (8, 2)])
def test_find_pairs_grid_matches_jax(base, seed):
    jstate, jcfg, pstate, pcfg = _scene(base, seed)
    with jax.disable_jit():
        jj = jbp.jointed_body_keys(jstate.joints, jcfg)
        jp = jbp.find_pairs_grid(jstate.shapes, jstate.bodies.type, jj, jcfg)
    pp, pj = _port_pairs(pstate, pcfg)
    np.testing.assert_array_equal(pj.numpy(), np.asarray(jj))
    for name in jp._fields:
        np.testing.assert_array_equal(
            getattr(pp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name
        )
    assert int(pp.count) > 0


def test_match_contacts_lane_matches_jax():
    W = 2
    rng = np.random.RandomState(5)
    jstate, jcfg, pstate, pcfg = _scene(8, 3)
    jstate2, _, pstate2, _ = _scene(8, 4)
    with jax.disable_jit():
        jj = jbp.jointed_body_keys(jstate.joints, jcfg)
        old_pairs = jbp.find_pairs_grid(jstate.shapes, jstate.bodies.type, jj, jcfg)
        new_pairs = jbp.find_pairs_grid(jstate2.shapes, jstate2.bodies.type, jj, jcfg)
    # an old table with old_pairs' layout and random carried values per world
    batch = replicate_state(jstate, W).contacts
    C = batch.key.shape[1]

    def r(*shape):
        return jnp.asarray(rng.normal(size=(W, C) + shape).astype(np.float32))

    def ri(lo, hi, *shape):
        return jnp.asarray(rng.randint(lo, hi, size=(W, C) + shape).astype(np.int32))

    key = jnp.broadcast_to(old_pairs.key, (W, C))
    old = dataclasses.replace(
        batch, key=key, normal=r(2), anchor_a=r(2, 2), anchor_b=r(2, 2), separation=r(2),
        normal_impulse=r(2), tangent_impulse=r(2), point_id=ri(0, 2000, 2),
        persisted=jnp.asarray(rng.rand(W, C, 2) < 0.5), point_count=ri(0, 3),
        cache_count=ri(0, 4), cache_index_a=ri(0, 8, 3), cache_index_b=ri(0, 8, 3),
        color=jnp.broadcast_to(ri(-1, 9)[0], (W, C)),
        alive=jnp.broadcast_to(old_pairs.valid & jnp.asarray(rng.rand(C) < 0.9), (W, C)),
    )
    s0 = jax.tree.map(lambda x: x[0], replicate_state(jstate2, W)).shapes
    with jax.disable_jit():
        jm = jbp.match_contacts_lane(old, new_pairs, s0, jstate2.bodies.type, s0.body)

    p_old = from_numpy(Contacts, np_tree(old), "cpu")
    p_new = pbp.PairResult(*(torch.from_numpy(np.array(x)) for x in np_tree(new_pairs)))
    pm = pbp.match_contacts_lane(p_old, p_new, from_numpy(Shapes, pstate2.shapes, "cpu"))
    assert_tree_close(to_numpy(pm), np_tree(jm), EXACT)
    carried = np.asarray(jm.cache_count) > 0
    assert carried.any() and not carried.all()


def test_cell_hash_wraps_like_jax():
    rng = np.random.RandomState(0)
    edges = np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**30, -(2**30), 1309, -1310], np.int32)
    cx = np.concatenate([edges, rng.randint(-(2**31), 2**31 - 1, 500).astype(np.int32)])
    cy = np.concatenate([edges[::-1], rng.randint(-(2**31), 2**31 - 1, 500).astype(np.int32)])
    ref = np.asarray(jbp._cell_hash(jnp.asarray(cx), jnp.asarray(cy)))
    got = pbp._cell_hash(torch.from_numpy(cx), torch.from_numpy(cy)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_update_fat_aabbs_matches_jax():
    rng = np.random.RandomState(1)
    S = 300
    lo = rng.normal(size=(S, 2)).astype(np.float32)
    aabb = np.concatenate([lo, lo + rng.uniform(0.1, 1, (S, 2)).astype(np.float32)], -1)
    fat = aabb + rng.normal(scale=0.05, size=(S, 4)).astype(np.float32) * np.array([-1, -1, 1, 1], np.float32)
    body_type = rng.randint(0, 3, S).astype(np.int32)
    jshapes = type("S", (), {"fat_aabb": jnp.asarray(fat)})
    ref = np.asarray(jbp.update_fat_aabbs(jshapes, jnp.asarray(aabb), jnp.asarray(body_type)))
    got = pbp.update_fat_aabbs(torch.from_numpy(fat), torch.from_numpy(aabb), torch.from_numpy(body_type))
    np.testing.assert_array_equal(got.numpy(), ref)


def _batch(trees, cls):
    return from_numpy(cls, jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees), "cpu")


def test_find_pairs_and_match_per_world_match_jax():
    """Two worlds whose shapes moved apart differently (fat AABBs jittered
    with other seeds), paired at once and matched against each world's own
    old table, which carries random values: each world equal to the JAX
    functions on its own state."""
    W = 2
    rng = np.random.RandomState(9)
    scenes = [_scene(8, seed) for seed in (6, 7)]
    olds = [_scene(8, seed) for seed in (10, 11)]
    jcfg, pcfg = scenes[0][1], scenes[0][3]
    ref_pairs, ref_match, old_tables = [], [], []
    for (jstate, _, _, _), (jold, _, _, _) in zip(scenes, olds):
        with jax.disable_jit():
            jj = jbp.jointed_body_keys(jstate.joints, jcfg)
            old_pairs = jbp.find_pairs_grid(jold.shapes, jold.bodies.type, jj, jcfg)
            new_pairs = jbp.find_pairs_grid(jstate.shapes, jstate.bodies.type, jj, jcfg)
        C = old_pairs.key.shape[0]

        def r(*shape):
            return jnp.asarray(rng.normal(size=(C,) + shape).astype(np.float32))

        def ri(lo, hi, *shape):
            return jnp.asarray(rng.randint(lo, hi, size=(C,) + shape).astype(np.int32))

        old = dataclasses.replace(
            jstate.contacts, key=old_pairs.key, shape_a=old_pairs.shape_a, shape_b=old_pairs.shape_b,
            normal=r(2), anchor_a=r(2, 2), anchor_b=r(2, 2), separation=r(2),
            normal_impulse=r(2), tangent_impulse=r(2), point_id=ri(0, 2000, 2),
            persisted=jnp.asarray(rng.rand(C, 2) < 0.5), point_count=ri(0, 3), cache_count=ri(0, 4),
            cache_index_a=ri(0, 8, 3), cache_index_b=ri(0, 8, 3), color=ri(-1, 9),
            alive=old_pairs.valid & jnp.asarray(rng.rand(C) < 0.9),
        )
        with jax.disable_jit():
            jm = jbp.match_contacts(old, new_pairs, jstate.shapes, jstate.bodies.type, jstate.shapes.body)
        ref_pairs.append(new_pairs)
        ref_match.append(jm)
        old_tables.append(old)

    shapes = _batch([s[0].shapes for s in scenes], Shapes)
    body_type = torch.from_numpy(np.stack([np.asarray(s[0].bodies.type) for s in scenes]))
    jointed = pbp.jointed_body_keys(_batch([s[0].joints for s in scenes], Joints), pcfg)
    pp = pbp.find_pairs_grid(shapes, body_type, jointed, pcfg)
    pm = pbp.match_contacts(_batch(old_tables, Contacts), pp, shapes)
    for w in range(W):
        for name in ref_pairs[w]._fields:
            np.testing.assert_array_equal(
                getattr(pp, name)[w].numpy(), np.asarray(getattr(ref_pairs[w], name)), err_msg=name
            )
        assert_tree_close({k: v[w] for k, v in to_numpy(pm).items()}, np_tree(ref_match[w]), EXACT)
    assert not torch.equal(pp.key[0], pp.key[1])
    carried = pm.cache_count > 0
    assert carried.any() and not carried.all()
