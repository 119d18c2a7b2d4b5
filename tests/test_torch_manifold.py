"""The port's per-pair manifold (solver2d_tpu_torch.ops.manifold.collide,
K2's twin on CPU tensors) against the JAX package's `manifold.collide`,
vmapped over the pairs and run op by op (`jax.disable_jit()`), on the same
inputs.

The pairs: the cases of tests/test_manifold.py (a box resting on, sunk
into, tilted on, above and just apart from the ground; capsules; circles;
a box and a circle at a face, a corner and deep; the circle as shape A)
with its random box and rounded-box-and-capsule pairs, then random pairs of
every kind (tests/test_narrow_lanes.py) collided cold and again with their
own GJK caches. Point counts, feature ids and GJK caches are equal; floats
within 1e-5 (as in tests/test_torch_narrow.py), each compared where the
manifold has that point (the JAX function leaves the other point's fields
to its unused paths).

Rotations are given as (sin, cos) of float64 angles rounded to float32 on
both sides, so that both get the same bits."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from solver2d_tpu.ops import geometry as jgeometry
from solver2d_tpu.ops import manifold as jmanifold
from solver2d_tpu_torch.ops import manifold, narrow_cuda
from test_narrow_lanes import _random_batch

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
BOX = [(-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)]
GROUND = [(-10.0, -1.0), (10.0, -1.0), (10.0, 0.0), (-10.0, 0.0)]
CAP = [(-0.5, 0.0), (0.5, 0.0)]


def _geom(pts, radius=0.0):
    return jgeometry.polygon(pts, radius) if len(pts) > 2 else jgeometry.capsule(pts[0], pts[1], radius)


def _rot(angle):
    return np.array([np.sin(angle), np.cos(angle)], np.float32)


def _manifold_cases():
    """(geom A, (position, angle) A, geom B, (position, angle) B) of
    tests/test_manifold.py, its fixed cases and its random pairs."""
    g0 = ((0.0, 0.0), 0.0)
    ground, box = _geom(GROUND), _geom(BOX)
    cases = [(ground, g0, box, (p, a)) for p, a in [
        ((0.0, 0.503), 0.0), ((0.3, 0.45), 0.02), ((0.0, 0.72), 0.6), ((0.0, 2.0), 0.3), ((0.0, 0.512), 0.0)]]
    cases.append((ground, g0, _geom([(-0.4, 0.0), (0.4, 0.0)], 0.25), ((0.0, 0.26), 0.0)))
    cases.append((_geom(CAP, 0.2), g0, _geom(CAP, 0.2), ((0.3, 0.41), 0.1)))
    circle, small = jgeometry.circle((0.0, 0.0), 0.5), jgeometry.circle((0.0, 0.0), 0.3)
    cases.append((circle, g0, circle, ((0.95, 0.1), 0.0)))
    cases += [(box, g0, small, (p, 0.0)) for p in [(0.1, 0.79), (0.65, 0.65), (0.0, 0.3)]]
    cases.append((small, ((0.1, 0.79), 0.0), box, g0))
    rng = np.random.default_rng(7)
    for _ in range(60):
        hx, hy = rng.uniform(0.2, 1.0, 2)
        pos, ang = (rng.uniform(-1, 1), rng.uniform(0.0, 1.6)), rng.uniform(-1.5, 1.5)
        cases.append((ground, g0, _geom([(-hx, -hy), (hx, -hy), (hx, hy), (-hx, hy)]), (pos, ang)))
    rng = np.random.default_rng(3)
    for _ in range(40):
        r1, r2 = float(rng.uniform(0.0, 0.3)), float(rng.uniform(0.05, 0.3))
        pos, ang = (rng.uniform(-0.5, 0.5), rng.uniform(0.1, 1.2)), rng.uniform(-3, 3)
        cases.append((_geom(BOX, r1), ((0.0, 0.0), 0.1), _geom(CAP, r2), (pos, ang)))
    return cases


def _pack(cases):
    """The cases as collide's batched arguments (numpy), cold caches."""
    def geoms(gs):
        return (np.stack([g.verts for g in gs]).astype(np.float32), np.stack([g.normals for g in gs]).astype(np.float32),
                np.array([g.count for g in gs], np.int32), np.array([g.radius for g in gs], np.float32))

    n = len(cases)
    return (*geoms([c[0] for c in cases]), *geoms([c[2] for c in cases]),
            np.array([c[1][0] for c in cases], np.float32), np.stack([_rot(c[1][1]) for c in cases]),
            np.array([c[3][0] for c in cases], np.float32), np.stack([_rot(c[3][1]) for c in cases]),
            np.zeros(n, np.int32), np.zeros((n, 3), np.int32), np.zeros((n, 3), np.int32))


def _jax(args, gjk_iters):
    with jax.disable_jit():
        out = jax.vmap(partial(jmanifold.collide, gjk_iters=gjk_iters))(*(jnp.asarray(a) for a in args))
    return jmanifold.ManifoldOut(*(np.asarray(x) for x in out))


def _port(args, gjk_iters):
    out = manifold.collide(*(torch.from_numpy(np.array(a)) for a in args), gjk_iters=gjk_iters)
    return manifold.ManifoldOut(*(x.numpy() for x in out))


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.point_count, ref.point_count)
    np.testing.assert_array_equal(got.cache_count, ref.cache_count)
    np.testing.assert_array_equal(got.cache_ia, ref.cache_ia)
    np.testing.assert_array_equal(got.cache_ib, ref.cache_ib)
    has = ref.point_count >= 1
    pts = np.arange(2)[None] < ref.point_count[:, None]
    np.testing.assert_allclose(got.normal[has], ref.normal[has], **TOL)
    np.testing.assert_array_equal(got.point_id[pts], ref.point_id[pts])
    for k in ("anchor_a", "anchor_b", "separation"):
        np.testing.assert_allclose(getattr(got, k)[pts], getattr(ref, k)[pts], err_msg=k, **TOL)


def test_collide_matches_jax_on_the_manifold_cases():
    """tests/test_manifold.py's pairs at the default 20 GJK iterations."""
    args = _pack(_manifold_cases())
    got, ref = _port(args, 20), _jax(args, 20)
    _assert_same(got, ref)
    assert got.point_count.dtype == np.int32 and got.point_id.dtype == np.int32
    assert (ref.point_count == 2).sum() > 20 and (ref.point_count == 1).sum() > 3 and (ref.point_count == 0).any()


def test_collide_matches_jax_on_random_pairs_cold_and_warm(seed=21):
    """Random circles, capsules, boxes and polygons, then the same pairs
    with the caches the first collide returned."""
    ga, gb, *rest = _random_batch(48, seed=seed)
    args = tuple(np.asarray(x) for x in (*ga, *gb, *rest))
    ref = _jax(args, 10)
    _assert_same(_port(args, 10), ref)
    warm = args[:12] + (ref.cache_count, ref.cache_ia, ref.cache_ib)
    assert (ref.cache_count > 0).all()
    _assert_same(_port(warm, 10), _jax(warm, 10))


def test_collide_takes_any_batch_shape_and_launches_nothing_on_the_cpu():
    """A [3, 4] batch equals the flat batch of 12 pairs, a single pair
    (no batch dims) equals its element; on CPU tensors no kernel runs."""
    args = [torch.from_numpy(np.array(a)) for a in _pack(_manifold_cases()[:12])]
    before = narrow_cuda.collide.launches
    flat = manifold.collide(*args)
    grid = manifold.collide(*(a.reshape((3, 4) + tuple(a.shape[1:])) for a in args))
    one = manifold.collide(*(a[5] for a in args))
    assert narrow_cuda.collide.launches == before
    for f, g, o in zip(flat, grid, one):
        assert g.shape == (3, 4) + f.shape[1:] and o.shape == f.shape[1:]
        assert torch.equal(g.reshape(f.shape), f) and torch.equal(o, f[5])
