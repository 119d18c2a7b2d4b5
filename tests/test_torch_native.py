"""The port's batched scene compiler (solver2d_tpu_torch.native, tensor ops
on the host) against the JAX package's, the C++ library csrc/s2native.cpp
through ctypes, and `World(defer_mass=...)` against the JAX `World`.

- `compile_scene` on every catalog scene at its published size: every
  output equal bit for bit; on random scenes of bodies with several shapes
  each (rounded polygons, circles, capsules, shapes of zero density,
  statics, a shape on no body, any angle): the mass properties bit for bit,
  the AABBs within 4 float32 ulps of their coordinates, because the C++
  takes the float32 `std::sin` and `std::cos` of the angle, which are not
  correctly rounded on every angle, and the port rounds float64 ones (the
  rotations of `math2d.make_rot`; ROADMAP section 3);
- `shape_mass` on random shapes of every kind, bit for bit;
- a world built with `defer_mass=False` (mass in float64 at each
  `create_shape`) and with the default `defer_mass=True` (one
  `compile_scene` at freeze), each frozen equal to the JAX `World` built the
  same way, bit for bit, a spinning multi-shape body and a build-time
  impulse among them.

The JAX package's library needs g++; without one, these tests skip, as
tests/test_native.py does."""

import dataclasses

import numpy as np
import pytest

from solver2d_tpu import native as jax_native
from solver2d_tpu.config import AABB_MARGIN, SPECULATIVE_DISTANCE
from solver2d_tpu.config import BodyType as JBody
from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models import SCENES as JSCENES
from solver2d_tpu.models import scene_names
from solver2d_tpu.ops import geometry as jgeometry
from solver2d_tpu.world import World as JWorld
from solver2d_tpu_torch import BodyType, SolverType, World, native, to_numpy
from solver2d_tpu_torch.ops import geometry
from torch_parity import assert_tree_close, np_tree

pytestmark = pytest.mark.skipif(not jax_native.available(), reason="the JAX package's C++ library needs g++")
EXACT = dict(rtol=0, atol=0)


def _scene_arrays(world):
    """compile_scene's arguments for a JAX `World`, as its freeze makes them."""
    return (
        np.stack([s.geom.verts for s in world.shapes]).astype(np.float32),
        np.stack([s.geom.normals for s in world.shapes]).astype(np.float32),
        np.array([s.geom.count for s in world.shapes], np.int32),
        np.array([s.geom.radius for s in world.shapes], np.float32),
        np.array([s.def_.density if s.alive else 0.0 for s in world.shapes], np.float32),
        np.array([s.body for s in world.shapes], np.int32),
        np.array([b.def_.position for b in world.bodies], np.float32).reshape(-1, 2),
        np.array([b.def_.angle for b in world.bodies], np.float32),
        np.array([int(b.def_.type) for b in world.bodies], np.int32),
        SPECULATIVE_DISTANCE, AABB_MARGIN,
    )


def _assert_bits_equal(got: dict, want: dict, aabb_ulps=0):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.float32 and g.shape == w.shape, k
        if aabb_ulps and k in ("aabb", "fat_aabb"):
            np.testing.assert_allclose(g, w, rtol=aabb_ulps * 2.0**-23, atol=0, err_msg=k)
            continue
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=k)


def _random_geom(rng):
    kind = rng.randint(5)
    c = rng.uniform(-1.5, 1.5, 2)
    if kind == 0:
        return jgeometry.circle(c, rng.uniform(0.05, 1.0))
    if kind == 1:
        return jgeometry.capsule(c, c + rng.uniform(-1.5, 1.5, 2), rng.uniform(0.0, 0.5))
    if kind == 2:
        return jgeometry.box(*rng.uniform(0.1, 1.0, 2), radius=rng.choice([0.0, rng.uniform(0.01, 0.2)]))
    if kind == 3:
        return jgeometry.offset_box(*rng.uniform(0.1, 1.0, 2), c, rng.uniform(-3, 3))
    k = rng.randint(3, 9)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k)) + np.arange(k) * 1e-2
    return jgeometry.polygon(c + np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(0.2, 1.5),
                             rng.choice([0.0, rng.uniform(0.01, 0.3)]))


@pytest.mark.parametrize("key", scene_names(), ids=lambda k: f"{k[0]}-{k[1]}")
def test_compile_scene_matches_cpp_on_the_catalog(key):
    args = _scene_arrays(JSCENES[key](JSolver.TGS_SOFT).world)
    _assert_bits_equal(native.compile_scene(*args), jax_native.compile_scene(*args))


@pytest.mark.parametrize("seed", [0, 1])
def test_compile_scene_matches_cpp_on_random_multi_shape_bodies(seed):
    """Bodies of 1-6 shapes each, so that a body's sums take several rounds;
    statics, kinematics, shapes of zero density and one shape on no body."""
    rng = np.random.RandomState(seed)
    nb = 40
    geoms = [_random_geom(rng) for _ in range(150)]
    body = rng.randint(0, nb, len(geoms)).astype(np.int32)
    body[7] = -1
    dens = rng.uniform(0.2, 3.0, len(geoms)).astype(np.float32)
    dens[rng.rand(len(geoms)) < 0.1] = 0.0
    btype = rng.choice([0, 1, 2, 2, 2], nb).astype(np.int32)
    args = (
        np.stack([g.verts for g in geoms]).astype(np.float32), np.stack([g.normals for g in geoms]).astype(np.float32),
        np.array([g.count for g in geoms], np.int32), np.array([g.radius for g in geoms], np.float32), dens, body,
        rng.uniform(-50, 50, (nb, 2)).astype(np.float32), rng.uniform(-7, 7, nb).astype(np.float32), btype,
        SPECULATIVE_DISTANCE, AABB_MARGIN,
    )
    assert np.bincount(body[body >= 0]).max() >= 5
    got, want = native.compile_scene(*args), jax_native.compile_scene(*args)
    _assert_bits_equal(got, want, aabb_ulps=4)
    assert (want["mass"] > 0).sum() > 10


def test_shape_mass_matches_cpp():
    rng = np.random.RandomState(3)
    for _ in range(60):
        g = _random_geom(rng)
        d = float(np.float32(rng.uniform(0.3, 3.0)))
        m, c, inertia = native.shape_mass(g.verts, g.normals, g.count, g.radius, d)
        jm, jc, ji = jax_native.shape_mass(g.verts, g.normals, g.count, g.radius, d)
        assert (np.float32(m), np.float32(inertia)) == (np.float32(jm), np.float32(ji))
        np.testing.assert_array_equal(c, jc)
        assert c.dtype == np.float32


def _build(lib, defer):
    """The scene of tests/test_native.py, in either package, plus a
    build-time impulse on a second spinning multi-shape body."""
    W, geo, kinds = (
        (JWorld, jgeometry, JBody) if lib == "jax" else (World, geometry, BodyType)
    )
    solver = (JSolver if lib == "jax" else SolverType).TGS_SOFT
    w = W(solver=solver, defer_mass=defer)
    g = w.create_body(type=kinds.STATIC, position=(0, -1))
    w.create_polygon_shape(g, geo.box(10, 1))
    b1 = w.create_body(type=kinds.DYNAMIC, position=(0.3, 2.0), angle=0.4, angular_velocity=1.5)
    w.create_polygon_shape(b1, geo.box(0.5, 0.25), density=2.0)
    w.create_circle_shape(b1, (0.4, 0.1), 0.2, density=3.0)
    b2 = w.create_body(type=kinds.DYNAMIC, position=(-2.0, 1.0))
    w.create_capsule_shape(b2, (-0.4, 0.0), (0.4, 0.0), 0.15, density=1.5)
    b3 = w.create_body(type=kinds.DYNAMIC, position=(2.0, 1.0))
    w.create_polygon_shape(b3, geo.box(0.3, 0.3, radius=0.1), density=1.0)
    b4 = w.create_body(type=kinds.DYNAMIC, position=(4.0, 3.0), angle=-1.1, angular_velocity=-2.0)
    w.create_polygon_shape(b4, geo.offset_box(0.4, 0.2, (0.3, 0.1), 0.5), density=1.2)
    w.create_capsule_shape(b4, (0.0, 0.2), (0.5, 0.6), 0.1, density=0.7)
    w.create_segment_shape(g, (-3.0, 0.5), (3.0, 0.7))
    w.apply_linear_impulse(b4, (1.0, 2.0), (4.3, 3.2))
    state, cfg = w.freeze() if lib == "jax" else w.freeze(device="cpu", lane_solve=False)
    return state, cfg, w


@pytest.mark.parametrize("defer", [False, True], ids=["per-shape-f64", "deferred"])
def test_world_defer_mass_matches_jax(defer):
    jstate, _, jw = _build("jax", defer)
    pstate, _, pw = _build("port", defer)
    got = to_numpy(pstate)
    assert_tree_close(got, np_tree(jstate), EXACT)
    assert all(pb.mass == jb.mass and pb.inertia == jb.inertia for pb, jb in zip(pw.bodies, jw.bodies))
    # the spinning body's center-of-mass velocity fix-up moved its velocity
    assert np.abs(got["bodies"]["v"][1]).max() > 0 and got["bodies"]["local_center"][1].any()


def test_defer_mass_paths_differ_only_in_rounding():
    """The float64 path and the scene compiler's float32 agree to float32
    round-off on the same scene."""
    deferred, _, _ = _build("port", True)
    eager, _, _ = _build("port", False)
    for a, b in zip(dataclasses.astuple(deferred.bodies), dataclasses.astuple(eager.bodies)):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
