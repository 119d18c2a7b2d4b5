"""Shapes of the port (solver2d_tpu_torch.ops.geometry, ops.hull, World's
shape constructors) against the JAX package, on seeded numpy inputs.

Vertices, normals, counts and radii of every constructor are equal; mass,
center and inertia are bit-equal: the port's float32 scene compiler
(`native.shape_mass`) to the JAX `World`'s (`csrc/s2native.cpp:
s2n_shape_mass`), the port's float64 `compute_mass` to the JAX package's
(the path of its build-time `apply_linear_impulse`). Hulls are equal."""

import numpy as np
import pytest
import torch

from solver2d_tpu import native
from solver2d_tpu.config import BodyType as JBody
from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.ops import geometry as jgeom
from solver2d_tpu.ops.hull import compute_hull as jax_hull
from solver2d_tpu.world import World as JWorld
from solver2d_tpu_torch import BodyType, SolverType, World, to_numpy
from solver2d_tpu_torch import native as port_native
from solver2d_tpu_torch.ops import geometry
from solver2d_tpu_torch.ops.hull import compute_hull
from torch_parity import assert_tree_close, np_tree

torch.set_num_threads(1)
EXACT = dict(rtol=0, atol=0)


def _random_shapes(seed, n=40):
    """n (constructor name, args) of every kind, seeded."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = ["circle", "capsule", "segment", "offset_box", "box", "polygon"][i % 6]
        if kind == "circle":
            args = (rng.normal(size=2), float(rng.uniform(0.05, 2.0)))
        elif kind in ("capsule", "segment"):
            p1 = rng.normal(size=2) * 3
            p2 = p1 + rng.normal(size=2) + 0.5
            args = (p1, p2, float(rng.uniform(0.01, 1.0))) if kind == "capsule" else (p1, p2)
        elif kind == "offset_box":
            args = (float(rng.uniform(0.05, 10)), float(rng.uniform(0.05, 2)), rng.normal(size=2) * 5,
                    float(rng.uniform(-np.pi, np.pi)))
        elif kind == "box":
            args = (float(rng.uniform(0.05, 3)), float(rng.uniform(0.05, 3)), float(rng.choice([0.0, 0.1])))
        else:
            k = rng.randint(3, 9)
            ang = np.linspace(0, 2 * np.pi, k, endpoint=False) + rng.uniform(0, 1)
            args = (np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(0.3, 2.0) + rng.normal(size=2),
                    float(rng.choice([0.0, 0.05])))
        out.append((kind, args, float(rng.uniform(0.1, 100.0))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_constructors_and_mass_match_jax(seed):
    assert native.available()
    for kind, args, density in _random_shapes(seed):
        g, j = getattr(geometry, kind)(*args), getattr(jgeom, kind)(*args)
        assert (g.count, int(g.source_type)) == (j.count, int(j.source_type)), kind
        assert g.radius == j.radius, kind
        np.testing.assert_array_equal(g.verts, j.verts, err_msg=kind)
        np.testing.assert_array_equal(g.normals, j.normals, err_msg=kind)
        m32, c32, i32 = port_native.shape_mass(g.verts, g.normals, g.count, g.radius, density)
        m, c, inertia = native.shape_mass(j.verts, j.normals, j.count, j.radius, density)
        assert (np.float32(m32), np.float32(i32)) == (np.float32(m), np.float32(inertia)), kind
        np.testing.assert_array_equal(c32, c, err_msg=kind)
        m64, ref = geometry.compute_mass(g, density), jgeom.compute_mass(j, density)
        assert (m64.mass, m64.inertia) == (ref.mass, ref.inertia), kind
        np.testing.assert_array_equal(m64.center, ref.center, err_msg=kind)


def test_hull_matches_jax():
    rng = np.random.RandomState(3)
    clouds = [rng.normal(size=(rng.randint(3, 9), 2)) for _ in range(60)]
    clouds += [np.array([[0, 0], [1, 0], [2, 0], [1, 1e-4]]),  # collinear band: degenerate
               np.array([[0, 0], [1e-3, 0], [0, 1e-3]]),  # welded
               np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]])]  # an inner point
    for pts in clouds:
        got, want = compute_hull(pts), jax_hull(pts)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    assert sum(jax_hull(p) is None for p in clouds) >= 2


def test_world_shapes_and_impulse_match_jax():
    """Every shape constructor of `World` on bodies with off-center and
    several shapes, a build-time impulse (mass computed then, in float64)
    and a spinning body: the frozen states are equal."""
    rng = np.random.RandomState(5)

    def build(W, B, solver):
        w = W(solver=solver)
        g = w.create_body(type=B.STATIC)
        w.create_segment_shape(g, (-20.0, 0.0), (20.0, 0.0), friction=0.4)
        w.create_capsule_shape(g, (-20.0, 0.0), (-20.0, 5.0), 0.5)
        for i in range(6):
            b = w.create_body(type=B.DYNAMIC, position=tuple(rng.normal(size=2) * 4 + [0, 6]),
                              angle=float(rng.uniform(-1, 1)), angular_velocity=float(rng.normal()))
            w.create_circle_shape(b, tuple(rng.normal(size=2) * 0.3), 0.3, density=2.0)
            w.create_capsule_shape(b, (0.1, -0.2), (0.4, 0.5), 0.1, density=0.5, filter_group=-1)
            w.create_polygon_shape(b, jgeom.offset_box(0.3, 0.2, (0.5, 0.1), 0.3).verts[:4], density=3.0)
            if i % 2:
                w.apply_linear_impulse(b, (0.5, -0.2), (float(w.body_position(b)[0]) + 0.3, 6.0))
        return w

    state = rng.get_state()
    pstate, pcfg = build(World, BodyType, SolverType.TGS_SOFT).freeze(device="cpu", lane_solve=False)
    rng.set_state(state)
    jstate, jcfg = build(JWorld, JBody, JSolver.TGS_SOFT).freeze()
    assert_tree_close(to_numpy(pstate), np_tree(jstate), EXACT)
    assert float(np.abs(np.asarray(jstate.bodies.local_center)).max()) > 0.05
    assert float(np.abs(np.asarray(jstate.bodies.w)).max()) > 0
    for f in pcfg.__dataclass_fields__:
        if f != "use_fused_solver":  # the port's own field, resolved to K1 here
            assert getattr(pcfg, f) == getattr(jcfg, f), f
    assert pcfg.use_fused_solver is True
