"""The port's kernels against their plain twins on the card: K2
(solver2d_tpu_torch/csrc/narrow.cu) and K1 (csrc/fused_solve.cu) in each of
its scripts.

Needs a CUDA card and nvcc; skips without them. It imports neither jax nor
the JAX package, so it also runs on a machine without JAX, where
tests/conftest.py (which imports jax) must be left out:

    python -m pytest --noconftest tests/test_torch_card.py -q
"""

import numpy as np
import pytest
import torch

from solver2d_tpu_torch.ops import geometry, narrow_cuda
from solver2d_tpu_torch.ops.narrow_lanes import collide_lanes_plain

torch.set_num_threads(1)
GJK_ITERS = 10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode (their twins are tested on the CPU)")
    return torch.device("cuda", 0)


def _padded_row(verts, normals, radius):
    """A shape-table row: vertices and normals padded to 8 with the last one
    (the layout of `ops.geometry`), count, radius."""
    k = len(verts)
    v = np.concatenate([verts, np.repeat(verts[-1:], 8 - k, 0)])
    nm = np.concatenate([normals, np.repeat(normals[-1:], 8 - k, 0)])
    return np.concatenate([v[:, 0], v[:, 1], nm[:, 0], nm[:, 1], [k, radius]]).astype(np.float32)


def _random_pairs(n, W, seed):
    """n random shapes (circles, capsules, convex polygons of 3..8 vertices,
    some rounded) as a shape table, n contacts between them, and random
    poses in W worlds."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        kind = rng.randint(4)
        if kind == 0:  # circle: one vertex + radius
            rows.append(_padded_row(rng.uniform(-0.3, 0.3, (1, 2)), np.array([[0.0, 1.0]]), rng.uniform(0.2, 1.0)))
            continue
        if kind == 1:  # capsule: two vertices + radius
            p = rng.uniform(-1, 1, (2, 2))
            ax = (p[1] - p[0]) / np.linalg.norm(p[1] - p[0])
            nrm = np.array([ax[1], -ax[0]])
            rows.append(_padded_row(p, np.stack([nrm, -nrm]), rng.uniform(0.1, 0.5)))
            continue
        k = rng.randint(3, 9)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        if np.diff(np.concatenate([ang, ang[:1] + 2 * np.pi])).min() < 0.2:
            ang = np.linspace(0, 2 * np.pi, k, endpoint=False) + rng.uniform(0, 1)
        r = rng.uniform(0.3, 1.0)
        g = geometry.polygon(np.stack([r * np.cos(ang), r * np.sin(ang)], -1), rng.choice([0.0, 0.1]))
        rows.append(_padded_row(g.verts[: g.count], g.normals[: g.count], g.radius))
    geom = torch.from_numpy(np.stack(rows))
    sa = torch.from_numpy(rng.randint(0, n, n).astype(np.int32))
    sb = torch.from_numpy(rng.randint(0, n, n).astype(np.int32))

    def pose():
        p = rng.uniform(-1.5, 1.5, (W, 2, n))
        a = rng.uniform(-np.pi, np.pi, (W, 1, n))
        return torch.from_numpy(np.concatenate([p, np.sin(a), np.cos(a)], 1).astype(np.float32))

    return geom, sa, sb, pose(), pose(), torch.zeros((W, 7, n), dtype=torch.int32)


def _same(got, want):
    assert torch.equal(got[1], want[1]), "point ids / counts differ"
    assert torch.equal(got[2], want[2]), "GJK caches differ"
    assert float((got[0] - want[0]).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_kernel_matches_twin_cold_and_warm(card):
    args = [x.to(card) for x in _random_pairs(512, 4, seed=0)]
    before = narrow_cuda.collide.launches
    got = narrow_cuda.collide(*args, GJK_ITERS)
    want = collide_lanes_plain(*args, GJK_ITERS)
    torch.cuda.synchronize()
    _same(got, want)
    assert (want[1][:, 2] > 0).any() and (want[1][:, 2] == 0).any()
    kinds = args[0][:, 32][args[1]].cpu()
    assert {1, 2}.issubset(set(kinds.int().tolist()))  # circles and capsules reached
    # warm start from the first call's cache
    args[5] = want[2]
    _same(narrow_cuda.collide(*args, GJK_ITERS), collide_lanes_plain(*args, GJK_ITERS))
    assert narrow_cuda.collide.launches == before + 2


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    geom, sa, sb, pa, pb, cache = (x.to(card) for x in _random_pairs(64, 2, seed=1))
    with pytest.raises(ValueError):
        narrow_cuda.collide(geom.double(), sa, sb, pa, pb, cache, GJK_ITERS)
    with pytest.raises(ValueError):
        narrow_cuda.collide(geom, sa, sb, pa.transpose(1, 2), pb, cache, GJK_ITERS)
    with pytest.raises(ValueError):
        narrow_cuda.collide(geom, sa.cpu(), sb, pa, pb, cache, GJK_ITERS)


# ------------------------------------------------------------ K1


def _k1_inputs(scene, W, dev, steps=2, solver="TGS_SOFT"):
    """The fused solve's inputs after `steps` steps of W worlds of a small
    scene of the per-world path under `solver`, the worlds' velocities
    jittered apart. The Bridge's mouse joint is held from the ground, or
    from plank 11, a dynamic body ("bridge_dyn_a")."""
    from solver2d_tpu_torch import SolverType, batched_step, bridge, pyramid_world, replicate
    from solver2d_tpu_torch.solvers.loops import fused_static
    from solver2d_tpu_torch.step import prepare

    if scene == "pyramid":
        world, _ = pyramid_world(SolverType[solver], 8)
        kw = dict(max_colors=10, gjk_iters=10)
    else:
        world, planks = bridge(SolverType[solver], 24)
        x, y = world.bodies[planks[12]].def_.position
        body_a = 0 if scene == "bridge" else planks[11]
        world.create_mouse_joint(body_a, planks[12], (x + 0.5, y + 2.0), 5.0, 0.7)
        kw = dict(max_colors=8)
    state, cfg = world.freeze(device=dev, lane_solve=False, **kw)
    batch = replicate(state, W)
    g = torch.Generator().manual_seed(0)
    dyn = (batch.bodies.type == 2)[..., None]
    jitter = (0.3 * torch.randn(batch.bodies.v.shape, generator=g)).to(dev)
    batch.bodies.v = torch.where(dyn, batch.bodies.v + jitter * torch.arange(W, device=dev)[:, None, None], batch.bodies.v)
    step = batched_step(cfg)
    for _ in range(steps):
        batch = step(batch, 1.0 / 60.0)
    return prepare(batch, 1.0 / 60.0, cfg).x, fused_static(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["TGS_SOFT", "SOFT_STEP", "PGS_SOFT"])
@pytest.mark.parametrize("scene", ["pyramid", "bridge", "bridge_dyn_a"])
def test_k1_matches_twin(card, scene, solver):
    """K1 rounds as its twin does: equal outputs."""
    from solver2d_tpu_torch.solvers import fused_cuda
    from solver2d_tpu_torch.solvers.fused_solve import fused_solve_plain

    x, static = _k1_inputs(scene, 8, card, solver=solver)
    before = fused_cuda.fused_solve.launches
    got = fused_cuda.fused_solve(x, **static)
    want = fused_solve_plain(x, **static)
    torch.cuda.synchronize()
    assert fused_cuda.fused_solve.launches == before + 1
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)
    assert not torch.equal(got[0][0], got[0][1])  # the worlds differ


@pytest.mark.cuda
def test_k1_wrapper_rejects_what_the_kernel_does_not_take(card):
    from solver2d_tpu_torch.solvers import fused_cuda

    x, static = _k1_inputs("bridge", 2, card, steps=0)
    with pytest.raises(ValueError):
        fused_cuda.fused_solve(x._replace(cfields=x.cfields.double()), **static)
    with pytest.raises(ValueError):
        fused_cuda.fused_solve(x._replace(cint=x.cint.cpu()), **static)
    with pytest.raises(ValueError):
        fused_cuda.fused_solve(x._replace(jfields=x.jfields.transpose(1, 2).contiguous().transpose(1, 2)), **static)
    # a script the kernel is not built for, and a substep loop relaxing twice
    script = static["script"]
    with pytest.raises(ValueError):
        fused_cuda.fused_solve(x, **{**static, "script": script._replace(fixed_warm=not script.fixed_warm)})
    with pytest.raises(ValueError):
        fused_cuda.fused_solve(x, **{**static, "relax": 2})
