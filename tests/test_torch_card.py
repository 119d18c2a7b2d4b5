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
@pytest.mark.parametrize("n,W", [(517, 1), (333, 3), (333, 9)])
def test_kernel_matches_twin_ragged_tiles(card, n, W):
    """Slot and world counts that are no multiple of a block's tile (128
    slots at W < 8, 32 slots x 8 worlds above), mixed shapes in every warp,
    and a cache with indices outside [0, 8)."""
    args = [x.to(card) for x in _random_pairs(n, W, seed=n + W)]
    kinds = args[0][:, 32][args[1][:32]].cpu().int().tolist()
    assert len(set(kinds)) > 1  # circles, capsules and polygons side by side in the first warp
    want = collide_lanes_plain(*args, GJK_ITERS)
    _same(narrow_cuda.collide(*args, GJK_ITERS), want)
    args[5] = want[2]
    _same(narrow_cuda.collide(*args, GJK_ITERS), collide_lanes_plain(*args, GJK_ITERS))
    g = torch.Generator().manual_seed(W)
    args[5] = torch.randint(-2, 11, args[5].shape, generator=g, dtype=torch.int32).to(card)
    _same(narrow_cuda.collide(*args, GJK_ITERS), collide_lanes_plain(*args, GJK_ITERS))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    geom, sa, sb, pa, pb, cache = (x.to(card) for x in _random_pairs(64, 2, seed=1))
    with pytest.raises(ValueError):
        narrow_cuda.collide(geom.double(), sa, sb, pa, pb, cache, GJK_ITERS)
    with pytest.raises(ValueError):
        narrow_cuda.collide(geom, sa, sb, pa.transpose(1, 2), pb, cache, GJK_ITERS)
    with pytest.raises(ValueError):
        narrow_cuda.collide(geom, sa.cpu(), sb, pa, pb, cache, GJK_ITERS)
    with pytest.raises(ValueError):  # rows 4-byte aligned only
        narrow_cuda.collide(torch.cat([geom.new_zeros(1), geom.flatten()])[1:].view_as(geom), sa, sb, pa, pb, cache,
                            GJK_ITERS)


# ------------------------------------------------------------ K1


def _k1_inputs(scene, W, dev, steps=2, solver="TGS_SOFT"):
    """The fused solve's inputs after `steps` steps of W worlds of a small
    scene of the per-world path under `solver`, the worlds' velocities
    jittered apart. The Bridge's mouse joint is held from the ground, or
    from plank 11, a dynamic body ("bridge_dyn_a"). "bridge_boxes" rests
    three boxes on a Bridge (live contacts and joints in one world);
    "sparse" is one box on the ground with 12 colors, most of them empty."""
    from solver2d_tpu_torch import BodyType, SolverType, batched_step, bridge, pyramid_world, replicate
    from solver2d_tpu_torch.solvers.loops import fused_static
    from solver2d_tpu_torch.step import prepare

    if scene == "pyramid":
        world, _ = pyramid_world(SolverType[solver], 8)
        kw = dict(max_colors=10, gjk_iters=10)
    elif scene == "bridge_boxes":
        world, planks = bridge(SolverType[solver], 24)
        for i in (4, 11, 18):
            x, y = world.bodies[planks[i]].def_.position
            box = world.create_body(type=BodyType.DYNAMIC, position=(x, y + 0.125 + 0.25 + 0.004))
            world.create_polygon_shape(box, geometry.box(0.25, 0.25), friction=0.6)
        kw = dict(max_colors=8)
    elif scene == "sparse":
        world, _ = pyramid_world(SolverType[solver], 1)
        kw = dict(max_colors=12)
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


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["TGS_SOFT", "PGS_SOFT"])
def test_k1_more_worlds_than_sms(card, solver):
    """With more worlds than SMs, K1's default staging capacity is the
    largest at which 2 blocks share an SM, and the result is the twin's."""
    from solver2d_tpu_torch.solvers import fused_cuda
    from solver2d_tpu_torch.solvers.fused_solve import fused_solve_plain
    from solver2d_tpu_torch.world import K1_BODY_BYTES, K1_SMEM_BYTES

    x, static = _k1_inputs("pyramid", 8, card, solver=solver)
    reps = torch.cuda.get_device_properties(card).multi_processor_count // 8 + 1
    x = x._replace(**{f: getattr(x, f).repeat(reps, *[1] * (getattr(x, f).dim() - 1))
                      for f in x._fields if f != "scal"})
    script = static["script"]
    W, B = x.bs.shape[:2]
    C, J = x.cint.shape[1], x.jint.shape[1]
    cap = fused_cuda.stage_bytes_for(script, B, 2)
    assert fused_cuda.attributes(script, cap, B)["blocks_per_sm"] >= 2
    if cap + 16 <= K1_SMEM_BYTES - B * K1_BODY_BYTES:
        assert fused_cuda.attributes(script, cap + 16, B)["blocks_per_sm"] < 2
    full = fused_cuda.stage_bytes_default(script, B, C, J)
    assert fused_cuda.stage_bytes_default(script, B, C, J, W, card) == min(full, cap)
    got = fused_cuda.fused_solve(x, **static)
    want = fused_solve_plain(x, **static)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _k1_phases(x, static):
    """The barriers K1 takes on x: 4 to build its lists, then per pass one a
    color with a listed constraint, two a warm start with any, one an
    integrate (csrc/fused_solve.cu)."""
    ca, cw, color = x.cint[..., 3] & 4 != 0, x.cint[..., 3] & 32 != 0, x.cint[..., 2]
    ja, jw, jcolor = x.jint[..., 3] & 2 != 0, x.jint[..., 3] & 64 != 0, x.jint[..., 2]
    K, KJ = static["n_colors"], static["n_joint_colors"]
    listed_c = ca & cw & (color >= 0) & (color < K)
    planned_j = ja & jw & (jcolor >= 0)
    listed_j = planned_j & (jcolor < KJ)
    out = []
    for w in range(x.cint.shape[0]):
        colors = len(set(color[w][listed_c[w]].tolist())) + len(set(jcolor[w][listed_j[w]].tolist()))
        warm = 2 * int(bool(ca[w].any())) + 2 * int(bool(planned_j[w].any())) if static["warm_start"] else 0
        if static["script"].loop == "substep":
            out.append(4 + static["substeps"] * (2 + warm + colors * (1 + static["relax"])))
        else:
            out.append(4 + 2 + warm + colors * (static["substeps"] + static["relax"]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["none", "small", "full"])
@pytest.mark.parametrize("solver", ["TGS_SOFT", "SOFT_STEP", "PGS_SOFT"])
def test_k1_staging_capacity_leaves_the_result(card, solver, stage):
    """Whatever share of its rows K1 stages in shared memory (none, a few,
    all), it equals its twin, on a world with live contacts and joints."""
    from solver2d_tpu_torch.solvers import fused_cuda
    from solver2d_tpu_torch.solvers.fused_solve import fused_solve_plain

    x, static = _k1_inputs("bridge_boxes", 4, card, solver=solver)
    assert bool((x.cint[..., 3] & 4 != 0).any()) and bool((x.jint[..., 3] & 2 != 0).any())
    B, C, J = x.bs.shape[1], x.cint.shape[1], x.jint.shape[1]
    full = fused_cuda.stage_bytes_default(static["script"], B, C, J)
    nbytes = {"none": 0, "small": 2048, "full": full}[stage]
    phases = torch.empty(x.bs.shape[0], dtype=torch.int32, device=x.bs.device)
    got = fused_cuda.fused_solve(x, **static, stage_bytes=nbytes, phases=phases)
    want = fused_solve_plain(x, **static)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert phases.cpu().tolist() == _k1_phases(x, static)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["TGS_SOFT", "PGS_SOFT"])
def test_k1_skips_empty_colors(card, solver):
    """A world that uses few of its colors: K1 takes a barrier only for the
    colors with constraints, and still equals its twin."""
    from solver2d_tpu_torch.solvers import fused_cuda
    from solver2d_tpu_torch.solvers.fused_solve import fused_solve_plain

    x, static = _k1_inputs("sparse", 2, card, solver=solver)
    used = set(x.cint[..., 2][(x.cint[..., 3] & 36) == 36].tolist())
    assert 0 < len(used) < static["n_colors"]
    phases = torch.empty(x.bs.shape[0], dtype=torch.int32, device=x.bs.device)
    got = fused_cuda.fused_solve(x, **static, phases=phases)
    want = fused_solve_plain(x, **static)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    phases = phases.cpu().tolist()
    assert phases == _k1_phases(x, static)
    full_scan = 4 + static["substeps"] * (1 + 4 + 2 * (static["n_colors"] + static["n_joint_colors"]) + 1)
    assert phases[0] < full_scan


# ------------------------------------------------------------ the catalog


def _catalog_batch(name, W, dev, steps, solver="TGS_SOFT"):
    """W worlds of a catalog scene at its published size, velocities
    jittered apart, after `steps` steps of the per-world step with the
    scene's hooks; and its config."""
    from solver2d_tpu_torch import SolverType, batched_step, replicate
    from solver2d_tpu_torch.models import SCENES

    scene = SCENES[name](SolverType[solver])
    state, cfg = scene.freeze(device=dev)
    batch = replicate(state, W)
    g = torch.Generator().manual_seed(1)
    dyn = (batch.bodies.type == 2)[..., None]
    jitter = (0.05 * torch.randn(batch.bodies.v.shape, generator=g)).to(dev)
    batch.bodies.v = torch.where(dyn, batch.bodies.v + jitter * torch.arange(W, device=dev)[:, None, None],
                                 batch.bodies.v)
    step = batched_step(cfg)
    for _ in range(steps):
        if scene.pre_step is not None:
            batch = scene.pre_step(batch)
        batch = step(batch, 1.0 / 60.0)
    return batch, cfg


# Ragdoll Stress once its humans reach the paddles: contacts, limited and
# motored joints in one launch; Confined: circles against circles and capsules
CATALOG = {"ragdoll_stress": (("Joints", "Ragdoll Stress"), 40), "confined": (("Contact", "Confined"), 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["TGS_SOFT", "SOFT_STEP", "PGS_SOFT"])
@pytest.mark.parametrize("scene", list(CATALOG))
def test_k1_matches_twin_on_the_catalog(card, scene, solver):
    from solver2d_tpu_torch.solvers import fused_cuda
    from solver2d_tpu_torch.solvers.fused_solve import fused_solve_plain
    from solver2d_tpu_torch.solvers.loops import fused_static
    from solver2d_tpu_torch.step import prepare

    name, steps = CATALOG[scene]
    batch, cfg = _catalog_batch(name, 4, card, steps, solver)
    x, static = prepare(batch, 1.0 / 60.0, cfg).x, fused_static(cfg)
    assert bool((x.cint[..., 3] & 4 != 0).any())
    if scene == "ragdoll_stress":
        j = batch.joints
        assert bool((j.alive & j.enable_limit).any()) and bool((j.alive & j.enable_motor).any())
        assert bool((x.jint[..., 3] & 2 != 0).any())
    got = fused_cuda.fused_solve(x, **static)
    want = fused_solve_plain(x, **static)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(CATALOG))
def test_k2_matches_twin_on_the_catalog(card, scene):
    from solver2d_tpu_torch.step import world_narrow_inputs

    name, steps = CATALOG[scene]
    batch, cfg = _catalog_batch(name, 4, card, steps)
    args = world_narrow_inputs(batch, batch.contacts)
    want = collide_lanes_plain(*args, cfg.gjk_iters)
    assert bool((want[1][:, 2] > 0).any())
    kinds = set(args[0][:, 32].int().tolist())
    assert {2, 1 if scene == "confined" else 4}.issubset(kinds)  # capsules with circles, or with boxes
    _same(narrow_cuda.collide(*args, cfg.gjk_iters), want)


# ------------------------------------------------------------ the XLA route

XLA_SOLVERS = ["JACOBI", "PGS", "PGS_NGS", "PGS_NGS_BLOCK", "PGS_SOFT", "SOFT_STEP", "TGS_SOFT", "TGS_NGS",
               "TGS_STICKY", "XPBD"]


def _xla_world(scene, solver, layout, **kw):
    """A small scene of the per-world step on its XLA route: the base-4
    pyramid, or the 4-plank Bridge with a mouse joint on plank 3 held from
    plank 1; `layout` "bucketed" sizes contact and joint buckets; `kw` more
    freeze settings."""
    from solver2d_tpu_torch import SolverType, bridge, pyramid_world

    if scene == "pyramid":
        world, _ = pyramid_world(SolverType[solver], 4)
    else:
        world = bridge(SolverType[solver], 4)[0]
        x, y = world.bodies[3].def_.position
        world.create_mouse_joint(1, 3, (x + 0.3, y + 1.0), 5.0, 0.7)
    if layout == "bucketed":
        kw.update(contact_bucket_cap=-1, joint_bucket_cap=-1)
    state, cfg = world.freeze(device="cpu", lane_solve=False, use_fused_solver=False, **kw)
    assert cfg.use_fused_solver is False
    return state, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "bucketed"])
@pytest.mark.parametrize("scene", ["pyramid", "bridge"])
@pytest.mark.parametrize("solver", XLA_SOLVERS)
def test_xla_route_on_the_card_matches_the_cpu(card, solver, scene, layout):
    """4 steps of 2 worlds on the card (the solve replayed from a CUDA graph
    from the third) and on the CPU: positions within 1e-4, colors and
    diagnostics equal; K2 once a step, K1 never."""
    _card_vs_cpu(card, solver, scene, layout)


def _card_vs_cpu(card, solver, scene, layout, **kw):
    from solver2d_tpu_torch import batched_step, replicate
    from solver2d_tpu_torch.solvers import fused_cuda

    state, cfg = _xla_world(scene, solver, layout, **kw)
    step = batched_step(cfg)
    cpu = replicate(state, 2)
    cpu.bodies.v = cpu.bodies.v + torch.where((cpu.bodies.type == 2)[..., None], 0.2, 0.0) * torch.arange(2)[:, None, None]
    gpu = cpu.to(card)
    k1, k2 = fused_cuda.fused_solve.launches, narrow_cuda.collide.launches
    for _ in range(4):
        cpu, gpu = step(cpu, 1.0 / 60.0), step(gpu, 1.0 / 60.0)
    torch.cuda.synchronize()
    assert fused_cuda.fused_solve.launches == k1 and narrow_cuda.collide.launches == k2 + 4
    assert float((gpu.bodies.position.cpu() - cpu.bodies.position).abs().max()) < 1e-4
    assert torch.equal(gpu.contacts.color.cpu(), cpu.contacts.color)
    assert torch.equal(gpu.joints.color.cpu(), cpu.joints.color)
    for k in ("color_overflow", "pair_overflow", "contact_count", "pair_count"):
        assert torch.equal(getattr(gpu.diag, k).cpu(), getattr(cpu.diag, k)), k
    assert int(gpu.diag.color_overflow.max()) == 0
    if solver == "TGS_STICKY":
        assert torch.equal(gpu.contacts.friction_persisted.cpu(), cpu.contacts.friction_persisted)
        assert float((gpu.contacts.friction_anchor_a.cpu() - cpu.contacts.friction_anchor_a).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("secondary", [dict(broadphase="sap", sap_window=48), dict(incremental_coloring=False)],
                         ids=["sap", "mis"])
def test_secondary_paths_on_the_card_match_the_cpu(card, secondary):
    """The sweep and prune and the per-step MIS coloring on the base-4
    pyramid under PGS_NGS_Block: the card's 4 steps equal the CPU's, as
    in the test above."""
    _card_vs_cpu(card, "PGS_NGS_BLOCK", "pyramid", "dense", **secondary)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["TGS_SOFT", "PGS_NGS_BLOCK", "TGS_STICKY", "XPBD"])
def test_xla_graph_replay_matches_eager(card, solver):
    """The XLA solve replayed from a CUDA graph equals the eager solve on
    the card bit for bit, over steps whose live colors change."""
    from solver2d_tpu_torch import batched_step, replicate
    from solver2d_tpu_torch.solvers import graphs

    state, cfg = _xla_world("pyramid", solver, "dense")
    step = batched_step(cfg)
    runs, held = [], []
    for enabled in (True, False):
        graphs.ENABLED = enabled
        graphs.clear()
        try:
            batch = replicate(state, 3).to(card)
            for _ in range(6):
                batch = step(batch, 1.0 / 60.0)
            runs.append(batch)
            held.append(len(graphs._graphs))
        finally:
            graphs.ENABLED = True
    assert held == [held[0], 0] and held[0] > 0  # graphs replayed in the first run only
    for name in ("position", "rot", "v", "w"):
        assert torch.equal(getattr(runs[0].bodies, name), getattr(runs[1].bodies, name)), name
    assert torch.equal(runs[0].contacts.normal_impulse, runs[1].contacts.normal_impulse)
    assert torch.equal(runs[0].contacts.friction_persisted, runs[1].contacts.friction_persisted)
    assert torch.equal(runs[0].contacts.friction_anchor_a, runs[1].contacts.friction_anchor_a)


# ------------------------------------------ queries, raycasts and their GJK


def _random_shapes(n, seed):
    """n shapes of every kind (circles, capsules, segments, boxes, random
    convex polygons, some rounded) as padded arrays: verts [n, 8, 2], count
    [n], radius [n]."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        c = rng.uniform(-2, 2, 2)
        kind = i % 5
        if kind == 0:
            g = geometry.circle(c, rng.uniform(0.1, 1.0))
        elif kind == 1:
            g = geometry.capsule(c, c + rng.uniform(-1.5, 1.5, 2), rng.uniform(0.05, 0.5))
        elif kind == 2:
            g = geometry.segment(c, c + rng.uniform(-1.5, 1.5, 2))
        elif kind == 3:
            g = geometry.offset_box(rng.uniform(0.1, 1.0), rng.uniform(0.1, 1.0), c, rng.uniform(-3, 3))
        else:
            k = rng.randint(3, 9)
            ang = np.sort(rng.uniform(0, 2 * np.pi, k)) + np.arange(k) * 1e-3
            g = geometry.polygon(c + np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(0.3, 1.5),
                                 rng.choice([0.0, 0.1]))
        out.append(g)
    return (torch.from_numpy(np.stack([np.asarray(g.verts, np.float32) for g in out])),
            torch.tensor([g.count for g in out], dtype=torch.int32),
            torch.tensor([g.radius for g in out], dtype=torch.float32))


def _equal_trees(got, want):
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w), (g, w)


@pytest.mark.cuda
def test_gjk_raycasts_and_point_test_on_the_card_match_the_cpu(card):
    """`distance.gjk` (warm and cold caches), every shape cast and the point
    test on every shape kind: the card's outputs equal the CPU's."""
    from solver2d_tpu_torch.ops import distance, raycast

    va, ca, ra = _random_shapes(240, 1)
    vb, cb, _ = _random_shapes(240, 2)
    rng = np.random.RandomState(3)
    cc = torch.from_numpy(np.where(rng.rand(240) < 0.5, rng.randint(1, 4, 240), 0).astype(np.int32))
    cia = torch.from_numpy(np.stack([rng.randint(0, c, 3) for c in ca.numpy()]).astype(np.int32))
    cib = torch.from_numpy(np.stack([rng.randint(0, c, 3) for c in cb.numpy()]).astype(np.int32))
    args = (va, ca, vb, cb, cc, cia, cib)
    _equal_trees(distance.gjk(*[a.to(card) for a in args]), distance.gjk(*args))
    p1 = torch.from_numpy(rng.uniform(-4, 4, (240, 2)).astype(np.float32))
    p2 = p1 + torch.from_numpy(rng.uniform(-6, 6, (240, 2)).astype(np.float32))
    for fn, xs in ((raycast.raycast_circle, (p1, p2, 0.8, va[:, 0], ra)),
                   (raycast.raycast_capsule, (p1, p2, 0.8, va[:, 0], va[:, 1], ra)),
                   (raycast.raycast_polygon, (p1, p2, 0.8, va, ca, ra)),
                   (raycast.raycast_shape, (p1, p2, 0.8, va, ca, ra))):
        got = fn(*[x.to(card) if isinstance(x, torch.Tensor) else x for x in xs])
        _equal_trees(got, fn(*xs))
    inside = raycast.point_in_shape(p1.to(card), va.to(card), ca.to(card), ra.to(card))
    assert torch.equal(inside.cpu(), raycast.point_in_shape(p1, va, ca, ra))


def _pyramid_batch(base, W, steps, dev, solver="TGS_SOFT"):
    """(batch on dev, the same on the CPU, config, box ids): W worlds of a
    pyramid with jittered velocities, stepped `steps` times on each."""
    from solver2d_tpu_torch import SolverType, batched_step, pyramid_world, replicate

    w, ids = pyramid_world(SolverType[solver], base)
    state, cfg = w.freeze(device="cpu", lane_solve=False, iterations=2, extra_iterations=1)
    cpu = replicate(state, W)
    g = torch.Generator().manual_seed(0)
    dyn = cpu.bodies.type == 2
    cpu.bodies.v = torch.where(dyn[..., None], cpu.bodies.v + 0.1 * torch.randn(cpu.bodies.v.shape, generator=g),
                               cpu.bodies.v)
    gpu = cpu.to(dev)
    step = batched_step(cfg)
    for _ in range(steps):
        cpu, gpu = step(cpu, 1.0 / 60.0), step(gpu, 1.0 / 60.0)
    return gpu, cpu, cfg, ids


@pytest.mark.cuda
def test_raycast_world_culled_matches_brute_force_on_the_card(card):
    """A base-12 pyramid (80 shape slots, above the default 64 candidates):
    the culled world raycast equals the brute-force scan on the card, and
    the card's queries equal the CPU's."""
    from solver2d_tpu_torch import queries

    gpu, cpu, cfg, _ = _pyramid_batch(12, 2, 2, card)
    S = cfg.max_shapes
    assert S > 64
    for w in (0, 1):
        for y in (0.5, 3.2, 7.9, 11.5):
            culled = queries.raycast_world(gpu, (-20.0, y), (20.0, y), world=w)
            brute = queries.raycast_world(gpu, (-20.0, y), (20.0, y), max_candidates=S, world=w)
            assert bool(culled.hit)
            for a, b in zip(culled, brute):
                assert torch.equal(a, b)
            _equal_trees(culled, queries.raycast_world(cpu, (-20.0, y), (20.0, y), world=w))
        p = cpu.bodies.position[w, 5]
        assert torch.equal(queries.test_point(gpu, p, world=w).cpu(), queries.test_point(cpu, p, world=w))
        assert torch.equal(queries.query_aabb(gpu, p - 1, p + 1, world=w).cpu(),
                           queries.query_aabb(cpu, p - 1, p + 1, world=w))


@pytest.mark.cuda
def test_pick_and_drag_on_the_card(card):
    """Pick the top box of a base-5 pyramid (TGS_Soft, the fused route) in
    each of 4 worlds, attach a mouse joint and drag it for 3 steps: K1 and
    K2 launched once a step, the card within phase 5's 1e-4 of the CPU with
    equal colors, the box nearer its goal."""
    from solver2d_tpu_torch import batched_step, queries
    from solver2d_tpu_torch.solvers import fused_cuda

    gpu, cpu, cfg, ids = _pyramid_batch(5, 4, 1, card)
    assert cfg.use_fused_solver
    top = ids[-1]
    for w in range(4):
        found, body = queries.pick_body(gpu, gpu.bodies.position[w, top], world=w)
        assert bool(found) and int(body) == top
    center = cpu.bodies.position[:, top]
    goal = center + 1.0
    gpu = queries.attach_mouse_joint(gpu, 0, top, center.to(card), hertz=5.0)
    cpu = queries.attach_mouse_joint(cpu, 0, top, center, hertz=5.0)
    step = batched_step(cfg)
    k1, k2 = fused_cuda.fused_solve.launches, narrow_cuda.collide.launches
    for i in range(3):
        target = center + (i + 1) / 3.0
        gpu = queries.move_mouse_target(gpu, 0, target.to(card))
        cpu = queries.move_mouse_target(cpu, 0, target)
        gpu, cpu = step(gpu, 1.0 / 60.0), step(cpu, 1.0 / 60.0)
        assert (fused_cuda.fused_solve.launches - k1, narrow_cuda.collide.launches - k2) == (i + 1, i + 1)
    torch.cuda.synchronize()
    assert float((gpu.bodies.position.cpu() - cpu.bodies.position).abs().max()) <= 1e-4
    assert torch.equal(gpu.joints.color.cpu(), cpu.joints.color) and torch.equal(gpu.contacts.color.cpu(),
                                                                                 cpu.contacts.color)
    d0 = (center - goal).norm(dim=-1)
    d1 = (gpu.bodies.position[:, top].cpu() - goal).norm(dim=-1)
    assert bool((d1 < d0).all())


# ------------------------------------------- worlds split over mesh entries


def _split_scene(route):
    """A base-4 pyramid batch of 4 worlds with jittered velocities (of
    order 1e-3 on the lane path, whose shards share their world 0's
    structure) and its config: the lane step, the per-world fused route
    (TGS_Soft, K1) or the XLA route (PGS_NGS_Block)."""
    from solver2d_tpu_torch import SolverType, pyramid_world, replicate
    from solver2d_tpu_torch.parallel import apply_velocity_deltas

    solver = "PGS_NGS_BLOCK" if route == "xla" else "TGS_SOFT"
    kw = dict(contact_bucket_cap=-1) if route == "lane" else dict(lane_solve=False)
    state, cfg = pyramid_world(SolverType[solver], 4)[0].freeze(device="cpu", **kw)
    assert cfg.lane_solve == (route == "lane") and bool(cfg.use_fused_solver) == (route == "fused")
    g = torch.Generator().manual_seed(0)
    batch = replicate(state, 4)
    scale = (1e-3 if route == "lane" else 0.2) * torch.arange(4.0)[:, None, None]
    dv = torch.randn(batch.bodies.v.shape, generator=g) * scale
    return apply_velocity_deltas(batch, dv, torch.zeros_like(batch.bodies.w)), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["lane", "fused", "xla"])
def test_two_shards_on_one_card_equal_the_unsharded_step(card, route):
    """A mesh that lists the card twice: each shard on its own stream, 5
    steps (the XLA solve replayed from a graph of each shard's own from the
    third) equal the unsharded step on the card bit for bit; K2 once a
    shard a step, K1 too on the fused route."""
    from solver2d_tpu_torch import make_mesh, make_step, sharded_step
    from solver2d_tpu_torch.solvers import fused_cuda, graphs

    batch, cfg = _split_scene(route)
    batch = batch.to(card)
    mesh = make_mesh([card, card])
    assert mesh.streams[0] != mesh.streams[1]
    graphs.clear()
    stepf, whole_step = sharded_step(cfg, mesh), make_step(cfg)
    split, whole = batch, batch
    for _ in range(5):
        whole = whole_step(whole, 1.0 / 60.0)
    k1, k2 = fused_cuda.fused_solve.launches, narrow_cuda.collide.launches
    for _ in range(5):
        split = stepf(split, 1.0 / 60.0)
    assert (fused_cuda.fused_solve.launches - k1, narrow_cuda.collide.launches - k2) == (
        10 if route == "fused" else 0, 10)
    if route == "xla":  # a graph of each shard's stream
        assert {key[2] for key in graphs._graphs} >= {s.cuda_stream for s in mesh.streams}
    got = split.gather(card)
    torch.cuda.synchronize()
    for name in ("position", "rot", "v", "w"):
        assert torch.equal(getattr(got.bodies, name), getattr(whole.bodies, name)), name
    assert torch.equal(got.contacts.color, whole.contacts.color)
    assert torch.equal(got.contacts.normal_impulse, whole.contacts.normal_impulse)
    assert int(whole.diag.contact_count.min()) > 0


@pytest.mark.cuda
def test_a_graph_replays_only_on_its_own_stream(card):
    """The same key on two streams makes two graphs (each with its own
    static buffers), each replayed on its stream: the repair of two shards
    of one card sharing one graph's buffers from two streams."""
    from solver2d_tpu_torch.solvers import graphs

    graphs.clear()
    x = torch.arange(8.0, device=card)
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    outs = []
    for k in range(3):
        for i, s in enumerate(streams):
            s.wait_stream(torch.cuda.current_stream(card))
            with torch.cuda.stream(s):
                outs.append(graphs.run("twice", lambda t: (2.0 * t,), ((x + 10 * i + k),))[0])
            torch.cuda.current_stream(card).wait_stream(s)
    torch.cuda.synchronize()
    keys = [key for key in graphs._graphs if key[0] == "twice"]
    assert sorted(key[2] for key in keys) == sorted(s.cuda_stream for s in streams)
    for k in range(3):
        for i in range(2):
            assert torch.equal(outs[2 * k + i], 2.0 * (x + 10 * i + k))
    graphs.clear()


@pytest.mark.cuda
def test_one_nccl_rank_reduces_like_one_process(card, tmp_path):
    """`initialize` with one NCCL rank (a file:// store): the mesh takes the
    group in, `global_batch` equals `replicate`, the all_reduce of
    `metrics_psum_example` equals the local sum."""
    from solver2d_tpu_torch import SolverType, pyramid_world, replicate
    from solver2d_tpu_torch.parallel import metrics_psum_example
    from solver2d_tpu_torch.parallel.distributed import global_batch, initialize, make_mesh

    initialize(f"file://{tmp_path / 'store'}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = make_mesh([card, card])
        assert mesh.group is not None
        state, _ = pyramid_world(SolverType.TGS_SOFT, 4)[0].freeze(device=card, lane_solve=False)
        batch = global_batch(state, 2, mesh)
        assert (batch.offset, batch.global_worlds) == (0, 4)
        whole = replicate(state, 4)
        assert torch.equal(batch.gather(card).bodies.position, whole.bodies.position)
        whole.bodies.v = torch.randn_like(whole.bodies.v)
        batch.shards = [whole.map(lambda x: x[:2]), whole.map(lambda x: x[2:])]
        got = metrics_psum_example(batch, mesh)
        want = 0.5 * torch.sum(whole.bodies.v[:2] ** 2) + 0.5 * torch.sum(whole.bodies.v[2:] ** 2)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    finally:
        torch.distributed.destroy_process_group()
