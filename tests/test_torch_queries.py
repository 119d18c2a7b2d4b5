"""World queries, raycasts and their GJK against the JAX package's, on the
CPU, on the same inputs (made from a seed with numpy).

- `ops/distance.gjk` on random polygon pairs with and without a
  warm-start cache, and `segment_distance` on random, parallel and
  degenerate segments;
- the shape casts and the point test on every shape kind;
- `queries.py` on frozen scenes whose bodies were moved and turned at
  random: `query_aabb`, `test_point`, `raycast_world` (brute force, and
  culled with a small `max_candidates`), `pick_body`, and the mouse
  joint's attach, move and detach, on one world and on a batch;
- the slice as a whole: pick, attach, drag for 3 steps and detach on a
  jittered 2-world batch, stepped by the port's per-world step (TGS_Soft
  on the fused route, K1's twin here; PGS_NGS_Block on the XLA route)
  and by the JAX package's `step` with the same edits.

JAX runs op by op (`jax.disable_jit()`) and its per-shape functions under
`vmap`, as the JAX package calls them. Integers are equal and floats
equal bit for bit (tolerance 0) throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu import queries as jq
from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models.contact_scenes import pyramid_world as jax_pyramid
from solver2d_tpu.ops import distance as jd
from solver2d_tpu.ops import raycast as jr
from solver2d_tpu.step import step as jax_step
from solver2d_tpu_torch import queries as tq
from solver2d_tpu_torch import batched_step, state_from_numpy, to_numpy
from solver2d_tpu_torch.config import use_fused
from solver2d_tpu_torch.ops import distance as td
from solver2d_tpu_torch.ops import geometry
from solver2d_tpu_torch.ops import raycast as tr
from torch_parity import DT, WORLD_KW, assert_tree_close, jax_worlds, np_tree, port_config, stack, to_jax

torch.set_num_threads(1)
EXACT = dict(rtol=0, atol=0)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _eq(got, want, name=""):
    """Port tensor against JAX array: equal dtype, shape and bits (NaN
    equal to NaN; -0.0 equal to 0.0)."""
    g, w = got.detach().cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=name)


def _random_shapes(rng, n):
    """n shapes of every kind as the unified padded arrays (verts [n, 8, 2],
    count [n], radius [n]): circles, capsules, segments, boxes, rounded
    and random convex polygons, each moved and turned at random."""
    geoms = []
    for i in range(n):
        kind = i % 6
        c = rng.uniform(-2, 2, 2)
        if kind == 0:
            g = geometry.circle(c, rng.uniform(0.1, 1.0))
        elif kind == 1:
            g = geometry.capsule(c, c + rng.uniform(-1.5, 1.5, 2), rng.uniform(0.05, 0.5))
        elif kind == 2:
            g = geometry.segment(c, c + rng.uniform(-1.5, 1.5, 2))
        elif kind == 3:
            g = geometry.offset_box(rng.uniform(0.1, 1.0), rng.uniform(0.1, 1.0), c, rng.uniform(-3, 3))
        elif kind == 4:
            g = geometry.box(rng.uniform(0.1, 1.0), rng.uniform(0.1, 1.0), radius=rng.uniform(0.05, 0.3))
        else:
            k = rng.randint(3, 9)
            ang = np.sort(rng.uniform(0, 2 * np.pi, k)) + np.arange(k) * 1e-3
            g = geometry.polygon(c + np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(0.3, 1.5))
        geoms.append(g)
    verts = np.stack([np.asarray(g.verts, np.float32) for g in geoms])
    count = np.array([g.count for g in geoms], np.int32)
    radius = np.array([g.radius for g in geoms], np.float32)
    return verts, count, radius


# ------------------------------------------------------------------ GJK


@pytest.mark.parametrize("max_iters", [3, 20])
def test_gjk_matches_jax(max_iters):
    """Random polygons and circles' cores (1 vertex) and segments (2), half
    of the pairs warm-started from a random cache; 3 trips leave many pairs
    unconverged, so the final re-solve is taken too."""
    rng = np.random.RandomState(max_iters)
    n = 192
    va, ca, _ = _random_shapes(rng, n)
    vb, cb, _ = _random_shapes(rng, n)
    perm = rng.permutation(n)
    vb, cb = vb[perm], cb[perm]
    cc = np.where(rng.rand(n) < 0.5, rng.randint(1, 4, n), 0).astype(np.int32)
    cia = np.stack([rng.randint(0, c, 3) for c in ca]).astype(np.int32)
    cib = np.stack([rng.randint(0, c, 3) for c in cb]).astype(np.int32)
    with jax.disable_jit():
        want = jax.vmap(lambda *a: jd.gjk(*a, max_iters=max_iters))(va, ca, vb, cb, cc, cia, cib)
    got = td.gjk(*_t(va, ca, vb, cb, cc, cia, cib), max_iters=max_iters)
    for name, g, w in zip(want._fields, got, want):
        _eq(g, w, name)
    assert len(set(np.asarray(want.iterations).tolist())) > 2


def test_segment_distance_matches_jax():
    """Random segments, parallel ones, and segments of zero length (one or
    both)."""
    rng = np.random.RandomState(7)
    n = 240
    p1, q1, p2, q2 = (rng.normal(size=(n, 2)).astype(np.float32) for _ in range(4))
    q1[:20] = p1[:20]                 # segment 1 a point
    q2[10:30] = p2[10:30]             # segment 2 a point (both in 10:20)
    p2[40:60] = p1[40:60] + 0.5       # parallel
    q2[40:60] = q1[40:60] + 0.5
    p2[60:80] = p1[60:80] + 2.0 * (q1[60:80] - p1[60:80])  # collinear, apart
    q2[60:80] = p1[60:80] + 3.0 * (q1[60:80] - p1[60:80])
    with jax.disable_jit():
        want = jd.segment_distance(*[jnp.asarray(x) for x in (p1, q1, p2, q2)])
    got = td.segment_distance(*_t(p1, q1, p2, q2))
    for i, (g, w) in enumerate(zip(got, want)):
        _eq(g, w, f"output {i}")


# ------------------------------------------------------------- raycasts


def _rays(rng, n):
    p1 = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
    p2 = (p1 + rng.uniform(-6, 6, (n, 2))).astype(np.float32)
    p2[:8] = p1[:8]  # zero-length rays
    p2[8:16, 1] = p1[8:16, 1]  # horizontal rays
    return p1, p2


def test_shape_raycasts_match_jax():
    """Each cast on every shape kind, and the dispatch by vertex count."""
    rng = np.random.RandomState(3)
    n = 180
    verts, count, radius = _random_shapes(rng, n)
    p1, p2 = _rays(rng, n)
    tv, tc, trad, tp1, tp2 = _t(verts, count, radius, p1, p2)
    mf = np.float32(0.8)
    with jax.disable_jit():
        want = {
            "circle": jax.vmap(jr.raycast_circle, in_axes=(0, 0, None, 0, 0))(p1, p2, mf, verts[:, 0], radius),
            "capsule": jax.vmap(jr.raycast_capsule, in_axes=(0, 0, None, 0, 0, 0))(
                p1, p2, mf, verts[:, 0], verts[:, 1], radius),
            "polygon": jax.vmap(jr.raycast_polygon, in_axes=(0, 0, None, 0, 0, 0))(p1, p2, mf, verts, count, radius),
            "shape": jax.vmap(jr.raycast_shape, in_axes=(0, 0, None, 0, 0, 0))(p1, p2, mf, verts, count, radius),
        }
    got = {
        "circle": tr.raycast_circle(tp1, tp2, 0.8, tv[:, 0], trad),
        "capsule": tr.raycast_capsule(tp1, tp2, 0.8, tv[:, 0], tv[:, 1], trad),
        "polygon": tr.raycast_polygon(tp1, tp2, 0.8, tv, tc, trad),
        "shape": tr.raycast_shape(tp1, tp2, 0.8, tv, tc, trad),
    }
    for kind in want:
        for name, g, w in zip(("ok", "fraction", "point", "normal"), got[kind], want[kind]):
            _eq(g, w, f"{kind} {name}")
        assert bool(got[kind][0].any()) and not bool(got[kind][0].all())


def test_point_in_shape_matches_jax():
    rng = np.random.RandomState(4)
    n = 180
    verts, count, radius = _random_shapes(rng, n)
    pts = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    pts[::3] = verts[::3, 0]  # on a vertex
    with jax.disable_jit():
        want = jax.vmap(jr.point_in_shape)(pts, verts, count, radius)
    got = tr.point_in_shape(*_t(pts, verts, count, radius))
    _eq(got, want, "inside")
    assert bool(got.any()) and not bool(got.all())


# -------------------------------------------------------------- queries


def _query_scene(package):
    """The JAX package's query scene (tests/test_queries.py): a ground box,
    a box, a circle and a capsule; built in `package`."""
    w = package.World(solver=package.SolverType.PGS)
    g = w.create_body(type=package.BodyType.STATIC, position=(0, -1))
    w.create_polygon_shape(g, package_geometry(package).box(10, 1))
    box = w.create_body(type=package.BodyType.DYNAMIC, position=(0.0, 0.5))
    w.create_polygon_shape(box, package_geometry(package).box(0.5, 0.5))
    circ = w.create_body(type=package.BodyType.DYNAMIC, position=(3.0, 0.5))
    w.create_circle_shape(circ, (0.0, 0.0), 0.5)
    cap = w.create_body(type=package.BodyType.DYNAMIC, position=(-3.0, 0.3))
    w.create_capsule_shape(cap, (-0.5, 0.0), (0.5, 0.0), 0.25)
    return w


def package_geometry(package):
    import importlib

    return importlib.import_module(package.__name__ + ".ops.geometry")


def _scenes(name):
    """(JAX state, port state of 2 worlds): the scene frozen in both
    packages, its dynamic bodies moved and turned at random (numpy, seeded;
    world 1 differently from world 0). Both packages see the same arrays."""
    import solver2d_tpu
    import solver2d_tpu_torch

    if name == "query":
        jw, pw = _query_scene(solver2d_tpu), _query_scene(solver2d_tpu_torch)
    else:
        from solver2d_tpu_torch.models.contact_scenes import pyramid_world

        jw, pw = jax_pyramid(JSolver.PGS, 4)[0], pyramid_world(solver2d_tpu_torch.SolverType.PGS, 4)[0]
    jstate, _ = jw.freeze()
    pstate, _ = pw.freeze(device="cpu", lane_solve=False)
    rng = np.random.RandomState(11)
    worlds = []
    for k in range(2):
        tree = to_numpy(pstate)
        b = tree["bodies"]
        dyn = b["type"] == 2
        ang = rng.uniform(-np.pi, np.pi, dyn.sum()).astype(np.float32)
        b["rot"][dyn] = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
        b["origin"][dyn] += rng.uniform(-0.3, 0.3, (dyn.sum(), 2)).astype(np.float32) * (k + 1)
        worlds.append(tree)
    batch = state_from_numpy(jax.tree.map(lambda *xs: np.stack(xs), *worlds), device="cpu")
    return [to_jax(jstate, w) for w in worlds], batch


# the world of the 2-world batch each scene's queries run in
QUERY_WORLD = {"query": 1, "pyramid": 0}


@pytest.mark.parametrize("scene,kind", [("query", "points"), ("query", "picks"), ("query", "rays"),
                                        ("pyramid", "points"), ("pyramid", "rays")])
def test_queries_match_jax(scene, kind):
    """In one world of a 2-world batch, against the JAX functions on that
    world: query_aabb on random boxes and test_point at random points and
    at body origins ("points"); pick_body at the same points ("picks");
    raycast_world on random and horizontal rays, brute force and culled to
    4 candidates ("rays"). JAX runs under `vmap` over the queries, so that
    each op of a query runs once for all of them (its point test's 20
    unrolled GJK trips take seconds op by op). The pyramid's picks are
    held to JAX in the pick-and-drag test below."""
    world = QUERY_WORLD[scene]
    jstates, batch = _scenes(scene)
    js = jstates[world]
    rng = np.random.RandomState(5)
    assert batch.shapes.body.shape[1] > 4  # the cap of 4 takes the culled path
    origins = to_numpy(batch)["bodies"]["origin"][world][1:4]
    pts = np.concatenate([origins, rng.uniform(-4, 4, (4, 2)).astype(np.float32)])
    if kind == "points":
        lo = rng.uniform(-4, 3, (4, 2)).astype(np.float32)
        hi = (lo + rng.uniform(0.1, 3, (4, 2))).astype(np.float32)
        with jax.disable_jit():
            want_aabb = jax.vmap(lambda a, b: jq.query_aabb(js, a, b))(lo, hi)
            want_point = jax.vmap(lambda p: jq.test_point(js, p))(pts)
        for i in range(len(lo)):
            _eq(tq.query_aabb(batch, lo[i], hi[i], world), want_aabb[i], "query_aabb")
        for i, p in enumerate(pts):
            _eq(tq.test_point(batch, p, world), want_point[i], "test_point")
        assert bool(want_point.any()) and bool(want_aabb.any())
    elif kind == "picks":
        with jax.disable_jit():
            want_found, want_body = jax.vmap(lambda p: jq.pick_body(js, p))(pts)
        for i, p in enumerate(pts):
            found, body = tq.pick_body(batch, p, world)
            _eq(found, want_found[i], "pick found")
            _eq(body, want_body[i], "pick body")
        assert bool(want_found.any()) and not bool(want_found.all())
    else:
        p1 = rng.uniform(-6, 6, (5, 2)).astype(np.float32)
        p2 = rng.uniform(-6, 6, (5, 2)).astype(np.float32)
        p2[:2, 1] = p1[:2, 1]  # horizontal rays through the scene
        hits = 0
        for cap in (64, 4):
            with jax.disable_jit():
                want = jax.vmap(lambda a, b: jq.raycast_world(js, a, b, max_candidates=cap))(p1, p2)
            for i in range(len(p1)):
                got = tq.raycast_world(batch, p1[i], p2[i], max_candidates=cap, world=world)
                for name, g, w in zip(want._fields, got, want):
                    _eq(g, w[i], f"raycast_world[{cap}] {name}")
                hits += int(got.hit)
        assert hits > 0


def test_mouse_joint_edits_match_jax():
    """attach_mouse_joint, move_mouse_target and detach_mouse_joint on one
    world (the JAX shapes) and on a batch (the same slot in every world,
    a body and a target a world) against the JAX functions."""
    jstates, batch = _scenes("pyramid")
    slot = 0
    one = batch.map(lambda x: x[0].clone())
    with jax.disable_jit():
        want = [jq.attach_mouse_joint(js, slot, 3 + w, (0.5, 2.0 + w), hertz=5.0, damping_ratio=0.6)
                for w, js in enumerate(jstates)]
        moved = [jq.move_mouse_target(s, slot, (1.5, -0.25)) for s in want]
        gone = [jq.detach_mouse_joint(s, slot) for s in moved]
    got1 = tq.attach_mouse_joint(one, slot, 3, (0.5, 2.0), hertz=5.0, damping_ratio=0.6)
    assert_tree_close(to_numpy(got1.joints), np_tree(want[0].joints), EXACT)
    gotb = tq.attach_mouse_joint(batch, slot, torch.tensor([3, 4]), torch.tensor([[0.5, 2.0], [0.5, 3.0]]),
                                 hertz=5.0, damping_ratio=0.6)
    movedb = tq.move_mouse_target(gotb, slot, (1.5, -0.25))
    goneb = tq.detach_mouse_joint(movedb, slot)
    for w in range(2):
        for g, r in ((gotb, want), (movedb, moved), (goneb, gone)):
            assert_tree_close({k: v[w] for k, v in to_numpy(g.joints).items()}, np_tree(r[w].joints), EXACT)
    assert not bool(batch.joints.alive[:, slot].any())  # the input is left as it was


# ---------------------------------------------- the slice as a whole

DRAG_STEPS = 3
SLICE_KW = dict(iterations=1, gjk_iters=4, max_colors=5, joint_max_colors=1)


@pytest.mark.parametrize("world", [0, 1])
@pytest.mark.parametrize("solver", ["TGS_SOFT", "PGS_NGS_BLOCK"])
def test_pick_drag_release_matches_jax_step(solver, world):
    """A base-3 pyramid, 2 worlds with jittered velocities: in each world
    pick the top box at its center, attach a mouse joint from the ground,
    drag it for 3 steps (the target moved before each), and detach. The port's per-world step (TGS_Soft: the fused route,
    K1's plain twin; PGS_NGS_Block: the XLA route) against the JAX
    package's `step` on one world with the same edits, after every step
    and after the detach."""
    w, ids = jax_pyramid(JSolver[solver], 3)
    # one substep, 4 GJK trips and the fewest colors with no overflow:
    # JAX's eager step runs each trip, and each color of each substep, op
    # by op
    jstate, jcfg = w.freeze(solver=JSolver[solver], narrowphase="lanes", **dict(WORLD_KW, **SLICE_KW))
    worlds = jax_worlds(jstate, 2)
    batch = state_from_numpy(stack(worlds), device="cpu")
    cfg = port_config(jcfg)
    assert use_fused(cfg) == (solver == "TGS_SOFT")
    step = batched_step(cfg)
    ref = worlds[world]
    top = ids[-1]
    slot = int(np.asarray(jstate.joints.alive).sum())

    def both(ref, batch):
        with jax.disable_jit():
            ref = jax_step(ref, jnp.float32(DT), jcfg)
        batch = step(batch, DT)
        got = {g: {k: v[world] for k, v in d.items()} for g, d in to_numpy(batch).items() if isinstance(d, dict)}
        assert_tree_close(got, np_tree(ref), EXACT)
        return ref, batch

    center = to_numpy(batch)["bodies"]["position"][:, top]  # [W, 2]
    found, body = tq.pick_body(batch, center[world], world)
    with jax.disable_jit():
        jfound, jbody = jq.pick_body(ref, center[world])
    assert bool(found) and int(body) == top and int(jbody) == top
    targets = [center + np.float32(0.2 * (i + 1)) for i in range(DRAG_STEPS)]
    batch = tq.attach_mouse_joint(batch, slot, int(body), torch.from_numpy(center), hertz=5.0)
    with jax.disable_jit():
        ref = jq.attach_mouse_joint(ref, slot, int(jbody), center[world], hertz=5.0)
    for t in targets:
        batch = tq.move_mouse_target(batch, slot, torch.from_numpy(t))
        with jax.disable_jit():
            ref = jq.move_mouse_target(ref, slot, t[world])
        ref, batch = both(ref, batch)
    assert float(batch.joints.motor_impulse[world, slot].abs()) > 0 or float(
        batch.joints.impulse[world, slot].abs().max()) > 0
    batch = tq.detach_mouse_joint(batch, slot)
    with jax.disable_jit():
        ref = jq.detach_mouse_joint(ref, slot)
    got = {g: {k: v[world] for k, v in d.items()} for g, d in to_numpy(batch).items() if isinstance(d, dict)}
    assert_tree_close(got, np_tree(ref), EXACT)
    assert int(batch.diag.color_overflow[world]) == 0
