"""The port's runtime edits, metrics, checks, checkpoints, handles,
settings, timing and batch helpers against the JAX package's, on the CPU,
on the same inputs (made from a seed with numpy), and the lane step's
refusal of `solve_contacts=False`.

Integers are equal and floats equal bit for bit, but where a rotation
comes from an angle: `math2d.make_rot` takes sin and cos in float64 and
rounds them, where the JAX package calls XLA's float32 sin and cos; the
two differ by 1 ulp on about 1% of angles. Such rotations are held to 1
ulp, and the steps after them to EDIT_STEP_TOL.
"""

import dataclasses
import inspect
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models.contact_scenes import pyramid_world as jax_pyramid
from solver2d_tpu.models.joint_scenes import bridge as jax_bridge
from solver2d_tpu.step import step as jax_step
from solver2d_tpu_torch import batched_step, state_from_numpy, to_numpy
from torch_parity import DT, WORLD_KW, assert_tree_close, jax_worlds, np_tree, port_config, stack, to_jax

torch.set_num_threads(1)
EXACT = dict(rtol=0, atol=0)
# the steps after an edit that set a rotation from an angle, 1 ulp apart:
# the steps carry the ulp on to positions, anchors and velocities of a few
# units, a few times 1e-7 at most
EDIT_STEP_TOL = dict(rtol=0, atol=1e-6)
ULP_FIELDS = {"rot", "rot0"}


def _differing_angle(seed):
    """The first of seeded random angles in [-7, 7] whose rotation the port
    rounds differently from the JAX package: the edits that take an angle
    are tested where the two differ."""
    from solver2d_tpu.ops import math2d as jm
    from solver2d_tpu_torch.ops import math2d as tm

    a = np.random.RandomState(seed).uniform(-7, 7, 1000).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jm.make_rot(a))
    differs = (tm.make_rot(torch.from_numpy(a)).numpy() != want).any(-1)
    return float(a[int(np.argmax(differs))])


def _world(tree, w):
    return {k: ({f: a[w] for f, a in v.items()} if isinstance(v, dict) else v[w]) for k, v in tree.items()}


def _assert_state(port_tree, jstate, tol=EXACT, ulp_fields=()):
    """The port's numpy tree of one world against a JAX state: exact (or
    within tol), but the fields in ulp_fields within 1 float32 ulp."""
    ref = np_tree(jstate)
    for group, fields in port_tree.items():
        if not isinstance(fields, dict):
            np.testing.assert_array_equal(fields, np.asarray(getattr(ref, group)))
            continue
        sub = getattr(ref, group)
        for k, v in fields.items():
            r = np.asarray(getattr(sub, k))
            if k in ulp_fields:
                np.testing.assert_array_max_ulp(v, r, maxulp=1)
            else:
                assert_tree_close({k: v}, {k: r}, tol, f"{group}.")


def _stepped_pyramid(solver="TGS_SOFT", worlds=2, steps=1, **kw):
    """(JAX states of each world, JAX config, port batch, port config): a
    base-3 pyramid with one spare joint slot, `worlds` worlds with jittered
    velocities, stepped `steps` times by the port (so that contacts are
    live), the JAX states read from the port's."""
    w, ids = jax_pyramid(JSolver[solver], 3)
    jstate, jcfg = w.freeze(solver=JSolver[solver], narrowphase="lanes",
                            **dict(WORLD_KW, iterations=1, max_colors=5, joint_max_colors=1, **kw))
    batch = state_from_numpy(stack(jax_worlds(jstate, worlds)), device="cpu")
    cfg = port_config(jcfg)
    step = batched_step(cfg)
    for _ in range(steps):
        batch = step(batch, DT)
    tree = to_numpy(batch)
    return [to_jax(jstate, _world(tree, i)) for i in range(worlds)], jcfg, batch, cfg, ids


# ----------------------------------------------------------- runtime edits


def _edits(rt, s, angle, n, per_world=None):
    """One of each runtime edit of `rt` (the port's or the JAX package's
    `utils.runtime` and `queries`) on state s; yields (name, state) after
    each. `per_world`, on a batch, gives each world its own velocity."""
    q = rt.queries
    s = q.attach_mouse_joint(s, 0, n - 1, (0.0, 3.0))
    yield "attach", s
    s = rt.runtime.set_bodies_alive(s, [2, 3], False)
    yield "set_bodies_alive False", s
    s = rt.runtime.set_bodies_alive(s, [2], True)
    yield "set_bodies_alive True", s
    s = rt.runtime.teleport_bodies(s, [1, 4], np.array([[0.5, 3.0], [1.0, 5.0]], np.float32))
    yield "teleport", s
    s = rt.runtime.teleport_bodies(s, [5], np.array([[-1.0, 2.5]], np.float32), reset_velocity=False)
    yield "teleport keeping velocity", s
    s = rt.runtime.set_linear_velocity(s, 2, per_world if per_world is not None else (1.0, -2.0))
    yield "set_linear_velocity", s
    s = rt.runtime.set_angular_velocity(s, 3, 0.7)
    yield "set_angular_velocity", s
    s = rt.runtime.apply_force_to_center(s, 4, (3.0, 4.0))
    yield "apply_force_to_center", s
    s = rt.runtime.apply_linear_impulse(s, 5, (0.3, -0.2), (0.1, 1.2))
    yield "apply_linear_impulse", s
    s = rt.runtime.set_transform(s, 6, (0.25, 4.0), angle)
    yield "set_transform", s
    s = rt.runtime.destroy_shape(s, 1)
    yield "destroy_shape", s
    s = rt.runtime.destroy_joint(s, 0)
    yield "destroy_joint", s
    s = rt.runtime.destroy_body(s, 2)
    yield "destroy_body", s


class _Pkg:
    def __init__(self, runtime, queries):
        self.runtime, self.queries = runtime, queries


def test_runtime_edits_match_jax():
    """Every runtime edit on a stepped 2-world pyramid batch (the same slots
    in every world, world 1 with its own velocity where a value can differ)
    and on one world, against the JAX functions on each world; then 2 steps
    of the edited worlds."""
    from solver2d_tpu import queries as jq
    from solver2d_tpu.utils import runtime as jrt
    from solver2d_tpu_torch import queries as tq
    from solver2d_tpu_torch.utils import runtime as trt

    jstates, jcfg, batch, cfg, ids = _stepped_pyramid()
    assert int(batch.contacts.alive.sum()) > 0
    angle = _differing_angle(2)
    n = len(ids) + 1
    per_world = torch.tensor([[1.0, -2.0], [-0.5, 0.25]])
    jp, tp = _Pkg(jrt, jq), _Pkg(trt, tq)
    with jax.disable_jit():
        want = [list(_edits(jp, js, angle, n, per_world=np.asarray(per_world[i]))) for i, js in enumerate(jstates)]
    got_b = list(_edits(tp, batch, angle, n, per_world=per_world))
    got_1 = list(_edits(tp, batch.map(lambda x: x[1].clone()), angle, n, per_world=per_world[1]))
    for k, (name, s) in enumerate(got_b):
        tree = to_numpy(s)
        ulp = ULP_FIELDS if k >= 9 else ()  # from set_transform on
        for i in range(2):
            _assert_state(_world(tree, i), want[i][k][1], ulp_fields=ulp)
        _assert_state(to_numpy(got_1[k][1]), want[1][k][1], ulp_fields=ulp)
    assert not bool(batch.joints.alive.any())  # the input is left as it was

    edited, ref = got_b[-1][1], want[1][-1][1]
    step = batched_step(cfg)
    for _ in range(2):
        edited = step(edited, DT)
        with jax.disable_jit():
            ref = jax_step(ref, jnp.float32(DT), jcfg)
        _assert_state(_world(to_numpy(edited), 1), ref, EDIT_STEP_TOL, ulp_fields=ULP_FIELDS)


def test_make_rot_within_one_ulp_of_jax():
    """`math2d.make_rot` against the JAX package's on random angles: at most
    1 ulp apart, and equal on most."""
    from solver2d_tpu.ops import math2d as jm
    from solver2d_tpu_torch.ops import math2d as tm

    a = np.random.RandomState(9).uniform(-7, 7, 20000).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jm.make_rot(a))
    got = tm.make_rot(torch.from_numpy(a)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert (got == want).mean() > 0.95


# --------------------------------------------------------------- metrics


@pytest.mark.parametrize("cold", [False, True])
def test_gjk_stats_match_jax(cold):
    """The GJK counters of a pyramid after 3 steps, warm-started from the
    contact table's caches and from scratch: all four counts equal."""
    from solver2d_tpu.utils.metrics import gjk_stats as jax_gjk_stats
    from solver2d_tpu_torch.utils.metrics import gjk_stats

    jstates, _, batch, _, _ = _stepped_pyramid(worlds=2, steps=3)
    got = gjk_stats(batch, gjk_iters=10, cold=cold, world=1)
    with jax.disable_jit():
        want = jax_gjk_stats(jstates[1], gjk_iters=10, cold=cold)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.calls > 0 and (got.cache_hits == 0) == cold


def test_joint_error_matches_jax():
    """`joint_error` of Bridges whose planks were moved and turned at
    random, each world against the JAX metric, bit for bit."""
    from solver2d_tpu.utils.metrics import joint_error as jax_joint_error
    from solver2d_tpu_torch.utils.metrics import joint_error

    jstate, _ = jax_bridge(JSolver.TGS_SOFT, 8).world.freeze()
    rng = np.random.RandomState(3)
    worlds = []
    for _ in range(3):
        b = np_tree(jstate.bodies)
        dyn = np.asarray(b.type) == 2
        ang = rng.uniform(-0.5, 0.5, dyn.sum()).astype(np.float32)
        rot = np.asarray(b.rot).copy()
        rot[dyn] = np.stack([np.sin(ang), np.cos(ang)], -1)
        origin = np.asarray(b.origin) + np.where(dyn[:, None], rng.normal(scale=0.05, size=(len(dyn), 2)), 0)
        worlds.append(dataclasses.replace(jstate, bodies=dataclasses.replace(
            jstate.bodies, rot=jnp.asarray(rot), origin=jnp.asarray(origin.astype(np.float32)))))
    batch = state_from_numpy(stack(worlds), device="cpu")
    got = joint_error(batch).numpy()
    with jax.disable_jit():
        want = np.array([np.asarray(jax_joint_error(w)) for w in worlds])
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all()


# ---------------------------------------------------------------- checks


def test_health_and_reset_match_jax():
    """world_health on a 4-world batch with one world blown up through
    set_linear_velocity and one with a NaN, and reset_unhealthy_worlds,
    against the JAX functions (the health under `vmap`)."""
    from solver2d_tpu.utils.checks import reset_unhealthy_worlds as jreset, world_health as jhealth
    from solver2d_tpu_torch.utils import runtime
    from solver2d_tpu_torch.utils.checks import reset_unhealthy_worlds, world_health

    jstates, _, batch, _, _ = _stepped_pyramid(worlds=4)
    initial = batch.map(lambda x: x.clone())
    v = batch.bodies.v[:, 3].clone()
    v[1] = 1e6
    bad = runtime.set_linear_velocity(batch, 3, v)
    bad.bodies.w[3, 2] = float("nan")
    jbad = to_jax(stack(jstates), to_numpy(bad))
    jinit = to_jax(stack(jstates), to_numpy(initial))
    health = world_health(bad)
    with jax.disable_jit():
        want = jax.vmap(jhealth)(jbad)
        fixed = jreset(jbad, jinit)
    np.testing.assert_array_equal(health.numpy(), np.asarray(want))
    assert health.tolist() == [True, False, True, False]
    assert not bool(world_health(bad.map(lambda x: x[1])))  # one world: a 0-dim bool
    got = reset_unhealthy_worlds(bad, initial)
    assert_tree_close(to_numpy(got), np_tree(fixed), EXACT)
    assert bool(world_health(got).all())


def test_validate_state_and_color_disjointness_match_jax():
    """validate_state on a valid world and on worlds broken three ways, and
    check_color_disjointness on the step's colors and on colors made to
    clash: the same answers as the JAX functions."""
    from solver2d_tpu.utils.checks import check_color_disjointness as jdisjoint, validate_state as jvalidate
    from solver2d_tpu_torch.utils.checks import check_color_disjointness, validate_state

    jstates, jcfg, batch, cfg, _ = _stepped_pyramid(steps=2)
    assert validate_state(batch, cfg, world=1) == [] == jvalidate(jstates[1], jcfg)
    broken = batch.map(lambda x: x.clone())
    broken.bodies.alive[0, 2] = False                                 # a live shape on a dead body
    live = torch.nonzero(broken.contacts.alive[0])[:, 0]
    broken.contacts.key[0, live[1]] = broken.contacts.key[0, live[0]]  # duplicate keys, a key mismatch
    broken.contacts.point_count[0, ~broken.contacts.alive[0]] = 1    # dead contacts with points
    got = validate_state(broken, cfg, world=0)
    with jax.disable_jit():
        want = jvalidate(to_jax(jstates[0], _world(to_numpy(broken), 0)), jcfg)
    assert got == want and len(got) == 4, (got, want)

    c = batch.contacts
    dyn = (batch.bodies.type[1] == 2) & batch.bodies.alive[1]
    args = (c.body_a[1], c.body_b[1], c.color[1], c.alive[1] & (c.point_count[1] > 0), dyn, cfg.max_colors)
    np_args = [np.asarray(a) if isinstance(a, torch.Tensor) else a for a in args]
    assert check_color_disjointness(*args) == jdisjoint(*np_args) is True
    clash = c.color[1].clone()
    clash[args[3]] = 0  # every touching contact in color 0
    args = args[:2] + (clash,) + args[3:]
    np_args = [np.asarray(a) if isinstance(a, torch.Tensor) else a for a in args]
    assert check_color_disjointness(*args) == jdisjoint(*np_args) is False


# ----------------------------------------------------------- checkpoints


def test_checkpoints_cross_both_ways(tmp_path):
    """A file the port writes loads in the JAX package, and one the JAX
    package writes loads in the port, with equal states: one world and a
    batch."""
    from solver2d_tpu.utils.checkpoint import load_npz as jload, save_npz as jsave
    from solver2d_tpu_torch.utils.checkpoint import load_npz, save_npz

    jstates, _, batch, _, _ = _stepped_pyramid(solver="TGS_STICKY")
    assert batch.contacts.friction_persisted.shape[-1] > 0  # TGS_Sticky's anchor fields travel too
    for label, port, jax_state in (("one", batch.map(lambda x: x[1]), jstates[1]),
                                   ("batch", batch, stack(jstates))):
        p1 = str(tmp_path / f"port_{label}.npz")
        save_npz(p1, port)
        assert_tree_close(to_numpy(port), np_tree(jload(p1)), EXACT)
        p2 = str(tmp_path / f"jax_{label}.npz")
        jsave(p2, jax.tree.map(jnp.asarray, jax_state))
        back = load_npz(p2, device="cpu")
        assert_tree_close(to_numpy(back), np_tree(jax_state), EXACT)
        assert back.shapes.filter_mask.dtype == torch.int32


# --------------------------------------------------------------- handles


def _handle_script(pkg_handles, state, angle):
    """A sequence of handle operations; returns the states after each and
    the ids."""
    h = pkg_handles.WorldHandles.for_state(state)
    out = []
    state, b1 = h.create_body(state, position=(1.0, 6.0), angle=angle, velocity=(0.5, 0.0), angular_velocity=0.3)
    out.append(state)
    state, s1 = h.create_box_shape(state, b1, 0.4, 0.3, friction=0.4)
    out.append(state)
    state, b2 = h.create_body(state, position=(-1.0, 7.0), body_type=0, mass=0.0)
    out.append(state)
    state, s2 = h.create_circle_shape(state, b2, (0.1, 0.0), 0.25)
    out.append(state)
    state = h.destroy_shape(state, s1)
    out.append(state)
    state = h.destroy_body(state, b1)
    out.append(state)
    with pytest.raises(pkg_handles.StaleHandleError):
        h.destroy_body(state, b1)
    state, b3 = h.create_body(state, position=(2.0, 8.0))
    out.append(state)
    assert b3.index == b1.index and b3.revision == b1.revision + 1
    j = h.alloc_joint_slot()
    return out, (b1, s1, b2, s2, b3, j)


def test_handles_match_jax():
    """The same create, destroy and reuse sequence through both packages'
    handles on one world: equal ids, equal stale-handle refusals, equal
    states (rotations from an angle within 1 ulp); the port's on a batch
    gives world 1 the one-world result and writes the new bodies alike in
    every world."""
    import solver2d_tpu.utils.handles as jh
    import solver2d_tpu_torch.utils.handles as th

    jstates, _, batch, _, _ = _stepped_pyramid(max_bodies=16, max_shapes=16)
    angle = _differing_angle(4)
    with jax.disable_jit():
        want, jids = _handle_script(jh, jstates[1], angle)
    got, ids = _handle_script(th, batch.map(lambda x: x[1]), angle)
    gotb, idsb = _handle_script(th, batch, angle)
    assert [tuple(i) for i in ids] == [tuple(i) for i in jids] == [tuple(i) for i in idsb]
    for g, gb, w in zip(got, gotb, want):
        _assert_state(to_numpy(g), w, ulp_fields=ULP_FIELDS)
        assert_tree_close(_world(to_numpy(gb), 1), to_numpy(g), EXACT)
        new = [i.index for i in ids[::2][:2]] + [ids[4].index]  # the bodies created
        for k, v in to_numpy(gb.bodies).items():
            np.testing.assert_array_equal(v[0, new], v[1, new], err_msg=k)
    pool = th.HandlePool(2, [0])
    pool.alloc()
    with pytest.raises(th.PoolExhaustedError):
        pool.alloc()


# --------------------------------------------------------------- settings


def test_settings_cross_both_ways(tmp_path):
    from solver2d_tpu.utils.settings import Settings as JSettings
    from solver2d_tpu_torch.utils.settings import Settings

    s = Settings(hertz=120.0, velocity_iterations=8, warm_start=False, solvers_enabled=["TGS_SOFT", "XPBD"])
    p = str(tmp_path / "port.json")
    s.save(p)
    assert dataclasses.asdict(JSettings.load(p)) == dataclasses.asdict(s)
    j = JSettings(relax_iterations=3, draw_aabbs=True)
    p2 = str(tmp_path / "jax.json")
    j.save(p2)
    assert dataclasses.asdict(Settings.load(p2)) == dataclasses.asdict(j)
    assert Settings.load(str(tmp_path / "missing.json")) == Settings()
    with open(p2, "w") as f:
        json.dump({"hertz": 30.0}, f)
    assert Settings.load(p2).hertz == 30.0 and Settings.load(p2).velocity_iterations == 4


# -------------------------------------------------------------- profiling


def test_profiling(tmp_path):
    """StepTimer keeps the first call apart; trace writes a Chrome trace;
    stage_times times the stages the JAX package's names (read from its
    source)."""
    import solver2d_tpu.utils.profiling as jprof
    from solver2d_tpu_torch.utils import profiling

    _, _, batch, cfg, _ = _stepped_pyramid()
    step = batched_step(cfg)
    timer = profiling.StepTimer()
    for _ in range(3):
        batch = timer.timed(step, batch, DT)
    assert timer.steps == 3 and timer.compile_s > 0 and timer.ms_per_step > 0 and timer.steps_per_sec > 0
    with profiling.trace(str(tmp_path / "trace")) as d:
        batch = step(batch, DT)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) > 100
    times = profiling.stage_times(batch, cfg, repeats=1)
    jax_names = re.findall(r'bench\(\s*"(\w+)"', inspect.getsource(jprof.stage_times))
    assert list(times) == jax_names == ["broadphase", "narrowphase", "coloring", "full_step"]
    assert all(t > 0 for t in times.values())


# ---------------------------------------------------------------- batches


def test_randomize_velocities_and_replicate_match_jax():
    """randomize_velocities with the deltas the JAX function draws from its
    key (applied by apply_velocity_deltas) equals the JAX function;
    replicate_state equals the JAX one; the port's own draw, from a
    generator, moves only live dynamic bodies and repeats with its seed."""
    from solver2d_tpu.parallel.batch import randomize_velocities as jrand, replicate_state as jrep
    from solver2d_tpu_torch.parallel import apply_velocity_deltas, randomize_velocities, replicate_state

    jstates, _, batch, _, _ = _stepped_pyramid(worlds=3)
    jbatch = to_jax(stack(jstates), to_numpy(batch))
    key = jax.random.PRNGKey(7)
    n, b = batch.bodies.v.shape[:2]
    with jax.disable_jit():
        want = jrand(jbatch, key, scale=0.3)
        kv, kw = jax.random.split(key)
        dv = 0.3 * jax.random.normal(kv, (n, b, 2), jnp.float32)
        dw = 0.3 * jax.random.normal(kw, (n, b), jnp.float32)
        rep = jrep(jstates[0], 3)
    got = apply_velocity_deltas(batch, torch.from_numpy(np.array(dv)), torch.from_numpy(np.array(dw)))
    assert_tree_close(to_numpy(got.bodies), np_tree(want.bodies), EXACT)
    assert_tree_close(to_numpy(replicate_state(batch.map(lambda x: x[0]), 3)), np_tree(rep), EXACT)

    r1 = randomize_velocities(batch, torch.Generator().manual_seed(1), scale=0.3)
    r2 = randomize_velocities(batch, torch.Generator().manual_seed(1), scale=0.3)
    assert torch.equal(r1.bodies.v, r2.bodies.v)
    dyn = (batch.bodies.type == 2) & batch.bodies.alive
    moved = (r1.bodies.v != batch.bodies.v).any(-1)
    assert bool(moved[dyn].all()) and not bool(moved[~dyn].any())


# ------------------------------------------------------- the lane step


def test_lane_freeze_refuses_solve_contacts_false():
    """The lane step is the contact solve: `World.freeze` refuses
    `lane_solve=True` with `solve_contacts=False`, as the JAX package's
    does. A jointless scene still freezes for it with the default
    `solve_joints=True` (ROADMAP §3, a difference on purpose)."""
    from solver2d_tpu_torch import SolverType, pyramid_world

    w, _ = pyramid_world(SolverType.TGS_SOFT, 3)
    with pytest.raises(AssertionError, match="lane_solve IS the contact solve"):
        w.freeze(device="cpu", lane_solve=True, solve_contacts=False, contact_bucket_cap=-1)
    _, cfg = w.freeze(device="cpu", lane_solve=True, contact_bucket_cap=-1)
    assert cfg.lane_solve and cfg.solve_contacts and cfg.solve_joints


def test_package_surface_matches_jax():
    """The names the JAX package exports, and the batch helpers."""
    import solver2d_tpu
    import solver2d_tpu_torch
    import solver2d_tpu_torch.parallel as par

    for name in ("BodyType", "ShapeType", "SimConfig", "SolverType", "Bodies", "Contacts", "Diagnostics",
                 "Joints", "Shapes", "State", "BodyDef", "ShapeDef", "World", "__version__"):
        assert hasattr(solver2d_tpu, name) and hasattr(solver2d_tpu_torch, name), name
    assert solver2d_tpu_torch.__version__ == solver2d_tpu.__version__
    assert par.replicate_state is par.replicate and callable(par.randomize_velocities)
    assert [m.name for m in solver2d_tpu_torch.ShapeType] == [m.name for m in solver2d_tpu.ShapeType]
