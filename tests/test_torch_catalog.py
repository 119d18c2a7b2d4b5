"""The port's scene catalog (solver2d_tpu_torch.models), its hooks, its
runtime and metrics helpers and its headless testbed against the JAX
package's, on the CPU.

- The catalog: the same 26 names; every scene's frozen `State` equal to the
  JAX `World.freeze()`'s leaf by leaf and bit for bit (center of mass
  included), its `SimConfig` equal on every shared field.
- Steps: the port advances a scene a few dozen steps on the CPU (K1 and K2
  through their plain twins), `torch_parity.to_jax` carries that mid-run
  state to JAX, and both take 2 steps: the port's `batched_step` and the
  JAX per-world `step` (XLA solver, lane narrowphase, op by op under
  `jax.disable_jit()`). Integers are equal; floats within `STEP_TOL`.
- Hooks, `destroy_body`, the testbed's stats line and the refusals.

Sizes are cut as in tests/test_scenes.py (`SMALL`); the step cases pick
scenes, sizes and color counts that keep JAX's op-by-op step short (its
time grows with the colors it sweeps): each config is stated in `STEPS`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models import SCENES as JSCENES
from solver2d_tpu.models import scene_names as jax_scene_names
from solver2d_tpu.step import step as jax_step
from solver2d_tpu.utils import runtime as jruntime
from solver2d_tpu.utils.metrics import statistics as jax_statistics
from solver2d_tpu_torch import SolverType, batched_step, replicate, scene_names, to_numpy
from solver2d_tpu_torch.models import SCENES
from solver2d_tpu_torch.testbed import parse_solvers, run_scene
from solver2d_tpu_torch.utils import runtime
from torch_parity import DT, WORLD_KW, assert_tree_close, np_tree, to_jax

torch.set_num_threads(1)
EXACT = dict(rtol=0, atol=0)

# reduced sizes of the big scenes (tests/test_scenes.py)
SMALL = {
    ("Joints", "Joint Grid"): dict(numk=8, numi=8),
    ("Joints", "Ragdoll Stress"): dict(count=4),
    ("Contact", "Rush"): dict(count=50),
    ("Contact", "Confined"): dict(grid_count=8),
}


def _scenes(key, solver="TGS_SOFT", **kw):
    """The JAX and the port's scene of `key`, built with the same args."""
    return JSCENES[key](JSolver[solver], **kw), SCENES[key](SolverType[solver], **kw)


def test_scene_names_match_jax():
    assert scene_names() == jax_scene_names()
    assert len(scene_names()) == 26


@pytest.mark.parametrize("key", jax_scene_names(), ids=lambda k: f"{k[0]}-{k[1]}")
def test_freeze_matches_jax(key):
    """Every field the port keeps, bit for bit; the shared config fields;
    the route (`use_fused_solver`, the port's own field): K1 for these
    TGS_Soft scenes, which all fit it."""
    jscene, pscene = _scenes(key, **SMALL.get(key, {}))
    jstate, jcfg = jscene.freeze()
    pstate, pcfg = pscene.freeze(device="cpu")
    for f in dataclasses.fields(pcfg):
        if f.name != "use_fused_solver":
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert pcfg.use_fused_solver is True
    got = to_numpy(pstate)
    assert_tree_close(got, np_tree(jstate), EXACT)
    if key in (("Contact", "Arch"), ("Joints", "Ragdoll"), ("Far", "Ragdoll Pile")):
        # off-center bodies: the hull blocks of the arch, the humans' heads and lower legs
        assert np.abs(got["bodies"]["local_center"]).max() > 0.05


# ------------------------------------------------------------------ steps

# Float tolerances of the step cases, about 4x the largest differences
# seen over them: Ragdoll (every solver), Rush, Far Stack, Arch and Joint
# Grid are bit-equal to the JAX step; Confined, whose circles each touch
# several others (the XLA reference sums a body's contacts with a
# scatter-add, in an order of its own), differs by up to 9.5e-7 in
# positions, 7.2e-6 in velocities, 5.7e-6 in impulses and 1.8e-7 in the
# rest (normals). All far inside
# tests/test_pallas_solver.py:81-88 (2e-4 position, 1e-3 velocity, 2e-3
# impulse). On Far scenes a world coordinate's tolerance also grows with
# its size (`FAR_RTOL`, 4 float32 ulps of the coordinate).
STEP_TOL = {"position": 4e-6, "velocity": 3e-5, "impulse": 2.5e-5, "other": 1e-6}
FAR_RTOL = 4 * 2.0**-23
_GROUP = {
    "bodies.origin": "position", "bodies.position": "position", "shapes.aabb": "position",
    "shapes.fat_aabb": "position", "bodies.v": "velocity", "bodies.w": "velocity",
    "contacts.normal_impulse": "impulse", "contacts.tangent_impulse": "impulse", "joints.impulse": "impulse",
    "joints.motor_impulse": "impulse", "joints.lower_impulse": "impulse", "joints.upper_impulse": "impulse",
}


def _assert_step_close(port: dict, ref, far: bool):
    for group, fields in port.items():
        if not isinstance(fields, dict):
            continue
        for k, v in fields.items():
            name = f"{group}.{k}"
            r = np.asarray(getattr(getattr(ref, group), k))
            assert v.shape == r.shape and v.dtype == r.dtype, name
            if v.dtype.kind != "f":
                np.testing.assert_array_equal(v, r, err_msg=name)
                continue
            kind = _GROUP.get(name, "other")
            rtol = FAR_RTOL if far and kind == "position" else 0.0
            np.testing.assert_allclose(v, r, rtol=rtol, atol=STEP_TOL[kind], err_msg=name)


# (scene, builder args, steps the port advances first, the config both
# run, the JAX-only config). The color counts are the fewest with no color
# overflow over the run. Joint-free scenes skip the JAX solver's inert
# joint phases (`solve_joints=False`), Joint Grid its inert contact phases
# (`solve_contacts=False`); the fused solve runs them over empty tables,
# which changes nothing. Confined at 20 x 20 so that its circles start
# overlapped and reach the capsule walls; the Ragdoll's feet reach the
# ground at step 56; Rush's spiral of circles touches from step 5.
STEPS = {
    "ragdoll": (("Joints", "Ragdoll"), {}, 56, dict(max_colors=3, joint_max_colors=4), {}),
    "confined": (("Contact", "Confined"), dict(grid_count=20), 12, dict(max_colors=6, joint_max_colors=1),
                 dict(solve_joints=False)),
    "rush": (("Contact", "Rush"), dict(count=50), 24, dict(max_colors=3, joint_max_colors=1),
             dict(solve_joints=False)),
    "far_stack": (("Far", "Stack"), {}, 24, dict(max_colors=3, joint_max_colors=1), dict(solve_joints=False)),
    "arch": (("Contact", "Arch"), {}, 24, dict(max_colors=4, joint_max_colors=1), dict(solve_joints=False)),
    "joint_grid": (("Joints", "Joint Grid"), dict(numk=4, numi=4), 24, dict(max_colors=1, joint_max_colors=5),
                   dict(solve_contacts=False)),
}


def _check_steps(case, solver="TGS_SOFT"):
    key, args, advance, cfg_kw, jax_kw = STEPS[case]
    jscene, pscene = _scenes(key, solver, **args)
    jstate, jcfg = jscene.freeze(narrowphase="lanes", **WORLD_KW, **cfg_kw, **jax_kw)
    pstate, pcfg = pscene.freeze(device="cpu", **WORLD_KW, **cfg_kw)
    step = batched_step(pcfg)
    batch = replicate(pstate, 1)
    for _ in range(advance):
        if pscene.pre_step is not None:
            batch = pscene.pre_step(batch)
        batch = step(batch, DT)
    ref = to_jax(jstate, to_numpy(batch.map(lambda x: x[0])))
    for _ in range(2):
        with jax.disable_jit():
            if pscene.pre_step is not None:
                batch, ref = pscene.pre_step(batch), jscene.pre_step(ref)
            ref = jax_step(ref, jnp.float32(DT), jcfg)
        batch = step(batch, DT)
        _assert_step_close(to_numpy(batch.map(lambda x: x[0])), ref, far=key[0] == "Far")
        assert int(batch.diag.color_overflow[0]) == 0 and not bool(batch.diag.pair_overflow[0])
    return batch


@pytest.mark.parametrize("case", list(STEPS))
def test_step_matches_jax(case):
    batch = _check_steps(case)
    if case == "joint_grid":
        # category filter: the lattice's circles never pair; its joints hold it
        assert int(batch.diag.pair_count[0]) == 0 and int(batch.joints.alive[0].sum()) == 24
    else:
        assert int(batch.diag.contact_count[0]) > 0
    if case == "confined":  # circle-capsule contacts with the static walls (shapes 0-3)
        c = batch.contacts
        assert bool((c.alive[0] & (c.point_count[0] > 0) & (c.shape_a[0] < 4)).any())


@pytest.mark.parametrize("solver", ["SOFT_STEP", "PGS_SOFT"])
def test_ragdoll_step_matches_jax_per_solver(solver):
    """Capsules, limits and motors, multi-shape off-center bodies and the
    group filter under the other two fused solvers."""
    batch = _check_steps("ragdoll", solver)
    assert int(batch.diag.contact_count[0]) > 0
    j = batch.joints
    assert bool(j.enable_limit[0].any()) and float(j.motor_impulse[0].abs().max()) > 0


# ------------------------------------------------------------------ hooks


def test_rush_forces_match_jax():
    jscene, pscene = _scenes(("Contact", "Rush"), count=50)
    jstate, _ = jscene.freeze()
    pstate, _ = pscene.freeze(device="cpu")
    got = pscene.pre_step(replicate(pstate, 2)).bodies.force
    with jax.disable_jit():
        want = np.asarray(jscene.pre_step(jstate).bodies.force)
    assert np.abs(want).max() > 0
    for w in range(2):
        np.testing.assert_array_equal(got[w].numpy(), want)


def _mid_run(key, steps, **kw):
    """The JAX and port scenes of `key` and the state after `steps` port
    steps on the CPU, as a port batch of one world and as a JAX state."""
    jscene, pscene = _scenes(key, **kw)
    jstate, _ = jscene.freeze()
    pstate, cfg = pscene.freeze(device="cpu", iterations=2, extra_iterations=1)
    batch, step = replicate(pstate, 1), batched_step(cfg)
    for _ in range(steps):
        batch = step(batch, DT)
    return jscene, pscene, batch, to_jax(jstate, to_numpy(batch.map(lambda x: x[0])))


def _alive(tree):
    return {g: np.asarray(getattr(tree, g).alive) for g in ("bodies", "shapes", "joints", "contacts")}


def test_warm_start_energy_event_matches_jax():
    jscene, pscene, batch, jstate = _mid_run(("Contact", "Warm Start Energy"), 5)
    assert pscene.on_step(batch, 60) is None and jscene.on_step(jstate, 60) is None
    with jax.disable_jit():
        want = _alive(jscene.on_step(jstate, 120))
    got = _alive(pscene.on_step(batch, 120))
    top = pscene.meta["top"]
    assert not got["bodies"][0, top] and _alive(batch)["contacts"][0].sum() > got["contacts"][0].sum()
    for g in got:
        np.testing.assert_array_equal(got[g][0], want[g], err_msg=g)


@pytest.mark.parametrize("bone", ["torso", "lower_left_leg"])
def test_destroy_body_matches_jax(bone):
    """A human's bone with joints, several shapes and live contacts."""
    jscene, pscene, batch, jstate = _mid_run(("Joints", "Ragdoll"), 4)
    body = pscene.meta["human"][bone]
    got = runtime.destroy_body(replicate(batch.map(lambda x: x[0]), 2), body)
    with jax.disable_jit():
        want = jruntime.destroy_body(jstate, body)
    assert_tree_close(to_numpy(got.map(lambda x: x[1])), np_tree(want), EXACT)
    assert int(got.joints.alive[1].sum()) < int(batch.joints.alive[0].sum())


# ---------------------------------------------------------------- testbed


def test_testbed_stats_line_matches_jax(capsys):
    """The stats line of `run_scene` on the CPU: every figure but the time
    equals the JAX testbed's line for the same state (its `statistics`)."""
    runs = run_scene("Contact", "Single Box", [SolverType.TGS_SOFT], steps=60, iterations=2, extra_iterations=1,
                     device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    state = runs[SolverType.TGS_SOFT]["state"]
    jstate, _ = JSCENES[("Contact", "Single Box")](JSolver.TGS_SOFT).freeze()
    with jax.disable_jit():
        st = jax_statistics(to_jax(jstate, to_numpy(state.map(lambda x: x[0]))))
    cap = max(st.utilization.values())
    want = (f"{st.body_count:7d} {st.contact_count:8d} {st.max_penetration:9.4f} {st.kinetic_energy:12.3f}"
            f" {st.color_overflow:8d} {cap:7.0%}").split()
    assert out[0].startswith("=== Contact/Single Box after 60 steps") and "on cpu" in out[0]
    fields = out[-1].split()
    assert fields[0] == "TGS_SOFT" and float(fields[1]) > 0
    assert fields[2:] == want
    assert st.contact_count > 0


def test_unported_solver_is_refused():
    """Every solver is ported: "all" is the ten solvers of the per-world
    step; TGS_Sticky freezes with friction anchors of the contact table's
    width; only the lane step still refuses TGS_Sticky (and XPBD), as in
    the JAX package."""
    S = SolverType
    assert parse_solvers("all") == list(S) and parse_solvers("TGS_SOFT,TGS_STICKY") == [S.TGS_SOFT, S.TGS_STICKY]
    state, cfg = SCENES[("Contact", "Single Box")](S.TGS_STICKY).freeze(device="cpu")
    C = cfg.max_contacts
    assert state.contacts.friction_anchor_a.shape == (C, 2, 2) and state.contacts.friction_persisted.shape == (C,)
    assert cfg.use_fused_solver is False
    with pytest.raises(AssertionError, match="lane step runs"):
        SCENES[("Contact", "Single Box")](S.TGS_STICKY).freeze(device="cpu", lane_solve=True, contact_bucket_cap=-1)


def test_joint_grid_above_the_body_cap_is_refused():
    """The published 100 x 100 Joint Grid freezes onto the XLA solvers (its
    10,000 bodies are above K1's cap); asking for K1 explicitly raises."""
    scene = SCENES[("Joints", "Joint Grid")](SolverType.TGS_SOFT)
    assert len(scene.world.bodies) == 10000
    state, cfg = scene.freeze(device="cpu")
    assert cfg.use_fused_solver is False and int(state.joints.alive.sum()) == 19800
    with pytest.raises(ValueError, match="use_fused_solver=True"):
        scene.freeze(device="cpu", use_fused_solver=True)
