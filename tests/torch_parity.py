"""Helpers of the port's parity tests (tests/test_torch_*.py): carry JAX
values to the port as numpy arrays and compare trees of outputs.

JAX runs op by op (`jax.disable_jit()`) in most of these tests: tracing and
compiling the unrolled step programs costs minutes on the CPU, while the
eager ops of a base-3 scene take seconds (tests/test_torch_step.py says
why the lane step runs in JAX's default eager mode). Each op of a new shape still
compiles once per process (about 30 ms, a thousand of them in a lane step).
`port_compile_cache` keeps every such compile, however short, in a
persistent cache of the port's tests' own, so that their test processes
share them; the root conftest.py enters it around each port test.
"""

import contextlib
import os
import tempfile

import numpy as np
import jax

# under the temporary directory of the process, apart from the cache that
# tests/conftest.py gives the JAX package's own tests
PORT_CACHE_DIR = os.path.join(tempfile.gettempdir(), "solver2d_tpu_torch_jaxcache")


@contextlib.contextmanager
def port_compile_cache():
    """Point JAX's persistent compilation cache at PORT_CACHE_DIR and keep
    every compile in it; on exit restore the settings as they were."""
    from jax._src import compilation_cache

    settings = {
        "jax_compilation_cache_dir": PORT_CACHE_DIR,
        "jax_persistent_cache_min_compile_time_secs": 0.0,
    }
    before = {k: jax.config.values[k] for k in settings}
    for k, v in settings.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


@contextlib.contextmanager
def cheap_compiles():
    """Compile JAX's ops without XLA's expensive optimizations (LLVM at -O0):
    about a third less time a compile, the same arithmetic. On exit drop
    every executable the process holds, so that no later test runs one
    compiled so."""
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
        jax.clear_caches()


# float32 round-off: both sides compute the same operations in the same
# order, so values agree to a few ulps
F32 = dict(rtol=1e-5, atol=1e-5)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def _get(obj, k):
    return obj[k] if isinstance(obj, dict) else getattr(obj, k)


def assert_tree_close(port: dict, ref, tol=F32, path=""):
    """Every leaf of the port's numpy tree (`to_numpy`) against the same
    field of the JAX tree: integers and bools exactly, floats within tol."""
    for k, v in port.items():
        r = _get(ref, k)
        if isinstance(v, dict):
            assert_tree_close(v, r, tol, f"{path}{k}.")
            continue
        r = np.asarray(r)
        name = f"{path}{k}"
        assert v.shape == r.shape, (name, v.shape, r.shape)
        assert v.dtype == r.dtype, (name, v.dtype, r.dtype)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, r, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(v, r, err_msg=name)


def to_jax(template, port: dict):
    """The JAX dataclass `template` with every field the port keeps replaced
    by the port's numpy values (nested)."""
    import dataclasses

    import jax.numpy as jnp

    kw = {}
    for k, v in port.items():
        t = getattr(template, k)
        kw[k] = to_jax(t, v) if isinstance(v, dict) else jnp.asarray(v)
    return dataclasses.replace(template, **kw)


# ------------------------------------------------------ the per-world step
#
# The per-world path's parity tests run the JAX package's per-world `step`
# with its XLA solver (`use_pallas_solver=False`, no buckets): the fused TPU
# kernel reuses the same per-constraint code (pallas_solver.py:1-30), and
# its interpret mode runs for minutes here. The scenes are small and the
# substeps few, so that JAX's op-by-op step takes seconds.

# the per-world tests' configuration: 2 substeps + 1 relax pass
WORLD_KW = dict(iterations=2, extra_iterations=1, gjk_iters=10)
DT = 1.0 / 60.0
# Float tolerances of the per-world tests, from what holds on the CPU (far
# inside tests/test_pallas_solver.py:81-88's 2e-4 position, 1e-3 velocity,
# 2e-3 impulse): on the base-3 pyramid the port's solve and step equal the
# JAX package's bit for bit; on the 4-plank Bridge with a mouse joint they
# differ by at most 1.5e-7 (joint impulses; velocities 7.5e-8, rotations
# 7.5e-9) over 3 steps.
WORLD_TOL = {"pyramid": dict(rtol=0, atol=0), "bridge": dict(rtol=0, atol=1e-6)}
WORLD_TOL["bridge_dyn_a"] = WORLD_TOL["bridge"]


def jax_world_scene(name: str, solver: str = "TGS_SOFT"):
    """(state, config) of the JAX package, frozen under `solver` (which
    sizes TGS_Sticky's friction anchors): the base-3 pyramid; the 4-plank
    Bridge with a mouse joint dragging plank 2 from the ground ("bridge");
    or the same Bridge with a mouse joint whose body A is plank 1, a
    dynamic body, dragging plank 3 ("bridge_dyn_a")."""
    from solver2d_tpu.config import SolverType
    from solver2d_tpu.models.contact_scenes import pyramid_world
    from solver2d_tpu.models.joint_scenes import bridge

    solver = SolverType[solver]
    if name == "pyramid":
        w, _ = pyramid_world(solver, 3)
        # the scene has no joints: the XLA solver skips the (inert) joint
        # phases that the fused solve runs
        kw = dict(solve_joints=False)
    else:
        w = bridge(solver, 4).world
        a, b = (0, 2) if name == "bridge" else (1, 3)
        p = w.body_position(b)
        w.create_mouse_joint(a, b, (p[0] + 0.3, p[1] + 1.0), 5.0, 0.7)
        # no contacts; a joint has at most 3 neighbours: 4 colors do
        kw = dict(max_colors=4, joint_max_colors=4)
    return w.freeze(solver=solver, narrowphase="lanes", **WORLD_KW, **kw)


def port_config(jcfg):
    """The port's per-world configuration with the JAX config's values."""
    import solver2d_tpu_torch as port

    fields = {k: getattr(jcfg, k) for k in port.SimConfig.__dataclass_fields__ if hasattr(jcfg, k)}
    return port.SimConfig(**fields).replace(lane_solve=False)


def jax_worlds(state, n: int, seed: int = 0):
    """n copies of a JAX state, world i with its dynamic bodies' velocities
    jittered by i * N(0, 0.3) (numpy, seeded): worlds that differ."""
    import dataclasses

    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        dv = (i * rng.normal(scale=0.3, size=state.bodies.v.shape)).astype(np.float32)
        dyn = np.asarray(state.bodies.type) == 2
        v = np.asarray(state.bodies.v) + np.where(dyn[:, None], dv, 0.0).astype(np.float32)
        out.append(dataclasses.replace(state, bodies=dataclasses.replace(state.bodies, v=jnp.asarray(v))))
    return out


def stack(trees):
    """Stack JAX trees of one world each into numpy arrays [W, ...]."""
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


def jax_colors(state, contacts, cfg):
    """The per-world coloring of the JAX `step` (dense branch, incremental):
    (contacts, joints, (ccolor, cmap, jcolor, jmap))."""
    import dataclasses

    from solver2d_tpu.ops import coloring
    from solver2d_tpu.solvers.common import make_body_map

    b, j = state.bodies, state.joints
    dyn = (b.type == 2) & b.alive
    touching = contacts.alive & (contacts.point_count > 0)
    ccolor, _ = coloring.assign_colors(contacts.color, contacts.body_a, contacts.body_b, touching, dyn,
                                       cfg.max_bodies, cfg.max_colors, rounds=cfg.color_rounds)
    jcolor, _ = coloring.assign_colors(j.color, j.body_a, j.body_b, j.alive, dyn, cfg.max_bodies,
                                       cfg.joint_max_colors, rounds=cfg.color_rounds)
    cmap = make_body_map(contacts.body_a, contacts.body_b, ccolor, touching & (ccolor >= 0), dyn,
                         cfg.max_bodies, cfg.max_colors)
    jmap = make_body_map(j.body_a, j.body_b, jcolor, j.alive & (jcolor >= 0), dyn, cfg.max_bodies,
                         cfg.joint_max_colors, write_a_extra=j.type != 1)
    return (dataclasses.replace(contacts, color=ccolor), dataclasses.replace(j, color=jcolor),
            (ccolor, cmap, jcolor, jmap))
