"""Worlds split over devices and processes (solver2d_tpu_torch.parallel.
sharding and .distributed), `step.make_step` and `step.run`, on the CPU.

- The split step on meshes of 1, 2 and 4 CPU entries, on the lane path
  (TGS_Soft) and on the per-world path's two routes (the fused route's
  TGS_Soft through K1's twin, the XLA route's PGS_NGS_Block): 3 steps equal
  the port's unsharded step bit for bit, and the last shard equals the JAX
  package's per-shard reference, which is what its `shard_map` and its
  vmapped step run on a shard: the lane `step_batch` on that shard's worlds
  (JAX's default eager mode under `cheap_compiles`, as
  tests/test_torch_step.py runs it), and the per-world `step` on its last
  world op by op (`jax.disable_jit()`), at the tolerances of those tests.
  The lane batch's worlds differ by velocities of order 1e-3, small enough
  that each shard's world 0 has global world 0's pairs and colors (the
  lane step shares them; the JAX package's shards do the same).
- A plain `State` comes back sharded; a world count that does not split
  evenly is refused; `metrics_psum_example` equals the JAX package's over
  a mesh of its virtual CPU devices (tests/conftest.py) within float32
  rel 1e-6 (the shards' partial sums are added in another order).
- Two processes, joined over gloo through a `file://` store: each makes its
  half of a `global_batch`, steps it and all-reduces the kinetic energy,
  each bit for bit what one process computes.
- `step.run` equals that many calls of the step; `make_step` is memoised.

The JAX references are never jitted (ROADMAP section 1)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import lane_dryrun_state_cfg
from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.parallel import make_mesh as jax_make_mesh
from solver2d_tpu.parallel import replicate_state as jax_replicate
from solver2d_tpu.parallel import shard_state as jax_shard_state
from solver2d_tpu.parallel.sharding import metrics_psum_example as jax_metrics_psum
from solver2d_tpu.step import step as jax_step
from solver2d_tpu.step import step_batch as jax_step_batch
from solver2d_tpu_torch import (
    SolverType, State, batched_step, make_mesh, make_step, pyramid_world, replicate, shard_state, sharded_step,
    state_from_numpy, step_batch, to_numpy,
)
from solver2d_tpu_torch.parallel import ShardedState, apply_velocity_deltas, metrics_psum_example
from solver2d_tpu_torch.step import run
from torch_parity import (
    DT, F32, WORLD_TOL, assert_tree_close, cheap_compiles, jax_world_scene, jax_worlds, np_tree, port_config, stack,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4
STEPS = 3


def _leaves(state):
    out = []
    state.map(lambda x: out.append(x) or x)
    return out


def _assert_bit_equal(a: State, b: State):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _lane_scene():
    """(JAX state and config, the port's) of the lane dryrun scene under
    TGS_Soft, and the port's W-world batch, world i's velocities moved by
    about i * 1e-3 (seeded numpy)."""
    jstate, jcfg = lane_dryrun_state_cfg()
    jcfg = jcfg.replace(solver=JSolver.TGS_SOFT, iterations=2)
    pstate, pcfg = pyramid_world(SolverType.TGS_SOFT, 3)[0].freeze(
        device="cpu", iterations=jcfg.iterations, extra_iterations=jcfg.extra_iterations,
        gjk_iters=jcfg.gjk_iters, max_colors=jcfg.max_colors, contact_bucket_cap=jcfg.contact_bucket_cap,
    )
    rng = np.random.RandomState(0)
    scale = 1e-3 * np.arange(W, dtype=np.float32)
    dv = torch.from_numpy((rng.normal(size=(W,) + tuple(pstate.bodies.v.shape)) * scale[:, None, None]).astype(np.float32))
    batch = apply_velocity_deltas(replicate(pstate, W), dv, torch.zeros((W,) + tuple(pstate.bodies.w.shape)))
    return jstate, jcfg, batch, pcfg


def _world_scene(solver):
    """(JAX config, the port's config, W JAX worlds, the port's batch of
    them) of the base-3 pyramid, worlds with jittered velocities."""
    jstate, jcfg = jax_world_scene("pyramid")
    jcfg = jcfg.replace(solver=JSolver[solver])
    worlds = jax_worlds(jstate, W)
    pcfg = port_config(jcfg)
    if solver != "TGS_SOFT":
        pcfg = pcfg.replace(use_fused_solver=False)
    return jcfg, pcfg, worlds, state_from_numpy(stack(worlds), device="cpu")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_lane_split_step_matches_unsharded_and_jax(n):
    jstate, jcfg, batch, pcfg = _lane_scene()
    mesh = make_mesh(["cpu"] * n)
    stepf = sharded_step(pcfg, mesh)
    split, whole = batch, batch
    L = W // n
    ref = state_from_numpy(to_numpy(batch), device="cpu").map(lambda x: x[W - L:])
    jref = jax.tree.map(jnp.asarray, to_numpy(ref))
    jref = dataclasses.replace(jax_replicate(jstate, L), **{
        k: dataclasses.replace(getattr(jax_replicate(jstate, L), k), **v) for k, v in jref.items() if isinstance(v, dict)})
    with cheap_compiles():
        for _ in range(STEPS):
            split, whole = stepf(split, DT), step_batch(whole, DT, pcfg)
            jref = jax_step_batch(jref, DT, jcfg)
            assert isinstance(split, ShardedState) and len(split.shards) == n
            _assert_bit_equal(split.gather("cpu"), whole)
            assert_tree_close(to_numpy(split.shards[-1]), np_tree(jref), F32)
    assert int(whole.diag.contact_count[0]) > 0 and not bool(whole.diag.pair_overflow.any())
    assert not torch.equal(whole.bodies.v[0], whole.bodies.v[-1])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("solver", ["TGS_SOFT", "PGS_NGS_BLOCK"], ids=["fused", "xla"])
def test_world_split_step_matches_unsharded_and_jax(solver, n):
    jcfg, pcfg, worlds, batch = _world_scene(solver)
    assert pcfg.use_fused_solver in (None, False) and (pcfg.use_fused_solver is None) == (solver == "TGS_SOFT")
    stepf = sharded_step(pcfg, make_mesh(["cpu"] * n))
    step = batched_step(pcfg)
    split, whole, ref = batch, batch, worlds[-1]
    for _ in range(STEPS):
        split, whole = stepf(split, DT), step(whole, DT)
        with jax.disable_jit():
            ref = jax_step(ref, jnp.float32(DT), jcfg)
        _assert_bit_equal(split.gather(), whole)
        last = {g: {k: v[-1] for k, v in d.items()} for g, d in to_numpy(split.shards[-1]).items() if isinstance(d, dict)}
        assert_tree_close(last, np_tree(ref), WORLD_TOL["pyramid"])
    assert int(whole.diag.contact_count.min()) > 0 and int(whole.diag.color_overflow.max()) == 0


def test_plain_state_comes_back_sharded_and_uneven_counts_are_refused():
    _, pcfg, _, batch = _world_scene("TGS_SOFT")
    mesh = make_mesh(["cpu"] * 2)
    out = sharded_step(pcfg, mesh)(batch, DT)
    assert isinstance(out, ShardedState) and out.mesh is mesh and out.local_worlds == W
    assert [s.bodies.type.shape[0] for s in out.shards] == [2, 2] and out.global_worlds == W
    assert all(s.bodies.position.device.type == "cpu" for s in out.shards)
    # the shards are copies: stepping them leaves the batch as it was
    assert int(batch.diag.step_id.max()) == 0 and int(out.shards[1].diag.step_id.min()) == 1
    three = batch.map(lambda x: x[:3])
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_state(three, mesh)
    with pytest.raises(ValueError, match="do not split evenly"):
        sharded_step(pcfg, mesh)(three, DT)
    with pytest.raises(ValueError, match="another mesh"):
        sharded_step(pcfg, make_mesh(["cpu"] * 4))(out, DT)


@pytest.mark.parametrize("n", [2, 8])
def test_metrics_psum_matches_jax(n):
    jstate, _ = jax_world_scene("pyramid")
    worlds = jax_worlds(jstate, 8)
    jbatch = jax.tree.map(lambda *xs: jnp.stack(xs), *worlds)
    want = float(jax_metrics_psum(jax_shard_state(jbatch, jax_make_mesh(jax.devices()[:n])),
                                  jax_make_mesh(jax.devices()[:n])))
    batch = state_from_numpy(stack(worlds), device="cpu")
    mesh = make_mesh(["cpu"] * n)
    got = metrics_psum_example(shard_state(batch, mesh), mesh)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert want > 1.0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(float(metrics_psum_example(batch, mesh)), want, rtol=1e-6)


RANK_SCRIPT = textwrap.dedent(
    """
    import sys
    import torch
    torch.set_num_threads(1)
    from solver2d_tpu_torch import SolverType, pyramid_world, sharded_step
    from solver2d_tpu_torch.parallel import apply_velocity_deltas, metrics_psum_example
    from solver2d_tpu_torch.parallel.distributed import global_batch, initialize, make_mesh
    store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    initialize(store, 2, rank)
    mesh = make_mesh(["cpu"])
    assert mesh.group is not None
    state, cfg = pyramid_world(SolverType.TGS_SOFT, 3)[0].freeze(device="cpu", lane_solve=False, iterations=2)
    batch = global_batch(state, 2, mesh)
    assert (batch.offset, batch.global_worlds) == (2 * rank, 4)
    made = batch.gather()
    # world g's velocities moved by 0.2 * g (g its global index)
    g = torch.arange(batch.offset, batch.offset + 2, dtype=torch.float32)
    dyn = (made.bodies.type == 2).float()
    batch.shards = [apply_velocity_deltas(s, 0.2 * g[:, None, None] * dyn[..., None], 0.0 * dyn)
                    for s in batch.shards]
    stepf = sharded_step(cfg, mesh)
    for _ in range(3):
        batch = stepf(batch, 1.0 / 60.0)
    ke = metrics_psum_example(batch, mesh)
    torch.save(dict(made=made.bodies.position, position=batch.gather().bodies.position, ke=ke), out)
    torch.distributed.destroy_process_group()
    """
)


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Ranks 0 and 1 hold global worlds 0-1 and 2-3."""
    store = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, store, str(r), str(tmp_path / f"rank{r}.pt")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    state, cfg = pyramid_world(SolverType.TGS_SOFT, 3)[0].freeze(device="cpu", lane_solve=False, iterations=2)
    batch = replicate(state, 4)
    for r in range(2):
        assert torch.equal(got[r]["made"], batch.bodies.position[2 * r:2 * r + 2])
    dyn = (batch.bodies.type == 2).float()
    batch = apply_velocity_deltas(batch, 0.2 * torch.arange(4.0)[:, None, None] * dyn[..., None], 0.0 * dyn)
    step = batched_step(cfg)
    for _ in range(3):
        batch = step(batch, 1.0 / 60.0)
    for r in range(2):
        assert torch.equal(got[r]["position"], batch.bodies.position[2 * r:2 * r + 2])
    v = batch.bodies.v
    want = 0.5 * torch.sum(v[:2] ** 2) + 0.5 * torch.sum(v[2:] ** 2)
    assert torch.equal(got[0]["ke"], want) and torch.equal(got[1]["ke"], want)


@pytest.mark.parametrize("lane", [True, False], ids=["lane", "per-world"])
def test_run_equals_repeated_steps(lane):
    state, cfg = pyramid_world(SolverType.TGS_SOFT, 3)[0].freeze(
        device="cpu", lane_solve=lane, iterations=2, **(dict(contact_bucket_cap=-1) if lane else {}))
    batch = replicate(state, 2)
    f = make_step(cfg)
    assert f is make_step(cfg) and f is not make_step(cfg.replace(iterations=3))
    want = batch
    for _ in range(4):
        want = (step_batch(want, DT, cfg) if lane else batched_step(cfg)(want, DT))
    _assert_bit_equal(run(batch, cfg, 4, DT), want)
    assert int(want.diag.step_id[0]) == 4
