"""The port runs where JAX is absent: the machine with the card has no JAX,
and an import of it (or of the JAX package, which imports it) from the port
or from chip_smoke.py would end the run there."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None           # any import of jax now raises
    sys.modules["solver2d_tpu"] = None  # as does any import of the JAX package
    import torch
    torch.set_num_threads(1)
    import chip_smoke
    import solver2d_tpu_torch
    from solver2d_tpu_torch import SolverType, batched_step, bridge, pyramid_world, replicate, step_batch
    from solver2d_tpu_torch.utils.metrics import joint_error
    state, cfg = pyramid_world(SolverType.TGS_SOFT, 3)[0].freeze(device="cpu", contact_bucket_cap=-1)
    out = step_batch(replicate(state, 2), 1.0 / 60.0, cfg)
    assert int(out.diag.step_id[0]) == 1 and bool(torch.isfinite(out.bodies.position).all())
    # the per-world step: contacts, soft revolute joints and a mouse joint
    w, planks = bridge(SolverType.TGS_SOFT, 4)
    w.create_mouse_joint(0, planks[1], (w.bodies[planks[1]].def_.position[0], 21.0), 5.0, 0.7)
    for solver in (SolverType.TGS_STICKY, SolverType.XPBD):
        state, cfg = w.freeze(device="cpu", lane_solve=False, solver=solver, iterations=1, extra_iterations=1)
        out = batched_step(cfg)(replicate(state, 2), 1.0 / 60.0)
        assert float(joint_error(out).max()) < 0.1
    state, cfg = w.freeze(device="cpu", lane_solve=False, iterations=1, extra_iterations=1)
    out = batched_step(cfg)(replicate(state, 2), 1.0 / 60.0)
    assert int(out.diag.step_id[0]) == 1 and bool(torch.isfinite(out.bodies.position).all())
    assert float(joint_error(out).max()) < 0.1
    state, cfg = pyramid_world(SolverType.TGS_SOFT, 3)[0].freeze(device="cpu", lane_solve=False, iterations=1)
    out = batched_step(cfg)(replicate(state, 2), 1.0 / 60.0)
    assert int(out.diag.contact_count[0]) > 0
    # the catalog, its hooks and helpers, and the headless testbed
    import solver2d_tpu_torch.models.far_scenes, solver2d_tpu_torch.models.human  # noqa: E401,F401
    from solver2d_tpu_torch import testbed
    from solver2d_tpu_torch.ops.hull import compute_hull
    from solver2d_tpu_torch.utils import metrics, runtime
    assert len(solver2d_tpu_torch.scene_names()) == 26 and testbed.main(["--list"]) == 0
    assert compute_hull([(0, 0), (1, 0), (0, 1)]) is not None
    runs = testbed.run_scene("Contact", "Warm Start Energy", [SolverType.TGS_SOFT], steps=2, iterations=1,
                             extra_iterations=0, device="cpu")
    scene, out = runs[SolverType.TGS_SOFT]["scene"], runs[SolverType.TGS_SOFT]["state"]
    out = runtime.destroy_body(scene.on_step(out, 120), 1)
    assert metrics.statistics(out).body_count == 2
    # the XLA route: all ten solvers, dense and bucketed, and a joint-bucketed Bridge
    from solver2d_tpu_torch.config import XLA_SOLVERS
    w3, _ = pyramid_world(SolverType.PGS_NGS_BLOCK, 3)
    for solver in sorted(XLA_SOLVERS):
        for cap in (0, -1):
            state, cfg = w3.freeze(device="cpu", lane_solve=False, solver=solver, use_fused_solver=False,
                                   iterations=1, extra_iterations=1, contact_bucket_cap=cap)
            out = batched_step(cfg)(replicate(state, 2), 1.0 / 60.0)
            assert int(out.diag.contact_count[0]) > 0 and bool(torch.isfinite(out.bodies.position).all())
    # the sweep and prune and the per-step MIS coloring
    for kw in (dict(broadphase="sap"), dict(incremental_coloring=False)):
        state, cfg = w3.freeze(device="cpu", lane_solve=False, iterations=1, extra_iterations=1, **kw)
        out = batched_step(cfg)(replicate(state, 2), 1.0 / 60.0)
        assert int(out.diag.contact_count[0]) > 0 and bool(torch.isfinite(out.bodies.position).all())
    w, planks = bridge(SolverType.TGS_NGS, 4)
    state, cfg = w.freeze(device="cpu", lane_solve=False, joint_bucket_cap=-1, iterations=1)
    assert cfg.use_fused_solver is False and cfg.joint_bucket_cap > 0
    out = batched_step(cfg)(replicate(state, 2), 1.0 / 60.0)
    assert float(joint_error(out).max()) < 0.1
    assert testbed.parse_solvers("all") == sorted(XLA_SOLVERS)
    # the queries, raycasts and GJK, the runtime and utility modules, the
    # debug draw and the interactive testbed (imported without matplotlib)
    import os, tempfile  # noqa: E401
    import solver2d_tpu_torch.interactive, solver2d_tpu_torch.utils.draw  # noqa: E401,F401
    from solver2d_tpu_torch import queries
    from solver2d_tpu_torch.ops import distance, raycast  # noqa: F401
    from solver2d_tpu_torch.utils import checkpoint, checks, handles, profiling, settings  # noqa: F401
    from solver2d_tpu_torch.parallel import randomize_velocities, replicate_state  # noqa: F401
    assert "matplotlib" not in sys.modules and "PIL" not in sys.modules
    w3, ids = pyramid_world(SolverType.TGS_SOFT, 3)
    state, cfg = w3.freeze(device="cpu", lane_solve=False, iterations=1)
    batch = batched_step(cfg)(replicate(state, 2), 1.0 / 60.0)
    hit = queries.raycast_world(batch, (-5.0, 0.5), (5.0, 0.5), max_candidates=4)
    assert bool(hit.hit) and int(hit.shape) >= 0
    center = batch.bodies.position[1, ids[-1]]
    found, body = queries.pick_body(batch, center, world=1)
    assert bool(found) and int(body) == ids[-1]
    batch = queries.attach_mouse_joint(batch, 0, int(body), center + 0.5)
    batch = runtime.set_linear_velocity(batch, ids[0], (0.5, 0.0))
    batch = batched_step(cfg)(batch, 1.0 / 60.0)
    assert bool(checks.world_health(batch).all()) and checks.validate_state(batch, cfg) == []
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_npz(os.path.join(tmp, "s.npz"), batch)
        back = checkpoint.load_npz(os.path.join(tmp, "s.npz"), device="cpu")
    assert torch.equal(back.bodies.position, batch.bodies.position) and bool(back.joints.alive[:, 0].all())
    # the split step, the per-pair manifold and the scene compiler
    import solver2d_tpu_torch.parallel.distributed, solver2d_tpu_torch.parallel.sharding  # noqa: E401,F401
    from solver2d_tpu_torch import make_mesh, native, sharded_step
    from solver2d_tpu_torch.ops import manifold
    assert native.available() and native.compile_scene.__module__ == "solver2d_tpu_torch.native"
    assert manifold.collide.__module__ == "solver2d_tpu_torch.ops.manifold"
    state, cfg = w3.freeze(device="cpu", lane_solve=False, iterations=1)
    out = sharded_step(cfg, make_mesh(["cpu"] * 2))(replicate(state, 4), 1.0 / 60.0)
    assert len(out.shards) == 2 and int(out.gather().diag.contact_count.min()) > 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "solver2d_tpu"))
    assert not [m for m in loaded if sys.modules[m] is not None], loaded
    print("isolated ok")
    """
)


def test_port_and_chip_smoke_run_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "isolated ok" in proc.stdout


def test_no_jax_import_in_port_sources():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|solver2d_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "solver2d_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = [f for f in files if pat.search(open(f).read())]
    assert not hits, hits
