"""The port's debug draw, interactive testbed and the testbed's render
flags, on the CPU with matplotlib's Agg backend, held to what the JAX
package's do: the same image from the same world, the same world states
after the same scripted frames and mouse events (bit for bit), the same
key bindings, and image and GIF files written by the flags."""

import functools
import os
import types

import jax
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from solver2d_tpu.config import SolverType as JSolver  # noqa: E402
from solver2d_tpu_torch import SolverType, to_numpy  # noqa: E402
from torch_parity import assert_tree_close, np_tree, to_jax  # noqa: E402

torch.set_num_threads(1)
EXACT = dict(rtol=0, atol=0)
KW = dict(iterations=2, extra_iterations=1)


def _key(k):
    return types.SimpleNamespace(key=k)


def _mouse(x, y):
    return types.SimpleNamespace(xdata=x, ydata=y, button=1)


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def test_draw_layers_match_jax(tmp_path):
    """Every debug-draw layer (shapes, joints, AABBs, mass, contact points
    with impulses and friction impulses) of a stepped Single Box with a
    mouse joint: the port's image equals the JAX package's of the same
    world, pixel for pixel."""
    from solver2d_tpu.utils.draw import DrawOptions as JOptions, render_states as jrender
    from solver2d_tpu_torch import queries
    from solver2d_tpu_torch.models import build
    from solver2d_tpu_torch.parallel.batch import batched_step, replicate
    from solver2d_tpu_torch.utils import runtime
    from solver2d_tpu_torch.utils.draw import DrawOptions, render_states
    from solver2d_tpu.models import build as jbuild

    scene = build("Contact", "Single Box", SolverType.TGS_SOFT)
    state, cfg = scene.freeze(device="cpu", **KW)
    box = scene.meta["box"]
    batch = runtime.teleport_bodies(replicate(state, 2), [box], [[0.0, 1.01]])  # just above the ground
    step = batched_step(cfg)
    for _ in range(3):
        batch = step(batch, 1 / 60)
    batch = queries.attach_mouse_joint(batch, 0, box, batch.bodies.position[:, box] + 0.5)
    batch = step(batch, 1 / 60)
    assert int(batch.contacts.alive[1].sum()) >= 1
    kw = dict(draw_aabbs=True, draw_mass=True, draw_contact_points=True, draw_contact_impulses=True,
              draw_friction_impulses=True)
    got = str(tmp_path / "port.png")
    render_states({"TGS_SOFT": batch}, path=got, options=DrawOptions(**kw), title="layers")
    jstate, _ = jbuild("Contact", "Single Box", JSolver.TGS_SOFT).freeze(**KW)
    world0 = {k: ({f: a[0] for f, a in v.items()} if isinstance(v, dict) else v[0])
              for k, v in to_numpy(batch).items()}
    want = str(tmp_path / "jax.png")
    jrender({"TGS_SOFT": to_jax(jstate, world0)}, path=want, options=JOptions(**kw), title="layers")
    assert os.path.getsize(got) > 5000
    np.testing.assert_array_equal(_pixels(got), _pixels(want))


def _script(tb, single):
    """The scripted session both testbeds run: pick the falling box at its
    center and drag it right and up; a single step; release. Returns the
    run's state after the step and after the release."""
    states = []
    run = tb.runs[single]
    box = run.scene.meta["box"]
    pos = run.state.bodies.position
    x, y = (float(v) for v in (pos[0, box] if pos.ndim == 3 else pos[box]))
    tb.on_mouse_down(_mouse(x, y))
    assert tb.dragging and run.mouse_slot >= 0
    tb.on_mouse_move(_mouse(x + 3.0, y + 0.5))
    tb.on_key(_key("o"))
    tb.frame(draw=False)
    states.append(run.state)
    tb.on_mouse_up(_mouse(x + 3.0, y + 0.5))
    assert not tb.dragging and run.mouse_slot == -1
    states.append(run.state)
    return states


# the session's scene settings, in both packages: JAX's op-by-op step
# sweeps every color and runs its per-pair narrowphase op by op; the box
# and its one contact and mouse joint need 2 colors and 1
SESSION_OVERRIDES = dict(narrowphase="lanes", max_colors=2, joint_max_colors=1)


def _with_overrides(build):
    def built(*args):
        scene = build(*args)
        scene.config_overrides = dict(scene.config_overrides, **SESSION_OVERRIDES)
        return scene

    return built


def test_interactive_session_matches_jax(monkeypatch):
    """The same frames, key presses and mouse events in the port's
    InteractiveTestbed (Single Box under TGS_Soft, 1 substep and a relax
    pass, K1's twin on the CPU) and the JAX package's (its step op by op),
    both with SESSION_OVERRIDES:
    equal world states after the step and after the release, the mouse
    joint attached, dragged and released alike."""
    import solver2d_tpu.interactive as jinteractive
    import solver2d_tpu_torch.interactive as tinteractive
    from solver2d_tpu.interactive import InteractiveTestbed as JTestbed
    from solver2d_tpu_torch.interactive import InteractiveTestbed

    for mod in (jinteractive, tinteractive):
        monkeypatch.setattr(mod, "build", _with_overrides(mod.build))

    kw = dict(KW, iterations=1)
    tb = InteractiveTestbed([SolverType.TGS_SOFT], scene="Contact/Single Box", device="cpu", **kw)
    got = _script(tb, SolverType.TGS_SOFT)
    with jax.disable_jit():
        jtb = JTestbed([JSolver.TGS_SOFT], scene="Contact/Single Box", **kw)
        want = _script(jtb, JSolver.TGS_SOFT)
    for g, w in zip(got, want):
        tree = {k: ({f: a[0] for f, a in v.items()} if isinstance(v, dict) else v[0]) for k, v in to_numpy(g).items()}
        assert_tree_close(tree, np_tree(w), EXACT)
    j = got[0].joints
    assert bool(j.alive[0].any()) and float(j.target[0, 0, 0]) > 0
    assert not bool(got[1].joints.alive.any())
    assert int(got[1].diag.color_overflow[0]) == 0


def test_interactive_keys_and_gif(tmp_path):
    """The key bindings as the JAX package's testbed has them (P pause, O
    single step, R restart, 9/0 iterations, [/] sample, ,/. solver) and a
    headless GIF recording."""
    from PIL import Image

    from solver2d_tpu_torch.interactive import InteractiveTestbed

    tb = InteractiveTestbed([SolverType.TGS_SOFT], scene="Contact/Single Box", device="cpu", **KW)
    tb.frame(draw=False)
    assert tb.step_count == 1
    tb.on_key(_key("p"))
    tb.frame(draw=False)
    assert tb.paused and tb.step_count == 1
    tb.on_key(_key("o"))
    tb.frame(draw=False)
    assert tb.step_count == 2 and tb.paused
    tb.frame(draw=True)
    assert tb.step_count == 2 and "PAUSED" in tb.ax.get_title()
    tb.on_key(_key("r"))
    assert tb.step_count == 0
    tb.on_key(_key("0"))
    assert tb.iterations == 3 and tb.runs[SolverType.TGS_SOFT].cfg.iterations == 3
    for _ in range(5):
        tb.on_key(_key("9"))
    assert tb.iterations == 1
    sample = tb.sample
    tb.on_key(_key("]"))
    assert tb.sample != sample
    tb.on_key(_key("["))
    assert tb.sample == sample
    tb.on_key(_key("."))
    assert tb.solvers == [SolverType.TGS_NGS]
    tb.on_key(_key(","))
    assert tb.solvers == [SolverType.TGS_SOFT]
    tb.on_key(_key("p"))
    path = str(tmp_path / "itb.gif")
    assert tb.record_gif(path, frames=4, every=2) == path
    with Image.open(path) as im:
        assert im.n_frames == 2
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".png")]


def test_testbed_render_flags(tmp_path, monkeypatch, capsys):
    """run_scene's render of the last frame and its frames stitched into a
    GIF; the CLI's --render, --render-every, --draw-* and --interactive-gif
    flags (routed to the CPU here: the CLI runs on the card)."""
    from solver2d_tpu_torch import interactive, testbed

    png = str(tmp_path / "last.png")
    runs = testbed.run_scene("Contact", "Single Box", [SolverType.TGS_SOFT, SolverType.PGS], steps=2, device="cpu",
                             render=png, verbose=False, **KW)
    assert os.path.getsize(png) > 5000 and len(runs) == 2
    gif = str(tmp_path / "frames.gif")
    testbed.run_scene("Contact", "Single Box", [SolverType.TGS_SOFT], steps=4, device="cpu", render=gif,
                      render_every=2, verbose=False, **KW)
    assert os.path.getsize(gif) > 0
    assert sorted(os.listdir(tmp_path)) == ["frames.gif", "last.png"]

    seen = {}

    def run_scene_cpu(*args, **kw):
        seen.update(kw)
        return testbed_run(*args, device="cpu", **kw)

    testbed_run = testbed.run_scene
    monkeypatch.setattr(testbed, "run_scene", run_scene_cpu)
    out = str(tmp_path / "cli.png")
    assert testbed.main(["Contact/Single Box", "--solvers", "TGS_SOFT", "--steps", "2", "--iters", "2",
                         "--extra-iters", "1", "--render", out, "--draw-aabbs", "--draw-contact-normals"]) == 0
    assert os.path.getsize(out) > 5000
    opts = seen["draw_options"]
    assert opts.draw_aabbs and opts.draw_contact_points and opts.draw_contact_normals and not opts.draw_mass

    monkeypatch.setattr(interactive, "InteractiveTestbed",
                        functools.partial(interactive.InteractiveTestbed, device="cpu"))
    gif2 = str(tmp_path / "cli.gif")
    assert testbed.main(["Contact/Single Box", "--solvers", "TGS_SOFT", "--steps", "4", "--iters", "2",
                         "--extra-iters", "1", "--interactive-gif", gif2]) == 0
    assert os.path.getsize(gif2) > 0 and "wrote " + gif2 in capsys.readouterr().out


@pytest.mark.parametrize("module", ["solver2d_tpu_torch.utils.draw", "solver2d_tpu_torch.interactive",
                                    "solver2d_tpu_torch.testbed"])
def test_render_modules_import_matplotlib_lazily(module):
    """Importing the drawing modules imports no matplotlib: the card's
    machine may not have it."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"import sys, {module}; assert 'matplotlib' not in sys.modules and 'PIL' not in sys.modules"
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_testbed_render_flags_need_matplotlib():
    """Where matplotlib is missing (the card's machine), the render and
    interactive flags stop before any step with a usage error."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "from solver2d_tpu_torch import testbed\n"
            "for flag in (['--render', 'x.png'], ['--interactive-gif', 'x.gif'], ['--interactive']):\n"
            "    try:\n"
            "        testbed.main(['Contact/Single Box', '--steps', '1'] + flag)\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 2, e.code\n"
            "    else:\n"
            "        raise AssertionError(flag)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "need matplotlib" in proc.stderr
