"""Interactive testbed: the reference's live loop on matplotlib.

An own copy of the JAX package's `interactive.py`. It reproduces
samples/main.cpp's interactive controls (reference: samples/main.cpp:
151-289, :405-502) on a matplotlib window, driving the same multi-solver
lockstep worlds as the headless CLI (testbed.run_scene), each a batch of
one world stepped by the per-world step (`step.make_step`: K2, then K1 for
the soft solvers where a world fits it, else the XLA solvers) on
`device`, the card unless the caller asks for the CPU:

  P          pause / resume            (main.cpp:262-266)
  O          single step               (main.cpp:268-272)
  R          restart current sample    (main.cpp:256-260)
  [ / ]      previous / next sample    (main.cpp:230-254)
  , / .      previous / next solver    (main.cpp:204-228)
  mouse drag pick a dynamic body and drag it with a mouse joint in EVERY
             solver world (reference: samples/sample.cpp:69-123), through
             `queries.pick_body` and `attach_mouse_joint`

The class does not depend on a display: under an interactive backend
`run()` opens a window and animates; under Agg (headless) the same event
handlers can be called from code and frames written to PNG or GIF, which
is how `--interactive-gif` records a demo. matplotlib is imported when a
testbed is made, and PIL when a GIF is recorded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimConfig, SolverType
from .models import build, scene_names
from .parallel.batch import replicate
from .queries import attach_mouse_joint, detach_mouse_joint, move_mouse_target, pick_body
from .step import make_step
from .utils.draw import SOLVER_COLORS, DrawOptions, draw_world
from .utils.metrics import statistics


@dataclasses.dataclass
class _Run:
    scene: object
    state: object
    cfg: SimConfig
    stepf: object
    mouse_slot: int = -1  # joint slot holding the live mouse joint, -1 = none


class InteractiveTestbed:
    """Live multi-solver testbed (reference: samples/main.cpp main loop)."""

    def __init__(self, solvers, scene=None, hertz=60.0, iterations=4,
                 extra_iterations=2, warm_start=True, figsize=(10, 8), device="cuda"):
        import matplotlib.pyplot as plt

        self.catalog = scene_names()  # sorted (category, name), sample.h:72-85
        self.sample_idx = 0
        if scene is not None:
            cat, name = scene.split("/", 1)
            self.sample_idx = self.catalog.index((cat, name))
        self.solvers = list(solvers)
        self.solver_cursor = 0  # which enabled solver , / . cycles
        self.hertz = hertz
        self.dt = 1.0 / hertz if hertz > 0 else 0.0
        self.iterations = iterations
        self.extra_iterations = extra_iterations
        self.warm_start = warm_start
        self.device = torch.device(device)

        self.paused = False
        self.single_step = False
        self.step_count = 0
        self.dragging = False
        self.runs: dict[SolverType, _Run] = {}

        self.fig, self.ax = plt.subplots(figsize=figsize)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("button_press_event", self.on_mouse_down)
        self.fig.canvas.mpl_connect("motion_notify_event", self.on_mouse_move)
        self.fig.canvas.mpl_connect("button_release_event", self.on_mouse_up)
        self.restart()

    # ------------------------------------------------------------- lifecycle

    @property
    def sample(self):
        return self.catalog[self.sample_idx]

    def restart(self):
        """Rebuild every solver world for the current sample
        (reference: main.cpp:67-88 RestartTest keeps settings/camera)."""
        cat, name = self.sample
        self.runs = {}
        for solver in self.solvers:
            scene = build(cat, name, solver)
            state, cfg = scene.freeze(
                device=self.device,
                iterations=self.iterations,
                extra_iterations=self.extra_iterations,
                warm_start=self.warm_start,
            )
            self.runs[solver] = _Run(scene, replicate(state, 1), cfg, make_step(cfg))
        self.step_count = 0
        self.dragging = False

    def _change_sample(self, delta):
        self.sample_idx = (self.sample_idx + delta) % len(self.catalog)
        self.restart()

    def _change_iterations(self, delta):
        """Live primary-iteration adjust (reference: main.cpp:218-224, keys
        9/0 step s_settings.primaryIterations with a floor of 1). Iteration
        count is configuration only (the state's shape is unchanged), so each
        run keeps its state and takes a step of the new configuration."""
        self.iterations = max(1, self.iterations + delta)
        for run in self.runs.values():
            run.cfg = run.cfg.replace(iterations=self.iterations)
            run.stepf = make_step(run.cfg)

    def _change_solver(self, delta):
        """Cycle the solver under the cursor through the enum
        (reference: main.cpp:204-228 changes the sample's solver set)."""
        cur = self.solvers[self.solver_cursor]
        all_types = list(SolverType)
        nxt = all_types[(all_types.index(cur) + delta) % len(all_types)]
        self.solvers[self.solver_cursor] = nxt
        self.restart()

    # ---------------------------------------------------------------- events

    def on_key(self, event):
        k = (event.key or "").lower()
        if k == "p":
            self.paused = not self.paused
        elif k == "o":
            self.single_step = True
            self.paused = True
        elif k == "r":
            self.restart()
        elif k == "[":
            self._change_sample(-1)
        elif k == "]":
            self._change_sample(+1)
        elif k == ",":
            self._change_solver(-1)
        elif k == ".":
            self._change_solver(+1)
        elif k == "9":
            self._change_iterations(-1)
        elif k == "0":
            self._change_iterations(+1)
        elif k == "q":
            import matplotlib.pyplot as plt

            plt.close(self.fig)

    def _world_point(self, event):
        if event.xdata is None or event.ydata is None:
            return None
        return np.array([event.xdata, event.ydata], np.float32)

    def on_mouse_down(self, event):
        p = self._world_point(event)
        if p is None or self.dragging:
            return
        # pick + attach in every solver world (each reference Sample owns its
        # own mouse joint, sample.cpp:69-103; hertz=0.5*frequency, zeta=0.7)
        for run in self.runs.values():
            found, body = pick_body(run.state, p)
            if not bool(found):
                continue
            alive = run.state.joints.alive[0].cpu().numpy()
            free = np.flatnonzero(~alive)
            if free.size == 0:
                continue
            slot = int(free[0])
            run.state = attach_mouse_joint(
                run.state, slot, int(body), p, hertz=0.5 * self.hertz, damping_ratio=0.7
            )
            run.mouse_slot = slot
        self.dragging = any(r.mouse_slot >= 0 for r in self.runs.values())

    def on_mouse_move(self, event):
        if not self.dragging:
            return
        p = self._world_point(event)
        if p is None:
            return
        for run in self.runs.values():
            if run.mouse_slot >= 0:
                run.state = move_mouse_target(run.state, run.mouse_slot, p)

    def on_mouse_up(self, event):
        for run in self.runs.values():
            if run.mouse_slot >= 0:
                run.state = detach_mouse_joint(run.state, run.mouse_slot)
                run.mouse_slot = -1
        self.dragging = False

    # ----------------------------------------------------------------- frame

    def frame(self, draw=True):
        """One UI frame: step all worlds unless paused, then redraw
        (reference: main.cpp:718-886)."""
        if not self.paused or self.single_step:
            for run in self.runs.values():
                state = run.state
                if run.scene.pre_step is not None:
                    state = run.scene.pre_step(state)
                if run.scene.on_step is not None:
                    new = run.scene.on_step(state, self.step_count)
                    if new is not None:
                        state = new
                run.state = run.stepf(state, self.dt)
            self.step_count += 1
            self.single_step = False
        if draw:
            self.draw()

    def draw(self):
        cat, name = self.sample
        ax = self.ax
        ax.clear()
        lines = []
        for i, (solver, run) in enumerate(self.runs.items()):
            color = SOLVER_COLORS[list(SolverType).index(solver) % len(SOLVER_COLORS)]
            draw_world(ax, run.state, color=color, alpha=0.85, options=DrawOptions())
            st = statistics(run.state)
            cursor = ">" if i == self.solver_cursor else " "
            lines.append(
                f"{cursor}{solver.name:15s} bodies {st.body_count:5d} contacts {st.contact_count:5d}"
            )
        status = "PAUSED" if self.paused else "RUNNING"
        ax.set_title(f"{cat}/{name}  step {self.step_count}  [{status}]  "
                     f"(P pause, O step, R restart, [/] sample, ,/. solver)")
        ax.text(0.02, 0.98, "\n".join(lines), transform=ax.transAxes, va="top",
                family="monospace", fontsize=8,
                bbox=dict(facecolor="white", alpha=0.7, edgecolor="none"))
        ax.set_aspect("equal")
        ax.autoscale()

    def run(self, max_frames=None):
        """Animate under an interactive backend (60 Hz pacing like the
        reference's frame limiter, main.cpp:867-878)."""
        import matplotlib.pyplot as plt

        plt.show(block=False)
        n = 0
        while plt.fignum_exists(self.fig.number):
            self.frame()
            self.fig.canvas.draw_idle()
            plt.pause(max(1.0 / self.hertz, 0.001))
            n += 1
            if max_frames is not None and n >= max_frames:
                break

    def record_gif(self, path, frames=30, every=2):
        """Headless demo recording: advance `frames` UI frames, snapshot every
        `every`-th to an animated GIF (the Agg-backend analog of watching the
        window)."""
        import os

        from PIL import Image

        tmp = []
        for i in range(frames):
            self.frame()
            if (i + 1) % every == 0:
                fp = f"{path}.{i:05d}.png"
                self.fig.savefig(fp, dpi=70)
                tmp.append(fp)
        imgs = [Image.open(f) for f in tmp]
        imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=66, loop=0)
        for im in imgs:
            im.close()
        for f in tmp:
            os.remove(f)
        return path
