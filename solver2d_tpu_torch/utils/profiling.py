"""Step timing, traces and a per-stage breakdown.

An own copy of the JAX package's `utils/profiling.py`, the analog of the
reference's frame-time overlay and counters (reference:
samples/main.cpp:720-832, include/solver2d/timer.h): host-clock step
timing with the first call (kernel builds, first-use allocations) kept
apart, a per-stage breakdown of the port's step under the JAX package's
stage names, and `torch.profiler` traces in place of `jax.profiler`'s.
On the card each time is closed by a device synchronisation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import torch


def _devices(tree, out):
    """The devices of the tensors in a tree of states, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _devices(getattr(tree, f.name), out)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _devices(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _devices(x, out)
    return out


def block_until_ready(tree):
    """Wait for the card's work on every CUDA tensor of the tree."""
    for dev in _devices(tree, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree


@dataclasses.dataclass
class StepTimer:
    """Steps a second, with the first call (builds, first allocations) kept
    apart in `compile_s`."""

    compile_s: float = 0.0
    total_s: float = 0.0
    steps: int = 0

    def timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        dt = time.perf_counter() - t0
        if self.steps == 0:
            self.compile_s = dt
        else:
            self.total_s += dt
        self.steps += 1
        return out

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.total_s / max(self.steps - 1, 1)

    @property
    def steps_per_sec(self) -> float:
        return max(self.steps - 1, 1) / max(self.total_s, 1e-12)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a `torch.profiler` trace of the block (host, and the card's
    kernels where there is one) into `log_dir/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto). The default directory is under the
    process's temporary directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "s2torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def stage_times(state, config, dt=1.0 / 60.0, repeats: int = 10) -> dict:
    """ms of each stage of one step of the batch `state` under `config`,
    each stage timed alone, under the JAX package's names: "broadphase"
    (the pair finder), "narrowphase" (K2 and the id matching, after the
    persistent match), "coloring" (the per-step MIS coloring of the touching
    contacts) and "full_step" (the configured step). For diagnosis: the
    stages include their own launch and synchronisation costs."""
    from .. import step as step_mod
    from ..ops import broadphase, coloring

    shapes, bodies = state.shapes, state.bodies
    results = {}

    def bench(name, f):
        out = block_until_ready(f())
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = f()
        block_until_ready(out)
        results[name] = 1e3 * (time.perf_counter() - t0) / repeats
        return out

    jointed = broadphase.jointed_body_keys(state.joints, config)
    pairs = bench("broadphase", lambda: broadphase.find_pairs_by(shapes, bodies.type, jointed, config))
    contacts = broadphase.match_contacts(state.contacts, pairs, shapes)
    contacts = bench("narrowphase", lambda: step_mod.update_manifolds(state, contacts, config.gjk_iters))
    dyn = (bodies.type == 2) & bodies.alive
    touching = contacts.alive & (contacts.point_count > 0)
    bench("coloring", lambda: coloring.color_graph(contacts.body_a, contacts.body_b, touching, dyn,
                                                   config.max_bodies, config.max_colors))
    full = step_mod.step_batch if config.lane_solve else step_mod.step
    bench("full_step", lambda: full(state, dt, config))
    return results
