"""One run of a cell: set-up, the measured window, the traced phases, the
check against the reference, and the result's line.

The window is a closed loop. Each step is one call of the system's step on
the whole [W, ...] batch, then a copy of every world's body positions and
rotations to a pinned host buffer (the observation an RL trainer reads),
which ends in a device synchronisation: each step has a wall time of its
own on the host clock.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import os
import random
import statistics
import time

import torch

from . import check, subject, trace as tracing

# steps the traced phases hold: about this many seconds of steps
PROFILE_S = 1.5
SPAN_S = 1.5
# CPU threads of the reference, which runs once the window has closed
CHECK_THREADS = min(8, os.cpu_count() or 1)
# Every cell's traffic, alike in all cells (a cell gets a field of its own
# only where two cells need different values):
# - the velocity jitter's scale: each live dynamic body of each world gets
#   JITTER * N(0, 1) on its linear and angular velocity, from the seed, as
#   `parallel.randomize_velocities` draws it at its default scale, the
#   program's jitter for RL rollouts (the published scenes start at rest)
JITTER = 0.5
# - the steps before the window, through the timed call: the first
#   `steps_compared` of them are compared from the start, and every shape
#   the window uses is built and captured in them
WARMUP_STEPS = 8
# - the worlds that the check compares, drawn from the seed
SAMPLE_WORLDS = 16


@dataclasses.dataclass
class Context:
    """What the metric readers read (`metrics/<name>.py`)."""

    wl: dict
    cfg_doc: dict
    n_worlds: int
    setup_s: float
    window_s: float
    step_s: list
    profile: dict | None = None     # `trace.analyse` of the profiled window
    spans: dict | None = None       # (module, name) -> (seconds, calls) over span_steps
    span_steps: int = 0
    span_note: str = ""             # why the spans are not read, if they are not
    state_bytes: dict = dataclasses.field(default_factory=dict)  # "table.field" -> bytes of the batch's state
    captured: dict = dataclasses.field(default_factory=dict)  # (module, name) -> (args, kwargs) of the last call
    log: object = print

    def span_ms(self, names) -> float | None:
        """Mean ms a step in the wrapped functions `names` ((module, name)
        pairs), or None where a function is gone, never ran, or the spans'
        window did not end where an unwrapped step did."""
        if self.spans is None or self.span_note:
            return None
        got = [self.spans.get(tuple(n)) for n in names]
        if any(g is None for g in got) or sum(c for _, c in got) == 0:
            return None
        return sum(s for s, _ in got) / self.span_steps * 1e3

    def kernel_ms(self, pattern: str) -> float | None:
        """Mean device ms a launch of the kernels whose profiler name holds
        `pattern`, or None where none ran in the profiled window."""
        if not self.profile:
            return None
        hits = [(s, n) for name, (s, n) in self.profile["kernels"].items() if pattern in name]
        count = sum(n for _, n in hits)
        return sum(s for s, _ in hits) / count * 1e3 if count else None


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Observer:
    """Copies every world's body positions and rotations to a host buffer
    (pinned on the card), then waits for the device."""

    def __init__(self, batch, device):
        shape = tuple(batch.bodies.position.shape[:-1]) + (4,)
        self.device = torch.device(device)
        self.dev = torch.empty(shape, dtype=torch.float32, device=device)
        self.host = torch.empty(shape, dtype=torch.float32, pin_memory=self.device.type == "cuda")

    def __call__(self, batch):
        torch.cat([batch.bodies.position, batch.bodies.rot], dim=-1, out=self.dev)
        self.host.copy_(self.dev, non_blocking=True)
        sync(self.device)


def sample_worlds(seed: int, n_worlds: int, n: int) -> list[int]:
    return sorted(random.Random(seed).sample(range(n_worlds), min(n, n_worlds)))


def jitter(seed: int, n_worlds: int, n_bodies: int, scale: float, device):
    """The velocity jitter of a run: scale * N(0, 1) for every body's
    linear and angular velocity of every world, drawn on the device."""
    g = torch.Generator(device=device).manual_seed(seed % 2**64)
    dv = scale * torch.randn((n_worlds, n_bodies, 2), generator=g, device=device, dtype=torch.float32)
    dw = scale * torch.randn((n_worlds, n_bodies), generator=g, device=device, dtype=torch.float32)
    return dv, dw


def failed_worlds(batch) -> int:
    """Worlds with a non-finite body state, a colour overflow or a pair
    overflow."""
    b = batch.bodies
    finite = torch.ones_like(b.alive)
    for x in (b.position, b.rot, b.v):
        finite &= torch.isfinite(x).all(-1) | ~b.alive
    finite &= torch.isfinite(b.w) | ~b.alive
    bad = ~finite.all(-1) | (batch.diag.color_overflow > 0) | batch.diag.pair_overflow
    return int(bad.sum())


def state_bytes(state) -> dict:
    """Bytes of each tensor of a state, by "table.field"."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": n for k, n in state_bytes(v).items()})
        else:
            out[f.name] = v.numel() * v.element_size()
    return out


def _import_attr(module: str, name: str):
    mod = importlib.import_module(module)
    return mod, getattr(mod, name)


@dataclasses.dataclass
class Patch:
    """Wrappers installed on module attributes, removed on exit."""

    saved: list = dataclasses.field(default_factory=list)

    def install(self, module, name, wrapper):
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, wrapper)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)


def _states_equal(a, b) -> bool:
    return check._mismatch(a, b) == 0


def run(wl: dict, cfg_doc: dict, metrics: list[dict], readers: dict, seed: int, seconds: float, traced: bool,
        device, log, t0: float, subject_name: str = "program", fault=None, warmup_steps: int = WARMUP_STEPS) -> dict:
    """One run. `metrics`: the BENCHMARK.json entries this run reports;
    `readers`: their reader modules by name; `fault`: a function that takes
    the step and returns a broken one (the tests' planted faults);
    `warmup_steps`: fewer only where no window is timed (the control's
    readings). Returns the result (the last line's object, less its device
    name)."""
    unknown = set(wl["limits"]) - set(check.NUMBERS)
    if unknown:
        raise ValueError(f"limits of numbers the check does not make: {sorted(unknown)}")
    if not 0 < int(wl["steps_compared"]) <= warmup_steps:
        raise ValueError(f"a cell compares 1 to {warmup_steps} steps from the start")
    device = torch.device(device)
    marks = [("start", time.perf_counter())]
    sub = subject.SUBJECTS[subject_name](cfg_doc, wl, device)
    marks.append(("scene and freeze", time.perf_counter()))
    n_worlds = int(wl["worlds"])
    batch = sub.replicate(sub.world, n_worlds)
    n_bodies = batch.bodies.v.shape[1]
    dv, dw = jitter(seed, n_worlds, n_bodies, JITTER, device)
    batch = sub.apply_jitter(batch, dv, dw)
    idx = torch.tensor(sample_worlds(seed, n_worlds, SAMPLE_WORLDS))
    state0 = check.take(batch, idx)
    step = sub.step if fault is None else fault(sub.step)
    observe = Observer(batch, device)
    sync(device)
    marks.append(("replicate and jitter", time.perf_counter()))

    # warm-up through the timed call; its first steps are the ones compared
    start = []
    for i in range(warmup_steps):
        batch = step(batch)
        observe(batch)
        if i < int(wl["steps_compared"]):
            start.append(check.take(batch, idx))

    sync(device)
    marks.append(("warm-up steps", time.perf_counter()))
    log("set-up: before the run " + repr(marks[0][1] - t0) + " s; " + "; ".join(
        f"{name} {t - marks[i][1]!r} s" for i, (name, t) in enumerate(marks[1:])))

    # the measured window
    step_s = []
    t_start = t = time.perf_counter()
    while True:
        prev = batch
        batch = step(batch)
        observe(batch)
        now = time.perf_counter()
        step_s.append(now - t)
        t = now
        if now - t_start >= seconds:
            break
    window_s = t - t_start
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    late = (check.take(prev, idx), check.take(batch, idx))
    n_failed = failed_worlds(batch)
    del prev
    ctx = Context(wl, cfg_doc, n_worlds, t_start - t0, window_s, step_s, log=log, state_bytes=state_bytes(batch))
    log(f"window: {len(step_s)} steps of {n_worlds} worlds in {window_s:.3f} s; set-up {t_start - t0:.3f} s; "
        f"median step {statistics.median(step_s) * 1e3:.3f} ms; {n_failed} worlds failed")

    if traced:
        batch = _traced_phases(ctx, readers, step, observe, batch, device, log)
    del batch, observe
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(CHECK_THREADS)
    try:
        numbers = check.compare(cfg_doc, wl, idx, dv[idx.to(dv.device)].cpu(), dw[idx.to(dw.device)].cpu(),
                                state0, start, late, sub.config, log)
    except Exception as e:  # a state the reference cannot take is not correct
        log(f"check: the comparison failed: {type(e).__name__}: {e}")
        numbers = {k: math.inf for k in check.NUMBERS}
    finally:
        torch.set_num_threads(threads)
    log(f"check: {time.perf_counter() - t_check:.2f} s on the CPU, {len(idx)} worlds")
    checks = {k: {"value": numbers[k], "limit": v} for k, v in wl["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    values = {}
    for m in metrics:
        try:
            v = readers[m["name"]].read(ctx)
        except Exception as e:  # a reader that cannot read reports nothing
            log(f"metric {m['name']}: not read: {type(e).__name__}: {e}")
            v = None
        if v is None:
            log(f"metric {m['name']}: nothing to read in this run; left out")
            continue
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    steps = len(step_s)
    out = {
        "correct": correct,
        "attempted": n_worlds * steps,
        "failed": n_failed * steps,
        "metrics": values,
        "device": {"memory_peak_bytes": int(memory_peak)},
    }
    if traced and ctx.profile:
        out["device"].update(busy_s=ctx.profile["busy_s"], window_s=ctx.profile["window_s"])
        out["breakdown"] = {"device_ops": ctx.profile["device_ops"], "idle_gaps": ctx.profile["idle_gaps"]}
    out["checks"] = checks
    return out


def _traced_phases(ctx, readers, step, observe, batch, device, log):
    """The profiled window, then the spans' window. Returns the batch."""
    mean_s = ctx.window_s / len(ctx.step_s)
    captures, spans = set(), set()
    for mod in readers.values():
        captures.update(tuple(c) for c in getattr(mod, "CAPTURE", ()))
        spans.update(tuple(s) for s in getattr(mod, "SPANS", ()))

    # profiled window: the same loop as the measured one, with the inputs
    # of the captured functions kept from their last call
    n_prof = max(3, min(200, round(PROFILE_S / mean_s)))
    with Patch() as patch:
        for module, name in sorted(captures):
            try:
                mod, fn = _import_attr(module, name)
            except (ImportError, AttributeError) as e:
                log(f"trace: cannot capture {module}.{name}: {e}")
                continue
            patch.install(mod, name, _capturing(ctx.captured, (module, name), fn))
        batch, ctx.profile = tracing.profiled(step, observe, batch, n_prof, device)
    log(f"trace: profiled {n_prof} steps: window {ctx.profile['window_s']:.4f} s, device busy "
        f"{ctx.profile['busy_s']:.4f} s")

    # spans' window: each wrapped function timed between two device syncs
    n_span = max(3, min(200, round(SPAN_S / mean_s)))
    want = step(batch)
    sync(device)
    ctx.spans = {s: [0.0, 0] for s in spans}
    with Patch() as patch:
        for module, name in sorted(spans):
            try:
                mod, fn = _import_attr(module, name)
            except (ImportError, AttributeError) as e:
                log(f"spans: {module}.{name} is gone: {e}")
                ctx.spans.pop((module, name))
                continue
            patch.install(mod, name, _synced(ctx.spans[(module, name)], fn, device))
        got = step(batch)
        sync(device)
        if not _states_equal(want, got):
            ctx.span_note = "the wrapped step ended in another state than the unwrapped one"
            log(f"spans: left out: {ctx.span_note}")
        del want
        for _ in range(n_span - 1):
            got = step(got)
        sync(device)
    ctx.span_steps = n_span
    ctx.spans = {k: tuple(v) for k, v in ctx.spans.items()}
    return got


def _capturing(store, key, fn):
    def wrapper(*args, **kwargs):
        store[key] = (args, kwargs)
        return fn(*args, **kwargs)

    return wrapper


def _synced(acc, fn, device):
    def wrapper(*args, **kwargs):
        sync(device)
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(device)
        acc[0] += time.perf_counter() - t
        acc[1] += 1
        return out

    return wrapper
