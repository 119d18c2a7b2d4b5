"""The profiled window: steps under `torch.profiler`, read into the
device's busy time, the time of each kernel by name, the device ops that
took most time and the idle gaps by the host op that ran when each began.
"""

from __future__ import annotations

import bisect
import collections

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function, schedule

STEP_MARK = "bench.step"
TOP = 10
# the host ops looked at, backwards from a gap, for the one that holds it
_SCAN = 4000
_NAME = 120


def profiled(step, observe, batch, n_steps: int, device):
    """n_steps steps of the measured loop under the profiler, after two
    profiled warm-up steps that are not kept. Returns (batch, analysis)."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, schedule=schedule(wait=0, warmup=2, active=n_steps, repeat=1)) as prof:
        for _ in range(n_steps + 2):
            with record_function(STEP_MARK):
                batch = step(batch)
                observe(batch)
            prof.step()
    return batch, analyse(prof.events())


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def analyse(events) -> dict:
    """busy_s and window_s (the profiled steps' span), kernels {name:
    (seconds, launches)}, device_ops and idle_gaps ([[name, seconds]], the
    TOP largest). Times of the profiler are in microseconds."""
    marks = [e for e in events if e.name == STEP_MARK and e.device_type == DeviceType.CPU]
    if not marks:
        raise RuntimeError("the profiler recorded no step")
    w0 = min(e.time_range.start for e in marks)
    w1 = max(e.time_range.end for e in marks)
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if _marker(e):
            continue
        if e.device_type == DeviceType.CUDA:
            if t > w0 and s < w1:
                dev.append((max(s, w0), min(t, w1), e.name))
        elif t > s:
            host.append((s, t, e.name))
    busy = _union([(s, t) for s, t, _ in dev])
    busy_us = sum(t - s for s, t in busy)

    kernels = collections.defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        k = kernels[name]
        k[0] += (t - s) * 1e-6
        k[1] += 1
    ops = sorted(((n[:_NAME], v[0]) for n, v in kernels.items()), key=lambda kv: -kv[1])

    host.sort()
    starts = [h[0] for h in host]
    gaps = collections.defaultdict(float)
    edges = [w0] + [t for _, t in busy]
    nexts = [s for s, _ in busy] + [w1]
    for g0, g1 in zip(edges, nexts):
        if g1 <= g0:
            continue
        gaps[_holder(host, starts, g0)] += (g1 - g0) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernels": {n: (v[0], v[1]) for n, v in kernels.items()},
        "device_ops": [[n, s] for n, s in ops[:TOP]],
        "idle_gaps": [[n, s] for n, s in idle[:TOP]],
    }


def _marker(e) -> bool:
    """The step marks and the profiler's own step ranges, which are no work:
    on the device they are annotations that span whole steps."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name == STEP_MARK or e.name.startswith("ProfilerStep")


def _holder(host, starts, t) -> str:
    """The name of the innermost host op running at t: of those begun by
    t and not yet ended, the one begun last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - _SCAN), -1):
        s, e, name = host[j]
        if e > t:
            return name[:_NAME]
    return "(no host op)"
