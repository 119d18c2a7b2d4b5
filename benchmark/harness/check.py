"""Whether what the timed path produced is correct: the program's states
against the plain reference's (`refsim`), on the CPU, in float32.

Two comparisons, on a sample of the cell's worlds drawn from the seed:

- from the start: the reference builds the scene itself, freezes it (the
  masses, tables and capacities that `World.freeze` derives), replicates
  it, adds the same velocity jitter, and follows the first steps that the
  program's timed call made on the whole batch during set-up;
- the window's last step: the reference steps the program's own state
  from before that step once, and is held to the program's state after it.
  A simulation diverges from any second computation after some steps, so
  this is the one comparison that can be made late in a run; the first
  one checks the start that it skips.

Each number compared is a widest gap over the sampled worlds and the
compared steps (`GROUPS`), or a count of what differs bit for bit
(`frozen_mismatch`), and has its limit in the cell's file.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# number: (table, fields, mask, relative)
GROUPS = {
    "pose_gap": ("bodies", ("position", "rot"), "body", False),
    "velocity_gap": ("bodies", ("v", "w"), "body", False),
    "contact_gap": ("contacts", ("anchor_a", "anchor_b", "separation", "normal"), "point", False),
    "impulse_gap": ("contacts", ("normal_impulse", "tangent_impulse"), "point", True),
    "joint_gap": ("joints", ("impulse", "motor_impulse", "lower_impulse", "upper_impulse"), "joint", True),
}
NUMBERS = ("frozen_mismatch", *GROUPS)


def take(state, idx: torch.Tensor):
    """The worlds idx of a [W, ...] state, on the CPU."""
    return state.map(lambda x: x[idx.to(x.device)].cpu())


def to_reference(state):
    """A program state (any dataclasses with the reference's field names)
    as the reference's `State`, sharing nothing with it."""
    from refsim import state as rs

    def conv(x, cls):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(x, f.name)
            sub = getattr(rs, f.type, None) if isinstance(f.type, str) else None
            kw[f.name] = conv(v, sub) if dataclasses.is_dataclass(sub) else v.clone()
        return cls(**kw)

    return conv(state, rs.State)


def _masks(s):
    c = s.contacts
    point = c.alive[..., None] & (torch.arange(2) < c.point_count[..., None])
    return {"body": s.bodies.alive, "point": point, "joint": s.joints.alive}


def _expand(mask, x):
    while mask.dim() < x.dim():
        mask = mask[..., None]
    return mask.expand_as(x)


def gaps(prog, ref) -> dict:
    """The widest gap of each group of `GROUPS` between two states of the
    same worlds: over the live rows of either side; in the groups marked
    relative, over the reference's largest magnitude in the group."""
    mp, mr = _masks(prog), _masks(ref)
    out = {}
    for name, (table, fields, mkey, relative) in GROUPS.items():
        worst, scale = 0.0, 0.0
        for f in fields:
            a, b = getattr(getattr(prog, table), f), getattr(getattr(ref, table), f)
            if mkey == "point" and f == "normal":
                m = (mp[mkey] | mr[mkey]).any(-1)
            else:
                m = mp[mkey] | mr[mkey]
            m = _expand(m, a)
            if not m.any():
                continue
            d = (a - b).abs()[m]
            worst = max(worst, float(torch.nan_to_num(d, nan=math.inf).max()))
            scale = max(scale, float(b.abs()[m].max()))
        if relative and worst > 0:
            worst = worst / scale if scale > 0 else math.inf
        out[name] = worst
    return out


def _mismatch(a, b) -> int:
    """Elements of two trees of tensors that differ bit for bit."""
    if dataclasses.is_dataclass(a):
        return sum(_mismatch(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.is_floating_point():
        return int((a.view(torch.int32) != b.view(torch.int32)).sum()) if a.dtype == torch.float32 else \
            int((a != b).sum())
    return int((a != b).sum())


def config_mismatch(prog_cfg, ref_cfg) -> list[str]:
    """The configuration fields that the program's freeze set otherwise than
    the reference's."""
    return [f.name for f in dataclasses.fields(ref_cfg)
            if getattr(prog_cfg, f.name, None) != getattr(ref_cfg, f.name)]


def compare(cfg_doc, wl, idx, dv, dw, state0, start, late, prog_cfg, log) -> dict:
    """The numbers compared (`NUMBERS`). state0: the program's sampled
    worlds after the jitter; start: after each of its first steps; late:
    (before, after) the window's last step; dv, dw: the jitter rows of the
    sampled worlds. All on the CPU, as the program's own state classes."""
    from . import subject

    with torch.no_grad():
        ref = subject.reference(cfg_doc, wl, "cpu")
        bad_cfg = config_mismatch(prog_cfg, ref.config)
        if bad_cfg:
            log(f"check: the program's configuration differs from the reference's in {', '.join(bad_cfg)}")
        batch = ref.apply_jitter(ref.replicate(ref.world, len(idx)), dv, dw)
        frozen = len(bad_cfg) + _mismatch(to_reference(state0), batch)
        worst = dict.fromkeys(GROUPS, 0.0)

        def fold(g, where):
            for k, v in g.items():
                worst[k] = max(worst[k], v)
            log(f"check: {where}: " + ", ".join(f"{k} {v!r}" for k, v in g.items()))

        for k, prog in enumerate(start, 1):
            batch = ref.step(batch)
            fold(gaps(to_reference(prog), batch), f"step {k} from the start")
        if late is not None:
            fold(gaps(to_reference(late[1]), ref.step(to_reference(late[0]))), "the window's last step")
    return {"frozen_mismatch": float(frozen), **worst}
