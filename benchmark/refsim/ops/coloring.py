"""Coloring of the constraint graphs: the persistent incremental coloring
and the per-step MIS coloring.

Port of the JAX package's `ops/coloring.py` (`assign_colors`,
`color_graph`, `build_body_map`); each also runs
per world over a batch. Colors fix the Gauss-Seidel order, so every
integer output here equals the JAX function's. Scatters reduce with max,
min or add over int32, whose result does not depend on the order of the
updates.
"""

from __future__ import annotations

import torch


I32 = torch.int32


def _hash_priority(idx):
    """Injective pseudo-random priority: Knuth multiplicative hash with int32
    wraparound (2654435761 as -1640531527), reduced mod 2^31."""
    return (idx * -1640531527) & 0x7FFFFFFF


def _scatter_max(target, idx, vals):
    return target.scatter_reduce(-1, idx.long(), vals, "amax", include_self=True)


def _scatter_add(target, idx, vals):
    return target.scatter_add(-1, idx.long(), vals)


def _gather(table, idx):
    return torch.gather(table, -1, idx.long())


INT32_MAX = 2**31 - 1


def color_graph(body_a, body_b, active, dynamic_mask, num_bodies: int, max_colors: int, inner_rounds: int = 4):
    """The per-step Jones-Plassmann coloring: for each of the first
    max_colors - 1 colors, `inner_rounds` rounds in which every eligible
    constraint whose hashed priority is the least at both its dynamic
    endpoints joins the color. Active constraints left over take the last
    color, which may have conflicts. Returns (color i32 [N] in [0,
    max_colors), overflow i32 count); on a batch of graphs ([W, N],
    dynamic_mask [W, B]) each world's own.

    Each body's owner is an integer minimum over its constraints, a
    scatter whatever the order of its updates; the JAX package reduces a
    dense [B+1, N] incidence matrix instead (a TPU workaround)."""
    if body_a.dim() == 1:
        color, overflow = color_graph(body_a[None], body_b[None], active[None], dynamic_mask[None], num_bodies,
                                      max_colors, inner_rounds)
        return color[0], overflow[0]
    W, N = body_a.shape
    dev = body_a.device
    pri = _hash_priority(torch.arange(N, dtype=I32, device=dev)).expand(W, N)
    dyn_a = _gather(dynamic_mask, body_a)
    dyn_b = _gather(dynamic_mask, body_b)
    # non-dynamic endpoints point at a sink slot, which no round marks used
    slot_a = torch.where(dyn_a, body_a, num_bodies)
    slot_b = torch.where(dyn_b, body_b, num_bodies)
    slots_ab = torch.cat([slot_a, slot_b], dim=1)

    uncolored = torch.ones((W, N), dtype=torch.bool, device=dev)
    color = torch.full((W, N), max_colors - 1, dtype=I32, device=dev)
    for k in range(max_colors - 1):
        used = torch.zeros((W, num_bodies + 1), dtype=I32, device=dev)
        selected = torch.zeros((W, N), dtype=torch.bool, device=dev)
        for _ in range(inner_rounds):
            elig = uncolored & active & ~selected & (_gather(used, slot_a) == 0) & (_gather(used, slot_b) == 0)
            cand = torch.where(elig, pri, INT32_MAX)
            owner = torch.full((W, num_bodies + 1), INT32_MAX, dtype=I32, device=dev).scatter_reduce(
                1, slots_ab.long(), torch.cat([cand, cand], dim=1), "amin", include_self=True)
            win = elig & (~dyn_a | (_gather(owner, slot_a) == pri)) & (~dyn_b | (_gather(owner, slot_b) == pri))
            selected = selected | win
            used = _scatter_max(used, slots_ab, torch.cat([win, win], dim=1).to(I32))
            used[:, num_bodies] = 0
        color = torch.where(selected, k, color)
        uncolored = uncolored & ~selected
    color = torch.where(active, color, max_colors - 1).to(I32)
    return color, (uncolored & active).sum(dim=1).to(I32)


def assign_colors(carried, body_a, body_b, active, dynamic_mask, num_bodies: int,
                  max_colors: int, rounds: int = 8, bucket_cap: int = 0):
    """Validate the colors carried from the last step, then color the new
    constraints with first-fit rounds under hashed priorities; with
    `bucket_cap` > 0 a color whose population fills its bucket takes no new
    constraints. Returns (color i32 [N] with -1 for uncolored, overflow i32
    count). Requires max_colors <= 30 (an int32 bitmask of used colors).

    Takes one graph or a batch of graphs with a leading worlds dim on every
    argument (then the overflow is per world); rounds run while any world
    has an uncolored constraint, and a round leaves a world that has none
    as it was, as the JAX package's vmapped while-loop does."""
    assert max_colors <= 30, "assign_colors packs colors into an int32 bitmask"
    if body_a.dim() == 1:
        color, overflow = assign_colors(
            carried[None], body_a[None], body_b[None], active[None], dynamic_mask[None],
            num_bodies, max_colors, rounds, bucket_cap,
        )
        return color[0], overflow[0]
    W, N = body_a.shape
    dev = body_a.device
    idx = torch.arange(N, dtype=I32, device=dev)
    pri = _hash_priority(idx).expand(W, N)

    dyn_a = _gather(dynamic_mask, body_a)
    dyn_b = _gather(dynamic_mask, body_b)
    slot_a = torch.where(dyn_a, body_a, num_bodies)
    slot_b = torch.where(dyn_b, body_b, num_bodies)

    # out-of-range carried colors drop to -1 and recolor
    color = torch.where(active & (carried >= 0) & (carried < max_colors), carried, -1)
    full_mask = (1 << max_colors) - 1
    tbl_size = (num_bodies + 1) * max_colors
    slots_ab = torch.cat([slot_a, slot_b], dim=1)

    def validate(color):
        """Drop to -1 any colored constraint that does not own its (body,
        color) cell at both dynamic endpoints (priority max wins)."""
        colored = active & (color >= 0)
        c = torch.clamp(color, min=0)
        claim = torch.where(colored, pri, -1)
        cells = torch.where(
            torch.cat([colored, colored], dim=1), slots_ab * max_colors + torch.cat([c, c], dim=1), tbl_size
        )
        tbl = _scatter_max(
            torch.full((W, tbl_size + 1), -1, dtype=I32, device=dev), cells, torch.cat([claim, claim], dim=1)
        )
        got = _gather(tbl, cells)
        own = (~dyn_a | (got[:, :N] == pri)) & (~dyn_b | (got[:, N:] == pri))
        return torch.where(colored & ~own, -1, color)

    color = validate(color)
    bits = 1 << torch.arange(max_colors, dtype=I32, device=dev)
    r = 0
    # first-fit rounds until nothing is uncolored (zero rounds in a steady
    # state where every constraint persists)
    while r < rounds and bool((active & (color < 0)).any()):
        ok = active & (color >= 0)
        # used-color bitmask per body; surviving colors are distinct per body,
        # so the add is a bitwise or
        bit = torch.where(ok, 1 << torch.clamp(color, min=0), 0).to(I32)
        ok2 = torch.cat([ok, ok], dim=1)
        used = _scatter_add(
            torch.zeros((W, num_bodies + 1), dtype=I32, device=dev),
            torch.where(ok2, slots_ab, num_bodies), torch.cat([bit, bit], dim=1),
        )
        rows = _gather(used, slots_ab)
        free = ~(torch.where(dyn_a, rows[:, :N], 0) | torch.where(dyn_b, rows[:, N:], 0)) & full_mask
        if bucket_cap > 0:
            cnt = _scatter_add(
                torch.zeros((W, max_colors + 1), dtype=I32, device=dev),
                torch.where(ok, color, max_colors), torch.ones((W, N), dtype=I32, device=dev),
            )
            full_colors = torch.where(cnt[:, :max_colors] >= bucket_cap, bits, 0).sum(dim=1).to(I32)
            free = free & ~full_colors[:, None]
        lowbit = free & -free
        # index of the lowest set bit (exact for powers of two)
        newc = (torch.frexp(torch.clamp(lowbit, min=1).to(torch.float32)).exponent - 1).to(I32)
        propose = active & (color < 0) & (free != 0)
        color = validate(torch.where(propose, newc, color))
        r += 1
    overflow = (active & (color < 0)).sum(dim=1).to(I32)
    return color, overflow


def build_body_map(body_a, body_b, color, active, write_a, write_b, num_bodies: int, max_colors: int):
    """slot[..., b, k] = index of the color-k constraint that writes body b,
    or -1 (conflicting writers resolve to the largest index). Arguments [N]
    or [W, N]."""
    N = body_a.shape[-1]
    lead = body_a.shape[:-1]
    idx = torch.arange(N, dtype=I32, device=body_a.device).expand(lead + (N,))
    c = torch.clamp(color, 0, max_colors - 1)
    sink = num_bodies * max_colors
    cell_a = torch.where(write_a & active, body_a * max_colors + c, sink)
    cell_b = torch.where(write_b & active, body_b * max_colors + c, sink)
    slot = _scatter_max(
        torch.full(lead + (num_bodies * max_colors + 1,), -1, dtype=I32, device=body_a.device),
        torch.cat([cell_a, cell_b], dim=-1), torch.cat([idx, idx], dim=-1),
    )
    return slot[..., : num_bodies * max_colors].reshape(lead + (num_bodies, max_colors))


