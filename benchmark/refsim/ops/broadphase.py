"""Broadphase and persistent contact matching on tensors.

Port of the JAX package's `ops/broadphase.py`: fat-AABB hysteresis
(reference: src/world.c:286-297), the two pair finders with the pair rules
of s2PairQueryCallback (src/broad_phase.c:166-258), each for one world or
per world over a batch: the hashed uniform grid (`find_pairs_grid`) and the
sweep and prune (`find_pairs`); and the match of the new pair table against
the old one, which carries manifolds, impulses, GJK caches and TGS_Sticky's
friction anchors (src/contact.c:296-359), per world (`match_contacts`).

Integer fields stay int32 tensors throughout: no field rides a float pack.
Sorts whose keys can tie are stable, as `jnp.argsort` is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import AABB_MARGIN, INT32_MAX, SimConfig
from ..state import Contacts, Shapes, sticky_width
from .math2d import sqrt

I32 = torch.int32


def wrap_index(idx, n: int):
    """JAX indexing semantics for an index that may be -1: wrap negatives
    (the JAX gathers read row n-1 for a dead slot's -1 owner)."""
    return torch.where(idx < 0, idx + n, idx)


def update_fat_aabbs(fat, aabbs, body_type):
    """Enlarge-on-escape hysteresis (reference: src/world.c:286-297). `aabbs`
    include the speculative margin; static shapes get no extra margin
    (src/shape.c:58). Shapes [..., S, 4]; body_type [..., S]."""
    contained = (
        (fat[..., 0] <= aabbs[..., 0]) & (fat[..., 1] <= aabbs[..., 1])
        & (aabbs[..., 2] <= fat[..., 2]) & (aabbs[..., 3] <= fat[..., 3])
    )
    margin = torch.where(body_type == 0, 0.0, AABB_MARGIN).to(aabbs.dtype)
    grown = aabbs + torch.stack([-margin, -margin, margin, margin], dim=-1)
    return torch.where(contained[..., None], fat, grown)


class PairResult(NamedTuple):
    shape_a: torch.Tensor  # i32 [C]
    shape_b: torch.Tensor  # i32 [C]
    key: torch.Tensor      # i32 [C] a * max_shapes + b, INT32_MAX when empty
    valid: torch.Tensor    # bool [C]
    count: torch.Tensor    # i32 [] candidate pairs found
    overflow: torch.Tensor  # bool []


def _compact_keys(flat_key, C: int):
    """Per row of flat_key [W, N]: the valid (!= INT32_MAX) keys, the first C
    of them in flat order, sorted ascending and padded with INT32_MAX.
    Returns (keys [W, C], count [W])."""
    W = flat_key.shape[0]
    vmask = flat_key != INT32_MAX
    count = vmask.sum(dim=1).to(I32)
    posn = torch.cumsum(vmask, dim=1) - 1
    cells = torch.where(vmask & (posn < C), posn, C)
    tbl = torch.zeros((W, C + 1), dtype=I32, device=flat_key.device)
    tbl.scatter_(1, cells, torch.where(vmask, flat_key, 0))  # positions < C are unique
    kept = torch.arange(C, device=flat_key.device) < torch.clamp(count, max=C)[:, None]
    return torch.sort(torch.where(kept, tbl[:, :C], INT32_MAX), dim=1).values, count


def jointed_body_keys(joints, config: SimConfig):
    """Sorted canonical body-pair keys of joints with collideConnected=False
    (INT32_MAX padding)."""
    ba, bb = joints.body_a, joints.body_b
    key = torch.minimum(ba, bb) * config.max_bodies + torch.maximum(ba, bb)
    key = torch.where(joints.alive & ~joints.collide_connected, key, INT32_MAX)
    return torch.sort(key).values


def _pair_rules(a, b, jointed_keys, max_bodies: int):
    """s2PairQueryCallback's rules (reference: src/broad_phase.c:166-258) on
    per-candidate shape fields; `a` and `b` are dicts of broadcastable
    tensors (fat, body, group, mask, cat, alive, dyn) with a leading worlds
    dim, jointed_keys [W, J] each world's sorted keys (`jointed_body_keys`)."""
    fa, fb = a["fat"], b["fat"]
    overlap = (
        (fa[..., 0] <= fb[..., 2]) & (fb[..., 0] <= fa[..., 2])
        & (fa[..., 1] <= fb[..., 3]) & (fb[..., 1] <= fa[..., 3])
    )
    valid = overlap & a["alive"] & b["alive"]
    valid &= a["body"] != b["body"]
    valid &= a["dyn"] | b["dyn"]
    # filters (reference: src/contact.h:70-79)
    ga, gb = a["group"], b["group"]
    same_group = (ga == gb) & (ga != 0)
    mask_ok = ((a["mask"] & b["cat"]) != 0) & ((a["cat"] & b["mask"]) != 0)
    valid &= torch.where(same_group, ga > 0, mask_ok)
    # joint-connected suppression (reference: src/body.c:386-417)
    # a binary search of the sorted keys: the same membership as comparing
    # with every key, in log J (the published Joint Grid has 19,800 joints)
    bkey = torch.minimum(a["body"], b["body"]) * max_bodies + torch.maximum(a["body"], b["body"])
    flat = bkey.reshape(bkey.shape[0], -1).contiguous()
    pos = torch.clamp(torch.searchsorted(jointed_keys, flat), max=jointed_keys.shape[1] - 1)
    valid &= ~(torch.gather(jointed_keys, 1, pos) == flat).reshape(bkey.shape)
    return valid


def _cell_hash(cx, cy):
    """Spatial hash of int32 cell coords with int32 wraparound, masked to 23
    bits (the JAX package's hash, bit for bit)."""
    h = cx * -1640531527 + cy * 97143011
    h = h ^ (h >> 13)
    return h & 0x7FFFFF


def find_pairs_grid(shapes: Shapes, body_type, jointed_keys, config: SimConfig) -> PairResult:
    """Uniform-grid pair finding, per world: small shapes bin by fat-AABB
    center into cells sorted by cell hash; each shape tests the <=
    cell_capacity occupants of its half neighbourhood {self, E, NW, N, NE};
    shapes larger than a cell form the big list, tested against everything.

    Takes one world (shapes [S], body_type [B], jointed_keys [J]) or a batch
    with a leading worlds dim on each, and returns pairs of the same rank.
    Every per-world search and sort runs along the last dim, so worlds never
    mix."""
    if shapes.fat_aabb.dim() == 2:
        one = shapes.map(lambda x: x[None])
        out = find_pairs_grid(one, body_type[None], jointed_keys[None], config)
        return PairResult(*(x[0] for x in out))
    W = shapes.fat_aabb.shape[0]
    S = config.max_shapes
    M = config.cell_capacity
    G = config.max_big_shapes
    dev = shapes.fat_aabb.device
    cell = torch.tensor(config.grid_cell, dtype=torch.float32, device=dev)
    fat = shapes.fat_aabb
    alive = shapes.alive
    worlds = torch.arange(W, device=dev)[:, None, None]

    w = fat[..., 2] - fat[..., 0]
    h = fat[..., 3] - fat[..., 1]
    big = alive & ((w > cell) | (h > cell))
    small = alive & ~big

    cx = torch.floor(0.5 * (fat[..., 0] + fat[..., 2]) / cell).to(I32)
    cy = torch.floor(0.5 * (fat[..., 1] + fat[..., 3]) / cell).to(I32)
    hashes = torch.where(small, _cell_hash(cx, cy), INT32_MAX)              # [W,S]

    order = torch.argsort(hashes, dim=1, stable=True).to(I32)
    sorted_hash = torch.gather(hashes, 1, order.long())

    offsets = [(0, 0), (1, 0), (-1, 1), (0, 1), (1, 1)]
    NO = len(offsets)
    nh_all = torch.stack([_cell_hash(cx + dx, cy + dy) for dx, dy in offsets], dim=1)  # [W,NO,S]
    lo = torch.searchsorted(sorted_hash, nh_all.reshape(W, NO * S), side="left").to(I32).reshape(W, NO, S)
    lanes = torch.arange(M, dtype=I32, device=dev)
    cand_rank = lo[..., None] + lanes                                      # [W,NO,S,M]
    pos = torch.clamp(cand_rank, max=S - 1)
    in_range = cand_rank < S
    # cell-capacity overflow: the (M+1)-th occupant of a looked-up bucket
    # still carries the neighbour hash
    ovf_rank = lo + M
    ovf_hash = torch.gather(sorted_hash, 1, torch.clamp(ovf_rank, max=S - 1).reshape(W, -1).long()).reshape(W, NO, S)
    overflow = (small[:, None, :] & (ovf_rank < S) & (ovf_hash == nh_all)).flatten(1).any(dim=1)

    grid_cand = torch.gather(order, 1, pos.permute(0, 2, 1, 3).reshape(W, -1).long()).reshape(W, S, NO * M)
    grid_valid = (in_range & small[:, None, :, None]).permute(0, 2, 1, 3).reshape(W, S, NO * M)

    # big-shape list: slot r holds the r-th big shape (the last slot the
    # largest index once the list overflows), padded with 0
    idx = torch.arange(S, dtype=I32, device=dev)
    nbig = big.sum(dim=1)
    big_cells = torch.where(big, torch.clamp(torch.cumsum(big, 1) - 1, max=G - 1), G)
    big_idx = torch.zeros((W, G + 1), dtype=I32, device=dev).scatter_reduce(
        1, big_cells, idx.expand(W, S), "amax", include_self=True
    )[:, :G]
    big_slot_valid = torch.arange(G, device=dev) < torch.clamp(nbig, max=G)[:, None]
    overflow = overflow | (nbig > G)

    K = NO * M + G
    a_idx = idx[:, None].expand(S, K)
    b_idx = torch.cat([grid_cand, big_idx[:, None, :].expand(W, S, G)], dim=2)   # [W,S,K]
    valid = torch.cat([grid_valid, big_slot_valid[:, None, :] & alive[:, :, None]], dim=2)

    # a candidate is real iff its own cell hash equals the looked-up
    # neighbour hash (dead and big shapes carry -1)
    own_hash = torch.where(small, hashes, -1)
    nh_cols = nh_all.permute(0, 2, 1)[..., None].expand(W, S, NO, M).reshape(W, S, NO * M)
    hash_ok = own_hash[worlds, b_idx[..., : NO * M]] == nh_cols
    # own-cell block: a<b visits each in-cell pair once
    half_ok = torch.cat(
        [a_idx[:, :M] < b_idx[..., :M], torch.ones((W, S, (NO - 1) * M), dtype=torch.bool, device=dev)], dim=2
    )
    # big-b columns: small-a keeps; big-big dedups by a<b
    big_ok = small[..., None] | (a_idx[:, NO * M:] < b_idx[..., NO * M:])
    valid &= torch.cat([hash_ok & half_ok, big_ok], dim=2)

    B = body_type.shape[1]
    fields = dict(
        fat=fat, body=shapes.body, group=shapes.filter_group, mask=shapes.filter_mask,
        cat=shapes.filter_category, alive=alive,
        dyn=torch.gather(body_type, 1, wrap_index(shapes.body, B).long()) == 2,
    )
    rows_a = {k: v[:, :, None] for k, v in fields.items()}
    rows_b = {k: v[worlds, b_idx] for k, v in fields.items()}
    valid &= _pair_rules(rows_a, rows_b, jointed_keys.contiguous(), config.max_bodies)

    pair_key = torch.where(valid, torch.minimum(a_idx, b_idx) * S + torch.maximum(a_idx, b_idx), INT32_MAX)
    C = config.max_contacts
    top_key, count = _compact_keys(pair_key.reshape(W, -1), C)
    # drop duplicates (only under a neighbour-cell hash collision), keep sorted
    dup = torch.cat([torch.zeros((W, 1), dtype=torch.bool, device=dev), top_key[:, 1:] == top_key[:, :-1]], dim=1)
    top_key = torch.sort(torch.where(dup, INT32_MAX, top_key), dim=1).values
    filled = top_key != INT32_MAX
    sa = torch.where(filled, top_key // S, 0).to(I32)
    sb = torch.where(filled, top_key % S, 0).to(I32)
    overflow = overflow | (count > C)
    return PairResult(sa, sb, top_key, filled, count, overflow)


def find_pairs(shapes: Shapes, body_type, jointed_keys, config: SimConfig) -> PairResult:
    """Sweep and prune over fat AABBs, per world: shapes sorted by their
    low bound on the axis of the larger variance of AABB centers (stably,
    as `jnp.argsort`), each tested against its `sap_window` successors; the
    window overflows when the next successor still overlaps on that axis.
    Takes one world or a batch, as `find_pairs_grid`."""
    if shapes.fat_aabb.dim() == 2:
        one = shapes.map(lambda x: x[None])
        out = find_pairs(one, body_type[None], jointed_keys[None], config)
        return PairResult(*(x[0] for x in out))
    W = shapes.fat_aabb.shape[0]
    S = config.max_shapes
    K = config.sap_window
    dev = shapes.fat_aabb.device
    fat = shapes.fat_aabb
    alive = shapes.alive
    worlds = torch.arange(W, device=dev)[:, None, None]

    cx = 0.5 * (fat[..., 0] + fat[..., 2])
    cy = 0.5 * (fat[..., 1] + fat[..., 3])
    n_alive = torch.clamp(alive.sum(dim=1, keepdim=True), min=1).to(torch.float32)
    mx = torch.where(alive, cx, 0.0).sum(dim=1, keepdim=True) / n_alive
    my = torch.where(alive, cy, 0.0).sum(dim=1, keepdim=True) / n_alive
    var_x = torch.where(alive, (cx - mx) ** 2, 0.0).sum(dim=1, keepdim=True)
    var_y = torch.where(alive, (cy - my) ** 2, 0.0).sum(dim=1, keepdim=True)
    on_y = var_y > var_x                                                # [W,1]

    lo = torch.where(on_y, fat[..., 1], fat[..., 0])
    hi = torch.where(on_y, fat[..., 3], fat[..., 2])
    sort_key = torch.where(alive, lo, torch.inf)
    order = torch.sort(sort_key, dim=1, stable=True).indices             # [W,S]
    lo_s = torch.gather(lo, 1, order)
    hi_s = torch.gather(hi, 1, order)

    # candidates: the shape of rank r and those of ranks r+1 .. r+K
    ranks = torch.arange(S, device=dev)
    partner_rank = ranks[:, None] + 1 + torch.arange(K, device=dev)    # [S,K]
    in_range = partner_rank < S
    partner = torch.clamp(partner_rank, max=S - 1).flatten()
    a_idx = order[:, :, None]                                           # [W,S,1]
    b_idx = order[:, partner].reshape(W, S, K)                          # [W,S,K]
    valid = in_range & (lo[worlds, b_idx] <= hi_s[..., None])

    # window overflow: the (K+1)-th successor still overlaps on the sweep
    # axis. The alive test reads `sort_key` by shape index against the
    # rank-ordered bounds, as the JAX package does.
    last_rank = ranks + 1 + K
    last_lo = lo_s[:, torch.clamp(last_rank, max=S - 1)]
    window_overflow = ((last_rank < S) & (last_lo <= hi_s) & (sort_key != torch.inf)).any(dim=1)

    B = body_type.shape[1]
    fields = dict(
        fat=fat, body=shapes.body, group=shapes.filter_group, mask=shapes.filter_mask,
        cat=shapes.filter_category, alive=alive,
        dyn=torch.gather(body_type, 1, wrap_index(shapes.body, B).long()) == 2,
    )
    rows_a = {k: v[worlds, a_idx] for k, v in fields.items()}
    rows_b = {k: v[worlds, b_idx] for k, v in fields.items()}
    valid &= _pair_rules(rows_a, rows_b, jointed_keys.contiguous(), config.max_bodies)

    a32, b32 = a_idx.to(I32), b_idx.to(I32)
    pair_key = torch.where(valid, torch.minimum(a32, b32) * S + torch.maximum(a32, b32), INT32_MAX)
    # each unordered pair appears once in the window scheme: no duplicates
    C = config.max_contacts
    top_key, count = _compact_keys(pair_key.reshape(W, -1), C)
    filled = top_key != INT32_MAX
    sa = torch.where(filled, top_key // S, 0).to(I32)
    sb = torch.where(filled, top_key % S, 0).to(I32)
    return PairResult(sa, sb, top_key, filled, count, window_overflow | (count > C))


def find_pairs_by(shapes: Shapes, body_type, jointed_keys, config: SimConfig) -> PairResult:
    """The pair finder `config.broadphase` names: "grid" or "sap"."""
    if config.broadphase == "grid":
        return find_pairs_grid(shapes, body_type, jointed_keys, config)
    return find_pairs(shapes, body_type, jointed_keys, config)


def match_contacts(old: Contacts, pairs: PairResult, shapes: Shapes) -> Contacts:
    """Per-world persistent matching of a [W, C] batch (reference:
    src/contact.c:156-229 creation, :296-359 persistence): each world's new
    pair table searches its own old table; a pair that existed keeps its
    manifold, impulses, GJK cache, color and (TGS_Sticky's table only) its
    friction anchors, a new one starts from zero (color -1)."""
    W, Cn = old.key.shape
    new_key = pairs.key
    pos = torch.clamp(torch.searchsorted(old.key, new_key, side="left"), max=Cn - 1)
    worlds = torch.arange(W, device=new_key.device)[:, None]
    found = (old.key[worlds, pos] == new_key) & (new_key != INT32_MAX) & old.alive[worlds, pos]

    def carry(x, fill):
        v = x[worlds, pos]
        f = found.reshape(found.shape + (1,) * (v.dim() - 2))
        return torch.where(f, v, fill)

    sticky = sticky_width(old)

    def carry_sticky(x, fill):
        return carry(x, fill) if sticky else x

    sa, sb = pairs.shape_a, pairs.shape_b
    friction = sqrt(shapes.friction[worlds, sa] * shapes.friction[worlds, sb])            # contact.c:42-45
    restitution = torch.maximum(shapes.restitution[worlds, sa], shapes.restitution[worlds, sb])  # :47-52
    return Contacts(
        key=new_key, shape_a=sa, shape_b=sb,
        body_a=shapes.body[worlds, sa], body_b=shapes.body[worlds, sb],
        friction=friction, restitution=restitution,
        normal=carry(old.normal, 0.0),
        anchor_a=carry(old.anchor_a, 0.0),
        anchor_b=carry(old.anchor_b, 0.0),
        separation=carry(old.separation, 0.0),
        normal_impulse=carry(old.normal_impulse, 0.0),
        tangent_impulse=carry(old.tangent_impulse, 0.0),
        point_id=carry(old.point_id, 0),
        persisted=carry(old.persisted, False),
        point_count=carry(old.point_count, 0),
        friction_normal_a=carry_sticky(old.friction_normal_a, 0.0),
        friction_normal_b=carry_sticky(old.friction_normal_b, 0.0),
        friction_anchor_a=carry_sticky(old.friction_anchor_a, 0.0),
        friction_anchor_b=carry_sticky(old.friction_anchor_b, 0.0),
        friction_persisted=carry_sticky(old.friction_persisted, False),
        cache_count=carry(old.cache_count, 0),
        cache_index_a=carry(old.cache_index_a, 0),
        cache_index_b=carry(old.cache_index_b, 0),
        color=carry(old.color, -1),
        alive=pairs.valid,
    )


