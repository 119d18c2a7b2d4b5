"""One step of a world batch: the per-world step.

Port of the JAX package's `step.py` (reference pipeline:
src/world.c:120-306), as the port runs it: the JAX `step` vmapped over
worlds (`parallel.batch`). Each world has its own pairs
(`find_pairs_grid` or `find_pairs`, `match_contacts`), its narrowphase
through K2's plain twin with the worlds flattened into one lane batch
(`update_manifolds`; skipped with `solve_contacts=False`), its own contact
and joint colors (incremental, or a per-step MIS coloring with
`incremental_coloring=False`) and body maps, then one of two solve routes
(`config.use_fused`):
- fused: the soft solve of contacts and soft revolute and mouse joints in
  K1's plain twin (`solvers/loops.solve_prepared`), in the script of
  `config.solver`: TGS_Soft, SoftStep or PGS_Soft;
- XLA: the JAX package's XLA solver of `config.solver`, colored passes in
  plain PyTorch on the dense layout (`solvers/loops.SOLVERS`).
The port's lane step (`step_batch`), its bucketed layout and its other XLA
solvers are not copied: `step` refuses a configuration that asks for them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import SPECULATIVE_DISTANCE, SimConfig, use_fused
from .ops import broadphase, coloring
from .ops.geometry import compute_aabbs
from .ops.manifold import ManifoldOut, from_lanes, geom_rows
from .ops.narrow_cuda import collide
from .solvers.common import BodyMap, ContactCons, make_body_map
from .solvers.fused_solve import FusedInputs
from .solvers.joints import JointCons
from .solvers.loops import Colors, prepare_fused, solve_prepared, solve_xla
from .state import Contacts, Diagnostics, Joints, State, sticky_width

# the JAX package's narrowphase names, which compute the same math: the
# port runs K2 for each
NARROWPHASES = ("xla", "lanes", "pallas")

I32 = torch.int32


def _apply_manifolds(contacts: Contacts, out: ManifoldOut) -> Contacts:
    """Warm-start id matching and the manifold table update (reference:
    src/contact.c:328-358): a new point whose feature id equals a live old
    point's takes that point's impulses."""
    alive = contacts.alive
    pts = torch.arange(2, device=alive.device)
    new_count = torch.where(alive, out.point_count, 0)
    old_pmask = pts < contacts.point_count[..., None]
    new_pmask = pts < new_count[..., None]
    eq = (
        (out.point_id[..., :, None] == contacts.point_id[..., None, :])
        & old_pmask[..., None, :] & new_pmask[..., :, None]
    )
    matched = eq.any(-1)
    second = ~eq[..., 0] & eq[..., 1]  # first matching old point is point 1

    def take(old):
        return torch.where(second, old[..., 1:2], old[..., 0:1])

    a1, a2 = alive[..., None], alive[..., None, None]
    return dataclasses.replace(
        contacts,
        normal=torch.where(a1, out.normal, contacts.normal),
        anchor_a=torch.where(a2, out.anchor_a, contacts.anchor_a),
        anchor_b=torch.where(a2, out.anchor_b, contacts.anchor_b),
        separation=torch.where(a1, out.separation, contacts.separation),
        normal_impulse=torch.where(matched, take(contacts.normal_impulse), 0.0),
        tangent_impulse=torch.where(matched, take(contacts.tangent_impulse), 0.0),
        point_id=torch.where(a1, out.point_id, contacts.point_id),
        persisted=matched,
        point_count=new_count.to(I32),
        cache_count=torch.where(alive, out.cache_count, contacts.cache_count),
        cache_index_a=torch.where(a1, out.cache_ia, contacts.cache_index_a),
        cache_index_b=torch.where(a1, out.cache_ib, contacts.cache_index_b),
    )


def _geom_table(shapes):
    """The shape table of K2 [..., S, 34]: vx, vy, nx, ny rows, count, radius."""
    return geom_rows(shapes.verts, shapes.normals, shapes.count, shapes.radius)


def _cache(contacts: Contacts):
    return torch.cat(
        [contacts.cache_count[:, None], contacts.cache_index_a.transpose(1, 2),
         contacts.cache_index_b.transpose(1, 2)],
        dim=1,
    ).contiguous()


def world_narrow_inputs(batch: State, contacts: Contacts):
    """K2's inputs for W worlds with their own shapes and pairs, flattened
    into one lane batch of W*C contacts: the shape tables stacked [W*S, 34],
    shape indices offset by w*S, poses [1, 4, W*C], caches [1, 7, W*C]."""
    W, S = batch.shapes.body.shape
    geom = _geom_table(batch.shapes).reshape(W * S, 34).contiguous()
    off = (torch.arange(W, dtype=torch.int32, device=geom.device) * S)[:, None]
    worlds = torch.arange(W, device=geom.device)[:, None]
    pose = torch.cat([batch.bodies.origin, batch.bodies.rot], dim=-1)  # [W, B, 4]

    def lanes(x):  # [W, C, k] -> [1, k, W*C]
        return x.reshape(-1, x.shape[-1]).t()[None].contiguous()

    return (
        geom, (contacts.shape_a + off).reshape(-1).contiguous(), (contacts.shape_b + off).reshape(-1).contiguous(),
        lanes(pose[worlds, contacts.body_a]), lanes(pose[worlds, contacts.body_b]),
        lanes(_cache(contacts).transpose(1, 2)),
    )


def update_manifolds(batch: State, contacts: Contacts, gjk_iters: int, impl: str = "xla") -> Contacts:
    """The narrowphase of every world's own contacts through K2, then id
    matching (reference: src/contact.c:296-359). Every `impl` of the JAX
    package ("xla", the per-pair manifold; "lanes" and "pallas", its
    lane-major mirror) computes the same math, and each runs K2 here."""
    if impl not in NARROWPHASES:
        raise ValueError(f"narrowphase {impl!r}: one of {', '.join(NARROWPHASES)}")
    W, C = contacts.key.shape
    fout, iout, cout = collide(*world_narrow_inputs(batch, contacts), gjk_iters)

    def worlds(x):  # [1, k, W*C] -> [W, k, C]
        return x[0].reshape(x.shape[1], W, C).transpose(0, 1)

    return _apply_manifolds(contacts, from_lanes(worlds(fout), worlds(iout), worlds(cout)))


def _post_solve(batch: State, new_bodies, contacts, joints, pair_count, pair_overflow, sbt, touching,
                color_overflow) -> State:
    """AABB + fat-AABB hysteresis update, diagnostics, the new State."""
    shapes = batch.shapes
    W, B = new_bodies.type.shape
    new_pose = torch.cat([new_bodies.origin, new_bodies.rot], dim=-1)
    worlds = torch.arange(W, device=new_pose.device)[:, None]
    shape_pose = new_pose[worlds, broadphase.wrap_index(shapes.body, B)]
    aabbs = compute_aabbs(shapes.verts, shapes.radius, shape_pose[..., 0:2], shape_pose[..., 2:4])
    aabbs = aabbs + torch.tensor([-1.0, -1.0, 1.0, 1.0], device=aabbs.device) * SPECULATIVE_DISTANCE
    fat = broadphase.update_fat_aabbs(shapes.fat_aabb, aabbs, sbt)

    pts = torch.arange(2, device=touching.device)
    pen = torch.where(
        touching[..., None] & (pts < contacts.point_count[..., None]), -contacts.separation, 0.0
    )
    diag = Diagnostics(
        contact_count=touching.sum(dim=1).to(I32),
        pair_count=pair_count.to(I32),
        pair_overflow=pair_overflow,
        color_overflow=color_overflow.to(I32),
        max_penetration=pen.flatten(1).amax(dim=1),
        step_id=batch.diag.step_id + 1,
    )
    return State(
        bodies=new_bodies,
        shapes=dataclasses.replace(shapes, aabb=aabbs, fat_aabb=fat),
        contacts=contacts,
        joints=joints,
        gravity=batch.gravity,
        diag=diag,
    )


def _pre_solve(batch: State, config: SimConfig):
    """Per world: pair update from last step's fat AABBs, persistent
    matching, narrowphase (statically skipped with `solve_contacts=False`:
    pairs and matching still run, so `pair_count` shows any pair that
    appears). Returns (contacts, pairs, shape body types)."""
    shapes, bodies = batch.shapes, batch.bodies
    B = bodies.type.shape[1]
    sbt = torch.where(shapes.alive, torch.gather(bodies.type, 1, broadphase.wrap_index(shapes.body, B).long()), 0)
    jointed = broadphase.jointed_body_keys(batch.joints, config)
    pairs = broadphase.find_pairs_by(shapes, bodies.type, jointed, config)
    contacts = broadphase.match_contacts(batch.contacts, pairs, shapes)
    if config.solve_contacts:
        contacts = update_manifolds(batch, contacts, config.gjk_iters, config.narrowphase)
    return contacts, pairs, sbt


def _inert_map(W, B, K, N, device):
    """The body map of a statically skipped constraint kind: no slot, no winner."""
    return BodyMap(slot=torch.full((W, B, K), -1, dtype=I32, device=device),
                   winner=torch.zeros((W, N), dtype=torch.bool, device=device))


def _color(batch: State, contacts: Contacts, config: SimConfig):
    """Per world: contact and joint colors and their body maps, as the JAX
    `step` makes them (step.py:310-457): incremental colors that the
    tables carry, or with `incremental_coloring=False` a fresh MIS
    coloring each step that the tables do not keep; a statically skipped
    kind keeps its carried colors and gets an inert map. Returns
    (contacts, joints, Colors, overflow [W])."""
    bodies, joints = batch.bodies, batch.joints
    W = bodies.type.shape[0]
    B = config.max_bodies
    dev = bodies.type.device
    dyn = (bodies.type == 2) & bodies.alive
    touching = contacts.alive & (contacts.point_count > 0)
    incremental = config.incremental_coloring
    zero = torch.zeros(W, dtype=I32, device=dev)

    def colors_of(carried, body_a, body_b, active, K):
        """(color, overflow, active colored constraints, color the table keeps)."""
        if not incremental:
            color, overflow = coloring.color_graph(body_a, body_b, active, dyn, B, K)
            return color, overflow, active, carried
        color, overflow = coloring.assign_colors(carried, body_a, body_b, active, dyn, B, K,
                                                 rounds=config.color_rounds, bucket_cap=0)
        return color, overflow, active & (color >= 0), color

    ccolor, c_overflow, c_kept = contacts.color, zero, contacts.color
    if config.solve_contacts:
        ccolor, c_overflow, c_active, c_kept = colors_of(
            contacts.color, contacts.body_a, contacts.body_b, touching, config.max_colors)
        cmap = make_body_map(contacts.body_a, contacts.body_b, ccolor, c_active, dyn, B, config.max_colors)
        c_overflow = c_overflow + (c_active & ~cmap.winner).sum(dim=1)
    else:
        cmap = _inert_map(W, B, config.max_colors, config.max_contacts, dev)

    jcolor, j_overflow, j_kept = joints.color, zero, joints.color
    if config.solve_joints:
        jcolor, j_overflow, j_active, j_kept = colors_of(
            joints.color, joints.body_a, joints.body_b, joints.alive, config.joint_max_colors)
        # mouse joints never write body A
        jmap = make_body_map(joints.body_a, joints.body_b, jcolor, j_active, dyn, B, config.joint_max_colors,
                             write_a_extra=joints.type != 1)
    else:
        jmap = _inert_map(W, B, config.joint_max_colors, config.max_joints, dev)

    colors = Colors(ccolor, cmap, jcolor, jmap)
    return (dataclasses.replace(contacts, color=c_kept), dataclasses.replace(joints, color=j_kept), colors,
            c_overflow + j_overflow)


class Prepared(NamedTuple):
    """What the per-world step's fused route has made of a batch before
    its solve."""

    contacts: Contacts
    joints: Joints
    x: FusedInputs  # the inputs the step hands the fused solve (K1)
    cons: ContactCons
    jcons: JointCons
    pairs: broadphase.PairResult
    sbt: torch.Tensor
    touching: torch.Tensor
    overflow: torch.Tensor


def prepare(batch: State, dt: float, config: SimConfig) -> Prepared:
    """The per-world step's fused route up to its solve: pairs,
    narrowphase, colors and body maps, the prepared constraints and the
    fused solve's inputs."""
    assert use_fused(config), "prepare is the fused route's (use_fused_solver)"
    contacts, pairs, sbt = _pre_solve(batch, config)
    touching = contacts.alive & (contacts.point_count > 0)
    contacts, joints, colors, overflow = _color(batch, contacts, config)
    dt_t = torch.tensor(float(dt), dtype=torch.float32, device=batch.gravity.device)
    x, cons, jcons = prepare_fused(batch.bodies, contacts, joints, *colors[:4], batch.gravity, dt_t, config)
    return Prepared(contacts, joints, x, cons, jcons, pairs, sbt, touching, overflow)


def _supported(batch: State, config: SimConfig):
    """Refuses what the reference does not copy of the port's step."""
    if config.lane_solve:
        raise NotImplementedError("the reference has no lane step (freeze with lane_solve=False)")
    if sticky_width(batch.contacts):
        raise NotImplementedError("the reference has no TGS_Sticky friction anchors")
    if not use_fused(config) and (config.contact_bucket_cap > 0 or config.joint_bucket_cap > 0):
        raise NotImplementedError("the reference has only the dense layout of the XLA route")


def step(batch: State, dt: float, config: SimConfig) -> State:
    """One step of every world of a [W, ...] batch, each on its own (the
    JAX `step` vmapped over worlds), through the fused solve (K1's plain
    twin) or the XLA solver (`config.use_fused`). Runs on the batch's
    device."""
    _supported(batch, config)
    if use_fused(config):
        p = prepare(batch, dt, config)
        new_bodies, contacts, joints = solve_prepared(
            batch.bodies, p.contacts, p.joints, p.x, p.cons, p.jcons, config
        )
        return _post_solve(
            batch, new_bodies, contacts, joints, p.pairs.count, p.pairs.overflow, p.sbt, p.touching, p.overflow,
        )
    contacts, pairs, sbt = _pre_solve(batch, config)
    touching = contacts.alive & (contacts.point_count > 0)
    contacts, joints, colors, overflow = _color(batch, contacts, config)
    dt_t = torch.tensor(float(dt), dtype=torch.float32, device=batch.gravity.device)
    new_bodies, contacts, joints = solve_xla(batch.bodies, contacts, joints, colors, batch.gravity, dt_t, config)
    return _post_solve(batch, new_bodies, contacts, joints, pairs.count, pairs.overflow, sbt, touching, overflow)
