"""One step of a world batch: the lane-batched step and the per-world step.

Ports of the JAX package's `step.py` (reference pipeline:
src/world.c:120-306). Both run on a batch with a leading worlds dim.

`step_batch`, the lane branch of the JAX `step_batch`, for a lockstep batch:
1. broadphase on world 0 (the grid, or the sweep and prune with
   `broadphase="sap"`), then the persistent contact match whose slot
   layout every world shares (`ops/broadphase.py`);
2. the narrowphase of every (world, contact) through K2
   (`ops/narrow_cuda.py`), then warm-start id matching (`_apply_manifolds`);
3. coloring and color buckets of world 0's contact graph
   (`solvers/lane_solve.build_lane_structure`);
4. the soft contact solve with worlds in lanes (`solvers/lane_solve`);
5. AABB and fat-AABB update and diagnostics (`_post_solve`).
Two behaviours of the JAX lane path are reproduced as they are: the
per-world `mismatch` adds on top of world 0's shared overflow in
`color_overflow`, and world 0's gravity and shape geometry serve every world.

`step`, the JAX `step` vmapped over worlds (`parallel.batch`): each world
has its own pairs (`find_pairs_grid` or `find_pairs`, `match_contacts`),
its narrowphase through K2 with the worlds flattened into one lane batch
(`update_manifolds`; skipped with `solve_contacts=False`), its own contact
and joint colors (incremental, or a per-step MIS coloring with
`incremental_coloring=False`) and body maps (and, on the bucketed layout,
its color buckets), then one of two solve routes (`config.use_fused`):
- fused: the soft solve of contacts and soft revolute and mouse joints in
  one launch of K1 (`solvers/loops.solve_prepared`), in the script of
  `config.solver`: TGS_Soft, SoftStep or PGS_Soft;
- XLA: the JAX package's XLA solver of `config.solver`, any of the ten
  (`solvers/loops.SOLVERS`), colored passes in plain PyTorch, dense or
  color-bucketed (`contact_bucket_cap`, `joint_bucket_cap`), replayed from
  a CUDA graph on the card (`solvers/graphs.py`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import BUCKETABLE_SOLVERS, SPECULATIVE_DISTANCE, SimConfig, use_fused
from .ops import broadphase, coloring
from .ops.geometry import compute_aabbs
from .ops.manifold import ManifoldOut, from_lanes, geom_rows
from .ops.narrow_cuda import collide
from .solvers.common import BodyMap, ContactCons, make_body_map
from .solvers.fused_solve import FusedInputs
from .solvers.joints import JointCons
from .solvers.lane_solve import build_lane_structure, lane_solve
from .solvers.loops import Colors, prepare_fused, solve_prepared, solve_xla
from .state import Contacts, Diagnostics, Joints, State, sticky_width

# the JAX package's narrowphase names, which compute the same math: the
# port runs K2 for each
NARROWPHASES = ("xla", "lanes", "pallas")

I32 = torch.int32


def _apply_manifolds(contacts: Contacts, out: ManifoldOut) -> Contacts:
    """Warm-start id matching and the manifold table update (reference:
    src/contact.c:328-358): a new point whose feature id equals a live old
    point's takes that point's impulses, and on TGS_Sticky's table its
    friction anchors; the anchors persist where the point count is kept
    and every new point matched."""
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

    sticky = {}
    if sticky_width(contacts):
        m2 = matched[..., None]

        def take2(old):  # [..., 2, 2] fields
            return torch.where(second[..., None], old[..., 1:2, :], old[..., 0:1, :])

        sticky = {
            k: torch.where(m2, take2(getattr(contacts, k)), getattr(contacts, k))
            for k in ("friction_normal_a", "friction_normal_b", "friction_anchor_a", "friction_anchor_b")
        }
        sticky["friction_persisted"] = (
            (new_count == contacts.point_count) & (matched | ~new_pmask).all(-1) & alive
        )

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
        **sticky,
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


def narrow_inputs(batch: State, contacts: Contacts):
    """K2's inputs for a lockstep batch: world 0's shape table [S, 34],
    the shared shape indices, and each world's endpoint poses [W, 4, C] and
    GJK caches [W, 7, C]."""
    geom = _geom_table(batch.shapes.map(lambda x: x[0])).contiguous()
    pose = torch.cat([batch.bodies.origin, batch.bodies.rot], dim=-1)  # [W, B, 4]
    pa = pose[:, contacts.body_a[0]].transpose(1, 2).contiguous()
    pb = pose[:, contacts.body_b[0]].transpose(1, 2).contiguous()
    return geom, contacts.shape_a[0].contiguous(), contacts.shape_b[0].contiguous(), pa, pb, _cache(contacts)


def update_manifolds_lane(batch: State, contacts: Contacts, config: SimConfig) -> Contacts:
    """The narrowphase of a lockstep batch through K2, then id matching."""
    out = from_lanes(*collide(*narrow_inputs(batch, contacts), config.gjk_iters))
    return _apply_manifolds(contacts, out)


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


def step_batch(batch: State, dt: float, config: SimConfig) -> State:
    """One step of a lockstep [W, ...] batch: pairing, coloring and the
    solve structure come from world 0 and are shared; worlds whose fat AABBs
    differ from world 0's get `diag.pair_overflow` raised. Runs on the
    batch's device."""
    assert config.lane_solve, "step_batch is the lane-batched step (freeze with lane_solve=True)"
    W = batch.bodies.type.shape[0]
    bodies0 = batch.bodies.map(lambda x: x[0])
    shapes0 = batch.shapes.map(lambda x: x[0])
    joints0 = batch.joints.map(lambda x: x[0])
    S = shapes0.body.shape[0]
    B = bodies0.type.shape[0]
    sbt0 = torch.where(
        shapes0.alive, bodies0.type[broadphase.wrap_index(shapes0.body, B)], 0
    )
    pairs0 = broadphase.find_pairs_by(
        shapes0, bodies0.type, broadphase.jointed_body_keys(joints0, config), config
    )
    diverged = (batch.shapes.fat_aabb != batch.shapes.fat_aabb[0:1]).reshape(W, S * 4).any(dim=1)

    contacts = broadphase.match_contacts_lane(batch.contacts, pairs0, shapes0)
    contacts = update_manifolds_lane(batch, contacts, config)

    dyn0 = (bodies0.type == 2) & bodies0.alive
    struct = build_lane_structure(contacts, dyn0, config)
    contacts = dataclasses.replace(contacts, color=struct.ccolor[None].expand(W, -1).contiguous())

    dt_t = torch.tensor(float(dt), dtype=torch.float32, device=batch.gravity.device)
    new_bodies, contacts, mismatch = lane_solve(
        batch.bodies, contacts, struct, batch.gravity[0], dt_t, config
    )
    touching = contacts.alive & (contacts.point_count > 0)
    return _post_solve(
        batch, new_bodies, contacts, batch.joints, pairs0.count.expand(W), pairs0.overflow | diverged,
        sbt0[None].expand(W, -1), touching, struct.shared_overflow + mismatch,
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


def _buckets(color, active, body_a, body_b, dyn, K, cap, B, write_a_extra=None):
    """A kind's color buckets per world and the body map of its bucketed
    rows. Returns (bucket, new color, body map, overflow [W]): the
    constraints past a color's cap and the active rows that lost the map."""
    bucket, color, drop = coloring.build_color_buckets(color, active, K, cap)
    W = color.shape[0]
    worlds = torch.arange(W, device=color.device)[:, None]
    bi = torch.clamp(bucket, min=0)
    active_b = active[worlds, bi] & (bucket >= 0)
    color_b = torch.arange(K, dtype=I32, device=color.device).repeat_interleave(cap).expand(W, -1)
    extra = None if write_a_extra is None else write_a_extra[worlds, bi]
    bmap = make_body_map(body_a[worlds, bi], body_b[worlds, bi], color_b, active_b, dyn, B, K, write_a_extra=extra)
    return bucket, color, bmap, drop + (active_b & ~bmap.winner).sum(dim=1)


def _color(batch: State, contacts: Contacts, config: SimConfig):
    """Per world: contact and joint colors and their body maps, as the JAX
    `step` makes them (step.py:310-457): incremental colors that the
    tables carry, or with `incremental_coloring=False` a fresh MIS
    coloring each step that the tables do not keep; a statically skipped
    kind keeps its carried colors and gets an inert map; on the XLA route
    a kind with a bucket cap (incremental colors only) gets its color
    buckets, whose dropped rows and map losers count as overflow. Returns
    (contacts, joints, Colors, overflow [W])."""
    bodies, joints = batch.bodies, batch.joints
    W = bodies.type.shape[0]
    B = config.max_bodies
    dev = bodies.type.device
    dyn = (bodies.type == 2) & bodies.alive
    touching = contacts.alive & (contacts.point_count > 0)
    fused = use_fused(config)
    incremental = config.incremental_coloring
    bucketed = (config.contact_bucket_cap > 0 and config.solver in BUCKETABLE_SOLVERS and not fused
                and config.solve_contacts and incremental)
    jbucketed = config.joint_bucket_cap > 0 and not fused and config.solve_joints and incremental
    zero = torch.zeros(W, dtype=I32, device=dev)
    bucket = jbucket = None

    def colors_of(carried, body_a, body_b, active, K, cap):
        """(color, overflow, active colored constraints, color the table keeps)."""
        if not incremental:
            color, overflow = coloring.color_graph(body_a, body_b, active, dyn, B, K)
            return color, overflow, active, carried
        color, overflow = coloring.assign_colors(carried, body_a, body_b, active, dyn, B, K,
                                                 rounds=config.color_rounds, bucket_cap=cap)
        return color, overflow, active & (color >= 0), color

    ccolor, c_overflow, c_kept = contacts.color, zero, contacts.color
    if config.solve_contacts:
        ccolor, c_overflow, c_active, c_kept = colors_of(
            contacts.color, contacts.body_a, contacts.body_b, touching, config.max_colors,
            config.contact_bucket_cap if bucketed else 0,
        )
        if bucketed:
            bucket, ccolor, cmap, c_drop = _buckets(
                ccolor, c_active, contacts.body_a, contacts.body_b, dyn, config.max_colors,
                config.contact_bucket_cap, B,
            )
            c_kept = ccolor
        else:
            cmap = make_body_map(contacts.body_a, contacts.body_b, ccolor, c_active, dyn, B, config.max_colors)
            c_drop = (c_active & ~cmap.winner).sum(dim=1)
        c_overflow = c_overflow + c_drop
    else:
        cmap = _inert_map(W, B, config.max_colors, config.max_contacts, dev)

    jcolor, j_overflow, j_kept = joints.color, zero, joints.color
    if config.solve_joints:
        jcolor, j_overflow, j_active, j_kept = colors_of(
            joints.color, joints.body_a, joints.body_b, joints.alive, config.joint_max_colors,
            config.joint_bucket_cap if jbucketed else 0,
        )
        # mouse joints never write body A
        not_mouse = joints.type != 1
        if jbucketed:
            jbucket, jcolor, jmap, j_drop = _buckets(
                jcolor, j_active, joints.body_a, joints.body_b, dyn, config.joint_max_colors,
                config.joint_bucket_cap, B, write_a_extra=not_mouse,
            )
            j_overflow = j_overflow + j_drop
            j_kept = jcolor
        else:
            jmap = make_body_map(joints.body_a, joints.body_b, jcolor, j_active, dyn, B, config.joint_max_colors,
                                 write_a_extra=not_mouse)
    else:
        jmap = _inert_map(W, B, config.joint_max_colors, config.max_joints, dev)

    colors = Colors(ccolor, cmap, jcolor, jmap, bucket, jbucket)
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


def step(batch: State, dt: float, config: SimConfig) -> State:
    """One step of every world of a [W, ...] batch, each on its own (the
    JAX `step` vmapped over worlds), through the fused solve (K1) or the
    XLA solvers (`config.use_fused`). Runs on the batch's device."""
    assert not config.lane_solve, "step is the per-world step (freeze with lane_solve=False)"
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


_STEP_CACHE: dict = {}


def make_step(config: SimConfig):
    """step(batch, dt) for `config`, memoised per config (as the JAX
    package's `make_step`, without its jit): `step_batch` under
    `config.lane_solve`, else the per-world `step`."""
    f = _STEP_CACHE.get(config)
    if f is None:
        fn = step_batch if config.lane_solve else step

        def f(batch: State, dt: float) -> State:
            return fn(batch, dt, config)

        f = _STEP_CACHE.setdefault(config, f)
    return f


def run(state: State, config: SimConfig, steps: int, dt=1.0 / 60.0) -> State:
    """`steps` steps of a [W, ...] batch (`make_step(config)` in a loop)."""
    f = make_step(config)
    for _ in range(steps):
        state = f(state, dt)
    return state
