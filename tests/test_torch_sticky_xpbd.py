"""TGS_Sticky and XPBD on the per-world step's XLA route, the sweep-and-prune
broadphase and the per-step MIS coloring, against the JAX package on the
CPU, op by op under `jax.disable_jit()`.

- Steps: 3 steps of the port's `batched_step` on two worlds that differ in
  their initial velocities, against the JAX per-world `step`
  (`use_pallas_solver=False`) on one of them: TGS_Sticky and XPBD on the
  base-3 pyramid and on the 4-plank Bridge with its mouse joint, each
  frozen under its solver (so that TGS_Sticky's friction anchors have the
  contact table's width in both packages); XPBD bucketed on the pyramid
  and joint-bucketed on the Bridge; TGS_Sticky with a contact bucket cap
  (its contacts stay dense). One step each of `broadphase="sap"` and of
  `incremental_coloring=False` on the pyramid under PGS_NGS_Block.
- Pieces on seeded inputs: the sticky carry through `match_contacts` and
  `_apply_manifolds` on a batch with as many worlds as contact slots;
  `prepare_sticky` and `sticky_velocity_pass`; the XPBD contact passes
  (dense and bucketed); `xpbd_apply` and the mouse-only joint solve;
  `find_pairs` (window overflow included); `color_graph` (overflow
  included); the fallback to the MIS coloring above 30 colors.

Integers are equal; floats are held to `torch_parity.WORLD_TOL` in the
steps and are equal bit for bit in the pieces. The step cases use the
settings of tests/test_torch_xla_solvers.py (`SCENE_KW`).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models.contact_scenes import pyramid_world as jax_pyramid
from solver2d_tpu.ops import broadphase as jbp
from solver2d_tpu.ops import coloring as jcol
from solver2d_tpu.ops import math2d as jm
from solver2d_tpu.ops.manifold import ManifoldOut as JManifoldOut
from solver2d_tpu.solvers import contact_kernels as jck
from solver2d_tpu.solvers import joints as jjk
from solver2d_tpu.solvers.common import BodyMap as JBodyMap
from solver2d_tpu.solvers.common import ContactCons as JCons
from solver2d_tpu.state import Contacts as JContacts
from solver2d_tpu.step import _apply_manifolds as jax_apply_manifolds
from solver2d_tpu.step import step as jax_step
from solver2d_tpu_torch import SolverType, batched_step, pyramid_world, state_from_numpy
from solver2d_tpu_torch.ops import broadphase as pbp
from solver2d_tpu_torch.ops import coloring as pcol
from solver2d_tpu_torch.ops import math2d as pm
from solver2d_tpu_torch.solvers import contact_kernels as pck
from solver2d_tpu_torch.solvers import joints as pjk
from solver2d_tpu_torch.solvers.common import ContactCons
from solver2d_tpu_torch.state import Contacts, Joints, Shapes, from_numpy, to_numpy
from solver2d_tpu_torch.step import ManifoldOut, _apply_manifolds
from test_torch_broadphase import _batch, _scene
from test_torch_coloring import _graph
from test_torch_joints import H, INV_H, _equal, _prepare
from test_torch_xla_solvers import SCENE_KW, _check_scene, _pair_world, _rot
from torch_parity import (
    DT, WORLD_TOL, assert_tree_close, jax_world_scene, jax_worlds, np_tree, port_config, stack,
)

torch.set_num_threads(1)
EXACT = dict(rtol=0, atol=0)


def _t(x):
    return torch.from_numpy(np.array(x))[None]


# ------------------------------------------------------------------ steps


@pytest.mark.parametrize("solver", ["TGS_STICKY", "XPBD"])
@pytest.mark.parametrize("scene", ["pyramid", "bridge"])
def test_step_matches_jax(scene, solver):
    """3 steps, the sticky fields compared with the rest of the state."""
    batch = _check_scene(scene, solver, world=1)
    persisted = batch.contacts.friction_persisted
    if solver == "TGS_STICKY":
        assert persisted.shape == batch.contacts.alive.shape
        if scene == "pyramid":
            assert bool(persisted[1].any())  # anchors carried from step to step
    else:
        assert persisted.shape == (2, 0)


def test_xpbd_bucketed_step_matches_jax():
    """XPBD's contact projections on the bucket layout: 5 colors of 8 rows."""
    _check_scene("pyramid", "XPBD", world=0, contact_bucket_cap=8)


def test_xpbd_joint_bucketed_step_matches_jax():
    """XPBD's joint projection and mouse solve on the joint buckets."""
    _check_scene("bridge", "XPBD", world=1, joint_bucket_cap=4)


def test_sticky_keeps_contacts_dense():
    """TGS_Sticky prepares its friction anchors in slot order: a contact
    bucket cap leaves its contacts dense, as in the JAX step."""
    _check_scene("pyramid", "TGS_STICKY", world=0, contact_bucket_cap=8)


@pytest.mark.parametrize("kw", [dict(broadphase="sap"), dict(incremental_coloring=False)], ids=["sap", "mis"])
def test_secondary_path_step_matches_jax(kw):
    """One step on the pyramid under PGS_NGS_Block, the JAX package's
    default solver, with the sweep and prune or with the MIS coloring (at
    5 colors it leaves 2 contacts of a world in its last color, on both
    sides); the diagnostics are compared with the state."""
    jstate, jcfg = jax_world_scene("pyramid", "PGS_NGS_BLOCK")
    jcfg = jcfg.replace(**SCENE_KW["pyramid"], **kw)
    worlds = jax_worlds(jstate, 2)
    batch = state_from_numpy(stack(worlds), device="cpu")
    cfg = port_config(jcfg).replace(use_fused_solver=False)
    with jax.disable_jit():
        ref = jax_step(worlds[1], jnp.float32(DT), jcfg)
    batch = batched_step(cfg)(batch, DT)
    got = {g: {k: v[1] for k, v in d.items()} for g, d in to_numpy(batch).items() if isinstance(d, dict)}
    assert_tree_close(got, np_tree(ref), WORLD_TOL["pyramid"])
    assert int(batch.diag.contact_count[1]) == 12 and not bool(batch.diag.pair_overflow.any())
    if "incremental_coloring" in kw:
        # the MIS colors are not kept by the table
        assert int(batch.diag.color_overflow[1]) == 2 and bool((batch.contacts.color == -1).all())


def test_mis_fallback_above_30_colors():
    """Both packages freeze max_colors=32 onto the MIS coloring with the
    same warning; the configs agree on every shared field."""
    with pytest.warns(UserWarning, match="falling back to per-step MIS coloring"):
        _, jcfg = jax_pyramid(JSolver.PGS_NGS_BLOCK, 3)[0].freeze(max_colors=32)
    with pytest.warns(UserWarning, match="falling back to per-step MIS coloring"):
        state, cfg = pyramid_world(SolverType.PGS_NGS_BLOCK, 3)[0].freeze(device="cpu", lane_solve=False,
                                                                           max_colors=32)
    assert not jcfg.incremental_coloring and not cfg.incremental_coloring
    for k in cfg.__dataclass_fields__:
        if hasattr(jcfg, k) and k != "lane_solve":
            assert getattr(cfg, k) == getattr(jcfg, k), k
    out = batched_step(cfg)(state.map(lambda x: x[None]), DT)
    assert int(out.diag.color_overflow[0]) == 0


# ------------------------------------------------------------ the carry


INT32_MAX = np.iinfo(np.int32).max


def _keys(rng, C, S, taken=()):
    """C sorted pair keys a * S + b (a < b): those of `taken` first, then
    random ones, the last slot empty."""
    every = np.array([a * S + b for a in range(S) for b in range(a + 1, S)], np.int32)
    fresh = rng.choice(np.setdiff1d(every, taken), size=C - 1 - len(taken), replace=False)
    return np.concatenate([np.sort(np.concatenate([taken, fresh])), [INT32_MAX]]).astype(np.int32)


def _sticky_table(rng, key, S, sticky=True):
    """A JAX contact table of the pair keys `key` among S shapes with
    random carried values."""
    C = key.shape[0]

    def r(*shape):
        return jnp.asarray(rng.normal(size=(C,) + shape).astype(np.float32))

    def ri(lo, hi, *shape):
        return jnp.asarray(rng.randint(lo, hi, size=(C,) + shape).astype(np.int32))

    filled = key != INT32_MAX
    kw = dict(
        key=jnp.asarray(key), shape_a=jnp.asarray(np.where(filled, key // S, 0).astype(np.int32)),
        shape_b=jnp.asarray(np.where(filled, key % S, 0).astype(np.int32)), normal=r(2), anchor_a=r(2, 2),
        anchor_b=r(2, 2), separation=r(2), normal_impulse=r(2), tangent_impulse=r(2), point_id=ri(0, 3, 2),
        persisted=jnp.asarray(rng.rand(C, 2) < 0.5), point_count=ri(0, 3), cache_count=ri(0, 4),
        cache_index_a=ri(0, 8, 3), cache_index_b=ri(0, 8, 3), color=ri(-1, 5),
        alive=jnp.asarray(filled & (rng.rand(C) < 0.9)),
    )
    if sticky:
        kw.update(friction_normal_a=r(2, 2), friction_normal_b=r(2, 2), friction_anchor_a=r(2, 2),
                  friction_anchor_b=r(2, 2), friction_persisted=jnp.asarray(rng.rand(C) < 0.5))
    return dataclasses.replace(JContacts.zeros(C, sticky=sticky), **kw)


@pytest.mark.parametrize("sticky", [True, False])
def test_sticky_carry_matches_jax(sticky):
    """`match_contacts` and `_apply_manifolds` on a batch of W == C worlds,
    each with its own seeded old table, new pairs and manifolds: each world
    equal to the JAX functions on its own. The carry is keyed on the
    contact axis: a zero-width (not TGS_Sticky) table passes through."""
    C = W = 6
    rng = np.random.RandomState(21 + sticky)
    jstate, _ = jax_pyramid(JSolver.TGS_STICKY, 3)[0].freeze()
    S = jstate.shapes.alive.shape[0]
    shapes = dataclasses.replace(jstate.shapes, friction=jnp.asarray(rng.uniform(0.1, 1, S).astype(np.float32)),
                                 body=jnp.asarray(rng.randint(0, 6, S).astype(np.int32)))
    olds, news, outs, refs = [], [], [], []
    for _ in range(W):
        okey = _keys(rng, C, S)
        old = _sticky_table(rng, okey, S, sticky)
        # half of the new table's pairs are old ones
        nkey = _keys(rng, C, S, okey[: C // 2])
        nfill = nkey != INT32_MAX
        pairs = jbp.PairResult(jnp.asarray(np.where(nfill, nkey // S, 0).astype(np.int32)),
                               jnp.asarray(np.where(nfill, nkey % S, 0).astype(np.int32)), jnp.asarray(nkey),
                               jnp.asarray(nfill), jnp.int32(nfill.sum()), jnp.asarray(False))
        out = JManifoldOut(
            normal=jnp.asarray(rng.normal(size=(C, 2)).astype(np.float32)),
            anchor_a=jnp.asarray(rng.normal(size=(C, 2, 2)).astype(np.float32)),
            anchor_b=jnp.asarray(rng.normal(size=(C, 2, 2)).astype(np.float32)),
            separation=jnp.asarray(rng.normal(size=(C, 2)).astype(np.float32)),
            point_id=jnp.asarray(rng.randint(0, 3, (C, 2)).astype(np.int32)),
            point_count=jnp.asarray(rng.randint(0, 3, C).astype(np.int32)),
            cache_count=jnp.asarray(rng.randint(0, 4, C).astype(np.int32)),
            cache_ia=jnp.asarray(rng.randint(0, 8, (C, 3)).astype(np.int32)),
            cache_ib=jnp.asarray(rng.randint(0, 8, (C, 3)).astype(np.int32)),
        )
        with jax.disable_jit():
            matched = jbp.match_contacts(old, pairs, shapes, jstate.bodies.type, shapes.body)
            refs.append(jax_apply_manifolds(matched, out))
        olds.append(old)
        news.append(pairs)
        outs.append(out)
    p_old = from_numpy(Contacts, stack(olds), "cpu")
    p_pairs = pbp.PairResult(*(torch.from_numpy(np.array(x)) for x in stack(news)))
    p_shapes = from_numpy(Shapes, stack([shapes] * W), "cpu")
    p_out = ManifoldOut(*(torch.from_numpy(np.array(x)) for x in stack(outs)))
    got = _apply_manifolds(pbp.match_contacts(p_old, p_pairs, p_shapes), p_out)
    for w in range(W):
        assert_tree_close({k: v[w] for k, v in to_numpy(got).items()}, np_tree(refs[w]), EXACT)
    if sticky:
        persisted = got.friction_persisted
        assert bool(persisted.any()) and not bool(persisted.all())
        assert not torch.equal(got.friction_anchor_a, p_old.friction_anchor_a)
    else:
        assert got.friction_anchor_a.shape == (W, 0, 2, 2)


# ----------------------------------------------------------- TGS_Sticky


def _sticky_inputs(seed, C=128):
    """Seeded dense contacts, constraint i between bodies 2i and 2i+1: half
    of them with stored friction anchors that hold (the stored normals and
    anchors agree with the bodies' poses: both points' anchors are apart
    along the tangent only), the others reset."""
    rng, f, fields, bs, ia, ib, slot = _pair_world(seed, C)
    B = 2 * C
    rot = _rot(rng, B)
    position = f(B, 2)
    qA, qB = rot[ia], rot[ib]
    normal = fields["normal"]
    tangent = np.stack([normal[:, 1], -normal[:, 0]], -1)

    def rotate(q, v):
        return np.stack([q[..., 1] * v[..., 0] - q[..., 0] * v[..., 1], q[..., 0] * v[..., 0] + q[..., 1] * v[..., 1]], -1)

    def inv_rotate(q, v):
        return np.stack([q[..., 1] * v[..., 0] + q[..., 0] * v[..., 1], -q[..., 0] * v[..., 0] + q[..., 1] * v[..., 1]], -1)

    hold = rng.rand(C) < 0.5
    la, lb = fields["local_anchor_a"], fields["local_anchor_b"]
    rA = rotate(qA[:, None], la)
    rB0 = rotate(qB, lb[:, 0])
    # body B placed so that both points' anchors differ along the tangent
    cB = position[ia] + rA[:, 0] - rB0 + 0.3 * tangent
    position[ib] = np.where(hold[:, None], cB, position[ib])
    rB1 = rA[:, 1] - (cB - position[ia]) + 0.1 * tangent
    lb = lb.copy()
    lb[:, 1] = np.where(hold[:, None], inv_rotate(qB, rB1), lb[:, 1])
    fields["local_anchor_b"] = lb.astype(np.float32)
    anchor_a, anchor_b = f(C, 2, 2), f(C, 2, 2)
    n2 = np.broadcast_to(normal[:, None], (C, 2, 2))
    contacts = dict(
        anchor_a=anchor_a, anchor_b=anchor_b,
        friction_normal_a=np.where(hold[:, None, None], inv_rotate(qA[:, None], n2), f(C, 2, 2)).astype(np.float32),
        friction_normal_b=np.where(hold[:, None, None], inv_rotate(qB[:, None], n2), f(C, 2, 2)).astype(np.float32),
        friction_anchor_a=np.where(hold[:, None, None], anchor_a, f(C, 2, 2)).astype(np.float32),
        friction_anchor_b=np.where(hold[:, None, None], anchor_b, f(C, 2, 2)).astype(np.float32),
        friction_persisted=hold | (rng.rand(C) < 0.3),
    )
    return rng, f, fields, bs, ia, ib, slot, position.astype(np.float32), rot, contacts, hold


def test_sticky_prepare_and_pass_match_jax():
    """`prepare_sticky` (confirmed and reset anchors) and one sticky
    velocity pass with and without its bias, whose friction clamps clear
    `friction_persisted` where the contact is kept: equal."""
    C = 128
    rng, f, fields, bs, ia, ib, slot, position, rot, contacts, hold = _sticky_inputs(31, C)
    n, t = np.abs(f(C, 2)), f(C, 2, scale=0.2)
    winner = rng.rand(C) < 0.9
    jcons = JCons(ia=jnp.asarray(ia), ib=jnp.asarray(ib), **{k: jnp.asarray(v) for k, v in fields.items()})
    jcontacts = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in contacts.items()})
    pcons = ContactCons(**{k: _t(v) for k, v in fields.items()})
    pcontacts = types.SimpleNamespace(**{k: _t(v) for k, v in contacts.items()})
    with jax.disable_jit():
        jprep = jck.prepare_sticky(jnp.asarray(position), jcontacts, jcons, jnp.asarray(rot))
    pprep = pck.prepare_sticky(_t(position), _t(rot), pcontacts, pcons, _t(ia), _t(ib))
    for g, r in zip(pprep[:4] + tuple(pprep[4]), jprep[:4] + tuple(jprep[4])):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    kept = (np.asarray(jprep[4][2]) == contacts["friction_anchor_a"]).all((1, 2)) & fields["active"]
    assert kept.any() and (fields["active"] & ~kept).any()  # confirmed and reset anchors

    bmap = JBodyMap(slot=jnp.asarray(slot)[:, None], winner=jnp.asarray(winner))
    for use_bias in (True, False):
        carry = (jnp.asarray(bs), jnp.asarray(n), jnp.asarray(t), jnp.ones(C, bool))
        with jax.disable_jit():
            ref = jck.sticky_velocity_pass(carry, 0, jcons, *jprep[:4], jnp.float32(INV_H), use_bias,
                                           jnp.zeros(C, jnp.int32), bmap)
        got = pck.sticky_velocity_pass(
            (_t(bs), _t(n), _t(t), torch.ones((1, C), dtype=torch.bool)), pcons, _t(ia), _t(ib), *pprep[:4],
            torch.tensor(INV_H), use_bias, _t(slot), pcons.active & _t(winner),
        )
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
        cleared = ~np.asarray(ref[3])
        assert cleared.any() and not cleared.all() and not cleared[~(fields["active"] & winner)].any()


# ------------------------------------------------------------------ XPBD


@pytest.mark.parametrize("layout", ["dense", "direct"])
def test_xpbd_contact_passes_match_jax(layout):
    """The XPBD position then velocity pass on seeded constraints: dense
    (color 1 of 3, through the body map) or in the bucketed `direct=` form:
    equal."""
    C = 128
    rng, f, fields, bs, ia, ib, slot = _pair_world(32, C)
    n, t = np.abs(f(C, 2)), f(C, 2, scale=0.2)
    winner = rng.rand(C) < 0.9
    color = rng.randint(0, 3, C).astype(np.int32)
    jcons = JCons(ia=jnp.asarray(ia), ib=jnp.asarray(ib), **{k: jnp.asarray(v) for k, v in fields.items()})
    pcons = ContactCons(**{k: _t(v) for k, v in fields.items()})
    h, inv_h = jnp.float32(H), jnp.float32(INV_H)
    if layout == "dense":
        bmap = JBodyMap(slot=jnp.asarray(np.stack([slot] * 3, 1)), winner=jnp.asarray(winner))
        jkw = dict(color=jnp.asarray(color), bmap=bmap)
        upd = pcons.active & _t(winner) & (_t(color) == 1)
    else:
        jkw = dict(color=None, bmap=None, direct=(jnp.asarray(slot), jnp.asarray(winner)))
        upd = pcons.active & _t(winner)
    with jax.disable_jit():
        jp = jck.xpbd_position_pass((jnp.asarray(bs), jnp.asarray(n), jnp.asarray(t)), 1, jcons, h, **jkw)
        jv = jck.xpbd_velocity_pass(jp, 1, jcons, h, inv_h, **jkw)
    pp = pck.xpbd_position_pass((_t(bs), _t(n), _t(t)), pcons, _t(ia), _t(ib), torch.tensor(H), _t(slot), upd)
    pv = pck.xpbd_velocity_pass(pp, pcons, _t(ia), _t(ib), torch.tensor(INV_H), _t(slot), upd)
    for g, r in zip(pp + pv, jp + jv):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    assert not np.array_equal(np.asarray(jp[1]), n) and not np.array_equal(np.asarray(jv[2]), np.asarray(jp[2]))


def test_xpbd_joint_projection_and_mouse_solve_match_jax():
    """`xpbd_apply` on the seeded joints of tests/test_torch_joints.py, and
    their rigid velocity solve restricted to the mouse joints
    (`only_mouse`): equal."""
    (jcons, jimp), (pcons, pimp), s = _prepare(5)
    rng = np.random.RandomState(5)
    B, J = 12, pcons.active.shape[1]
    bs = np.concatenate([rng.normal(size=(B, 3)), rng.normal(size=(B, 2)) * 0.05, _rot(rng, B), np.zeros((B, 1))],
                        -1).astype(np.float32)
    slot = rng.randint(-1, J, B).astype(np.int32)
    with jax.disable_jit():
        ref = jjk.xpbd_apply(jnp.asarray(bs), jcons, jnp.float32(INV_H), jnp.asarray(slot))
    got = pjk.xpbd_apply(_t(bs), pcons, _t(np.asarray(jcons.ia)), _t(np.asarray(jcons.ib)), _t(slot))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    assert not np.array_equal(np.asarray(ref), bs)

    args = [s[k] for k in ("vA", "wA", "vB", "wB", "qA", "qB", "dcA", "dcB")]
    with jax.disable_jit():
        ref = jjk.solve_joint_core(jcons, *map(jnp.asarray, args), jimp, "rigid", jnp.float32(H), jnp.float32(INV_H),
                                   True, True, True)
    got = pjk.solve_joint_core(pcons, *(torch.from_numpy(a)[None] for a in args), pimp, torch.tensor(H),
                               torch.tensor(INV_H), True, True, mode="rigid", only_mouse=True)
    for i, name in enumerate(("vA", "wA", "vB", "wB", "new_impulse")):
        _equal(got[i], ref[i], name)
    for name in pimp._fields:
        _equal(getattr(got[5], name), getattr(ref[5], name), name)
    _equal(got[6], ref[6], "scope")
    assert torch.equal(got[6], pcons.active & pcons.is_mouse) and bool(got[6].any())


def test_math2d_additions_match_jax():
    rng = np.random.RandomState(33)
    v = (rng.normal(size=(64, 2)) * rng.choice([1e-14, 1.0, 30.0], size=(64, 1))).astype(np.float32)
    q1, q2 = _rot(rng, 64), _rot(rng, 64)
    with jax.disable_jit():
        ref = [jm.length(jnp.asarray(v)), jm.normalize(jnp.asarray(v)), jm.inv_rotate(jnp.asarray(q1), jnp.asarray(v)),
               jm.cross_vs(jnp.asarray(v), 1.0), jm.compute_angular_velocity(jnp.asarray(q1), jnp.asarray(q2),
                                                                            jnp.float32(INV_H))]
    tv = torch.from_numpy(v)
    got = [pm.length(tv), pm.normalize(tv), pm.inv_rotate(torch.from_numpy(q1), tv), pm.cross_vs(tv, 1.0),
           pm.compute_angular_velocity(torch.from_numpy(q1), torch.from_numpy(q2), torch.tensor(INV_H))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[1] == 0).all(-1).any()  # below eps: zero, not a division


# ------------------------------------------------------------ broadphase


@pytest.mark.parametrize("window", [40, 16, 2])
def test_find_pairs_matches_jax(window):
    """The sweep and prune of two worlds at once (base-8 pyramids whose fat
    AABBs moved apart differently, a few live joints; 37 shapes in 40
    slots), each world equal to the JAX `find_pairs` on its own. A window
    of 2 overflows; so does one of 16, on the JAX package's test, which
    reads the 17th successor's low bound where that is a dead slot."""
    scenes = [_scene(8, seed) for seed in (41, 42)]
    jcfg = scenes[0][1].replace(broadphase="sap", sap_window=window)
    pcfg = scenes[0][3].replace(broadphase="sap", sap_window=window)
    refs = []
    for jstate, _, _, _ in scenes:
        with jax.disable_jit():
            jj = jbp.jointed_body_keys(jstate.joints, jcfg)
            refs.append(jbp.find_pairs(jstate.shapes, jstate.bodies.type, jj, jcfg))
    shapes = _batch([s[0].shapes for s in scenes], Shapes)
    body_type = torch.from_numpy(np.stack([np.asarray(s[0].bodies.type) for s in scenes]))
    jointed = pbp.jointed_body_keys(_batch([s[0].joints for s in scenes], Joints), pcfg)
    got = pbp.find_pairs_by(shapes, body_type, jointed, pcfg)
    for w in range(2):
        for name in refs[w]._fields:
            np.testing.assert_array_equal(getattr(got, name)[w].numpy(), np.asarray(getattr(refs[w], name)),
                                          err_msg=name)
    assert bool(got.overflow.all()) == (window < 40) and int(got.count.min()) > 0
    if window == 40:
        grid = pbp.find_pairs_grid(shapes, body_type, jointed, pcfg)
        assert torch.equal(grid.key, got.key)


# ------------------------------------------------------------- coloring


@pytest.mark.parametrize("K", [9, 24])
def test_color_graph_matches_jax(K):
    """The MIS coloring of two seeded graphs at once (600 constraints among
    120 bodies), each world's colors and overflow equal to the JAX
    function's on its own graph; at 9 colors constraints overflow."""
    B = 120
    graphs = [_graph(seed) for seed in (43, 44)]
    refs = []
    for ba, bb, active, dyn, _ in graphs:
        with jax.disable_jit():
            refs.append(jcol.color_graph(jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(active), jnp.asarray(dyn), B, K))
    color, overflow = pcol.color_graph(*(torch.from_numpy(np.stack([g[i] for g in graphs])) for i in range(4)), B, K)
    for w in range(2):
        np.testing.assert_array_equal(color[w].numpy(), np.asarray(refs[w][0]))
        assert int(overflow[w]) == int(refs[w][1])
    assert (int(overflow.min()) > 0) == (K == 9)
    assert not torch.equal(color[0], color[1])
