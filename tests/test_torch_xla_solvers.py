"""The per-world step's XLA route (solver2d_tpu_torch.solvers.loops.SOLVERS)
against the JAX package's per-world `step` with its XLA solvers
(`use_pallas_solver=False`), op by op under `jax.disable_jit()`, on the CPU.

- Steps: 3 steps of the port's `batched_step` (`use_fused_solver=False`) on
  two worlds that differ in their initial velocities, against the JAX
  `step` on one of them, under each of the eight ported solvers, on the
  base-3 pyramid and on the 4-plank Bridge with a mouse joint (no
  contacts: `solve_contacts=False` on both sides). The pyramid under
  PGS_NGS_Block runs the JAX package's defaults, its narrowphase "xla"
  (the per-pair manifold) included; the port runs K2's twin for every
  narrowphase name. Bucketed pyramid
  cases (TGS_Soft, PGS_NGS, PGS_NGS_Block), a joint-bucketed Bridge under
  TGS_NGS, Jacobi with a contact bucket cap (its contacts stay dense) and a
  6 x 6 Joint Grid under PGS_NGS with `solve_contacts=False`.
- Pieces: every contact solve mode and the block solver's passes on seeded
  random constraints; the rigid and Baumgarte joint solves, the joint warm
  start and NGS position solve; the per-world color buckets; the ordered
  sums of the contact warm start and of Jacobi on constraints that share
  bodies, equal to the JAX scatter-add's.

Floats are held to `torch_parity.WORLD_TOL` (exact on the pyramid, 1e-6
on the Bridge); integers, colors and diagnostics are equal. The pyramid
cases run 4 GJK iterations (the manifolds of 10 and 20 are the same on
this scene), 5 colors, the fewest without overflow, and one velocity
iteration or substep with one relax pass (the warm start carries the
impulses from step to step): JAX's op-by-op step grows with all three
(its per-pair narrowphase alone costs 3 s a step at 4 GJK iterations, 6 s
at 10; its solve ~0.13 s a colored pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.config import SolverType as JSolver
from solver2d_tpu.models import SCENES as JSCENES
from solver2d_tpu.ops import coloring as jcol
from solver2d_tpu.solvers import common as jcommon
from solver2d_tpu.solvers import contact_kernels as jck
from solver2d_tpu.solvers import joints as jjk
from solver2d_tpu.solvers.common import BodyMap as JBodyMap
from solver2d_tpu.solvers.common import ContactCons as JCons
from solver2d_tpu.step import step as jax_step
from solver2d_tpu.utils.metrics import joint_error as jax_joint_error
from solver2d_tpu_torch import batched_step, state_from_numpy, to_numpy
from solver2d_tpu_torch.config import XLA_SOLVERS
from solver2d_tpu_torch.config import SolverType as PSolver
from solver2d_tpu_torch.ops import coloring as pcol
from solver2d_tpu_torch.solvers import common as pcommon
from solver2d_tpu_torch.solvers import contact_kernels as pck
from solver2d_tpu_torch.solvers import joints as pjk
from solver2d_tpu_torch.solvers.common import ContactCons
from solver2d_tpu_torch.utils.metrics import joint_error
from test_torch_coloring import _graph
from test_torch_joints import H, INV_H, _equal, _prepare
from torch_parity import (
    DT, WORLD_KW, WORLD_TOL, assert_tree_close, jax_world_scene, jax_worlds, np_tree, port_config, stack,
)

torch.set_num_threads(1)
W = 2
STEPS = 3
# TGS_Sticky and XPBD: tests/test_torch_sticky_xpbd.py
SOLVERS = [s.name for s in sorted(XLA_SOLVERS - {PSolver.TGS_STICKY, PSolver.XPBD})]
# per scene: the JAX config's changes (the port's config copies them)
SCENE_KW = {
    "pyramid": dict(max_colors=5, gjk_iters=4, iterations=1),
    "bridge": dict(solve_contacts=False),
}


def _check_steps(scene, solver, world, **kw):
    """3 steps of both, the scene frozen under `solver`, the port's world
    `world` held to the JAX step's. Returns the port's batch and the JAX
    state."""
    jstate, jcfg = jax_world_scene(scene, solver)
    jcfg = jcfg.replace(**{**SCENE_KW.get(scene, {}), **kw})
    worlds = jax_worlds(jstate, W)
    batch = state_from_numpy(stack(worlds), device="cpu")
    cfg = port_config(jcfg).replace(use_fused_solver=False)
    step = batched_step(cfg)
    ref = worlds[world]
    for _ in range(STEPS):
        with jax.disable_jit():
            ref = jax_step(ref, jnp.float32(DT), jcfg)
        batch = step(batch, DT)
        got = {g: {k: v[world] for k, v in d.items()} for g, d in to_numpy(batch).items() if isinstance(d, dict)}
        assert_tree_close(got, np_tree(ref), WORLD_TOL[scene])
        assert int(batch.diag.color_overflow[world]) == 0
    assert not torch.equal(batch.bodies.v[0], batch.bodies.v[1])
    return batch, ref


def _check_scene(scene, solver, world, **kw):
    batch, ref = _check_steps(scene, solver, world, **kw)
    if scene == "pyramid":
        assert int(batch.diag.contact_count[world]) == 12
        assert float(batch.contacts.normal_impulse[world].abs().max()) > 0
    else:
        assert float(batch.joints.motor_impulse[world, 5].abs()) > 0  # the mouse joint
        err = float(joint_error(batch)[world])
        np.testing.assert_allclose(err, float(jax_joint_error(ref)), **WORLD_TOL["bridge"])
        assert err > 0
    return batch


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("scene", ["pyramid", "bridge"])
def test_xla_step_matches_jax(scene, solver):
    """On the pyramid under PGS_NGS_Block, the JAX package's defaults, the
    JAX step runs its default narrowphase "xla" (the per-pair manifold),
    elsewhere its lane-major mirror; the port runs K2's twin for both."""
    kw = dict(narrowphase="xla") if (scene, solver) == ("pyramid", "PGS_NGS_BLOCK") else {}
    _check_scene(scene, solver, world=SOLVERS.index(solver) % W, **kw)


@pytest.mark.parametrize("solver", ["TGS_SOFT", "PGS_NGS", "PGS_NGS_BLOCK"])
def test_bucketed_step_matches_jax(solver):
    """The contact bucket layout: 5 colors of 8 rows a world."""
    _check_scene("pyramid", solver, world=1, contact_bucket_cap=8)


def test_joint_bucketed_step_matches_jax():
    """The joint bucket layout under TGS_NGS: 4 colors of 4 rows."""
    _check_scene("bridge", "TGS_NGS", world=0, joint_bucket_cap=4)


def test_jacobi_keeps_contacts_dense():
    """Jacobi solves the whole contact table at once: a contact bucket cap
    leaves its contacts dense, as in the JAX step."""
    _check_scene("pyramid", "JACOBI", world=0, contact_bucket_cap=8)


def test_joint_grid_step_matches_jax():
    """A 6 x 6 Joint Grid (revolute joints only) under PGS_NGS, its contact
    phases and narrowphase skipped on both sides."""
    jstate, jcfg = JSCENES[("Joints", "Joint Grid")](JSolver.PGS_NGS, numk=6, numi=6).freeze(
        narrowphase="lanes", max_colors=1, joint_max_colors=5, solve_contacts=False, **WORLD_KW
    )
    worlds = jax_worlds(jstate, W)
    batch = state_from_numpy(stack(worlds), device="cpu")
    cfg = port_config(jcfg).replace(use_fused_solver=None)
    assert cfg.use_fused_solver is None
    step = batched_step(cfg)
    ref = worlds[1]
    for _ in range(STEPS):
        with jax.disable_jit():
            ref = jax_step(ref, jnp.float32(DT), jcfg)
        batch = step(batch, DT)
        got = {g: {k: v[1] for k, v in d.items()} for g, d in to_numpy(batch).items() if isinstance(d, dict)}
        assert_tree_close(got, np_tree(ref), WORLD_TOL["pyramid"])
    assert int(batch.joints.alive[1].sum()) == 60 and int(batch.diag.color_overflow.max()) == 0
    assert float(joint_error(batch)[1]) > 0


# ---------------------------------------------------------------- pieces


def _random_cons(seed, C):
    """Seeded random contact constraints, body rows and impulses: the
    inputs of a contact solve."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    ang = rng.uniform(-3, 3, C)
    pmask = rng.rand(C, 2) < 0.8
    fields = dict(
        inv_mass_a=np.abs(f(C)), inv_i_a=np.abs(f(C)), inv_mass_b=np.abs(f(C)), inv_i_b=np.abs(f(C)),
        normal=np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32), friction=np.abs(f(C, scale=0.5)),
        active=rng.rand(C) < 0.9, pmask=pmask, local_anchor_a=f(C, 2, 2, scale=0.5),
        local_anchor_b=f(C, 2, 2, scale=0.5), r_a0=f(C, 2, 2, scale=0.5), r_b0=f(C, 2, 2, scale=0.5),
        separation=f(C, 2, scale=0.02), adjusted_separation=f(C, 2, scale=0.02), normal_mass=np.abs(f(C, 2)),
        tangent_mass=np.abs(f(C, 2)), bias_coef=np.abs(f(C, 2, scale=60)), mass_coef=np.abs(f(C, 2)),
        imp_coef=np.abs(f(C, 2)),
    )
    fields["pmask"] &= fields["active"][:, None]
    return rng, f, fields


def _rot(rng, n):
    q = rng.uniform(-3, 3, n)
    return np.stack([np.sin(q), np.cos(q)], -1).astype(np.float32)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("mode", ["PGS_BAUMGARTE", "PGS_PLAIN", "JACOBI_SOFT", "TGS_RIGID"])
def test_solve_contact_core_modes_match_jax(mode, use_bias):
    """The rigid modes and Jacobi's soft mode (the other soft modes:
    tests/test_torch_fused.py) on seeded random constraints: equal."""
    C = 64
    rng, f, fields = _random_cons(11, C)
    rows = [f(C, 2), f(C), f(C, 2), f(C), _rot(rng, C), _rot(rng, C), f(C, 2, scale=0.05), f(C, 2, scale=0.05),
            np.abs(f(C, 2)), f(C, 2)]
    idx = jnp.zeros(C, jnp.int32)
    with jax.disable_jit():
        ref = jck.solve_contact_core(JCons(ia=idx, ib=idx, **{k: jnp.asarray(v) for k, v in fields.items()}),
                                     *map(jnp.asarray, rows), getattr(jck, mode), jnp.float32(INV_H), use_bias)
    got = pck.solve_contact_core(ContactCons(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                                 *map(torch.from_numpy, rows), getattr(pck, mode), torch.tensor(INV_H), use_bias)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not np.array_equal(np.asarray(ref[4]), rows[8])


def _pair_world(seed, C):
    """C random constraints, constraint i between bodies 2i and 2i+1 (a
    slot table that gives every body its constraint), with their JAX and
    port forms: (rng, f, fields, bs [2C, 8], ia, ib, slot)."""
    rng, f, fields = _random_cons(seed, C)
    B = 2 * C
    bs = np.concatenate([f(B, 2), f(B, 1), f(B, 2, scale=0.05), _rot(rng, B), np.zeros((B, 1), np.float32)], -1)
    ia = np.arange(0, B, 2, dtype=np.int32)
    ib = ia + 1
    slot = np.repeat(np.arange(C, dtype=np.int32), 2)
    return rng, f, fields, bs, ia, ib, slot


def _t(x):
    return torch.from_numpy(np.array(x))[None]


def test_block_passes_match_jax():
    """The block solver's prepare, velocity and position passes on random
    constraints with one- and two-point manifolds, demoted ones among them:
    equal."""
    C = 256
    rng, f, fields, bs, ia, ib, slot = _pair_world(12, C)
    fields["separation"] = f(C, 2, scale=0.01)
    n, t = np.abs(f(C, 2)), f(C, 2, scale=0.2)
    winner = rng.rand(C) < 0.9
    jcons = JCons(ia=jnp.asarray(ia), ib=jnp.asarray(ib), **{k: jnp.asarray(v) for k, v in fields.items()})
    pcons = ContactCons(**{k: _t(v) for k, v in fields.items()})
    with jax.disable_jit():
        jextra = jck.prepare_block(jcons, jnp.float32(INV_H))
        jv = jck.block_velocity_pass((jnp.asarray(bs), jnp.asarray(n), jnp.asarray(t)), 0, jcons, *jextra, None,
                                     None, direct=(jnp.asarray(slot), jnp.asarray(winner)))
        jp = jck.block_position_pass(jv[0], 0, jcons, jextra[3], None, None, direct=(jnp.asarray(slot), None))
    pextra = pck.prepare_block(pcons, torch.tensor(INV_H))
    for g, r in zip(pextra, jextra):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    pv = pck.block_velocity_pass((_t(bs), _t(n), _t(t)), pcons, _t(ia), _t(ib), *pextra, _t(slot),
                                 pcons.active & _t(winner))
    pp = pck.block_position_pass(pv[0], pcons, _t(ia), _t(ib), pextra[3], _t(slot))
    for g, r in zip(pv + (pp,), jv + (jp,)):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    use_block = np.asarray(jextra[3])
    assert use_block.any() and (fields["pmask"][:, 1] & ~use_block).any()  # two-point, demoted or one-point
    assert not np.array_equal(np.asarray(jv[1]), n) and not np.array_equal(np.asarray(jp)[:, 3:5], bs[:, 3:5])


@pytest.mark.parametrize("mode", ["rigid", "baumgarte"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_solve_joint_core_rigid_modes_match_jax(mode, use_bias):
    """The rigid and Baumgarte joint solves (limits, motors, mouse joints)
    on the seeded joints of tests/test_torch_joints.py: equal."""
    (jcons, jimp), (pcons, pimp), s = _prepare(3)
    args = [s[k] for k in ("vA", "wA", "vB", "wB", "qA", "qB", "dcA", "dcB")]
    with jax.disable_jit():
        ref = jjk.solve_joint_core(jcons, *map(jnp.asarray, args), jimp, mode, jnp.float32(H), jnp.float32(INV_H),
                                   use_bias, True)
    got = pjk.solve_joint_core(pcons, *(torch.from_numpy(a)[None] for a in args), pimp, torch.tensor(H),
                               torch.tensor(INV_H), use_bias, True, mode=mode)
    for i, name in enumerate(("vA", "wA", "vB", "wB", "new_impulse")):
        _equal(got[i], ref[i], name)
    for name in pimp._fields:
        _equal(getattr(got[5], name), getattr(ref[5], name), name)
    for name in ("motor", "lower", "upper"):
        assert not torch.equal(getattr(got[5], name), getattr(pimp, name)), name


def test_joint_warm_start_and_position_solve_match_jax():
    """The joint warm start and NGS position solve on the seeded joints,
    each body written by the joint the slot table names: equal."""
    (jcons, jimp), (pcons, pimp), _ = _prepare(4)
    rng = np.random.RandomState(4)
    B, J = 12, pcons.active.shape[1]
    bs = np.concatenate([rng.normal(size=(B, 3)), rng.normal(size=(B, 2)) * 0.05, _rot(rng, B), np.zeros((B, 1))],
                        -1).astype(np.float32)
    slot = rng.randint(-1, J, B).astype(np.int32)
    ja, jb = np.asarray(jcons.ia), np.asarray(jcons.ib)
    with jax.disable_jit():
        jw = jjk.warm_start_apply(jnp.asarray(bs), jcons, jimp, jnp.asarray(slot))
        jp = jjk.position_apply(jw, jcons, jnp.asarray(slot))
    pw = pjk.warm_start_apply(_t(bs), pcons, _t(ja), _t(jb), pimp, _t(slot))
    pp = pjk.position_apply(pw, pcons, _t(ja), _t(jb), _t(slot))
    np.testing.assert_array_equal(pw[0].numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pp[0].numpy(), np.asarray(jp))
    assert not np.array_equal(np.asarray(jp), np.asarray(jw))


def test_color_buckets_per_world_match_jax():
    """Two different graphs bucketed at once: each world's table, colors
    and drops equal to the JAX function on its own graph."""
    B, K, cap = 120, 9, 40
    graphs = [_graph(seed) for seed in (13, 14)]
    colors, actives = [], []
    for ba, bb, active, dyn, carried in graphs:
        with jax.disable_jit():
            jc, _ = jcol.assign_colors(jnp.asarray(carried), jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(active),
                                       jnp.asarray(dyn), B, K, bucket_cap=cap)
        colors.append(np.asarray(jc))
        actives.append(active & (np.asarray(jc) >= 0))
    pbucket, pcolor, pdrop = pcol.build_color_buckets(torch.from_numpy(np.stack(colors)),
                                                      torch.from_numpy(np.stack(actives)), K, cap)
    for w in range(2):
        with jax.disable_jit():
            jbucket, jnew, jdrop = jcol.build_color_buckets(jnp.asarray(colors[w]), jnp.asarray(actives[w]), K, cap)
        np.testing.assert_array_equal(pbucket[w].numpy(), np.asarray(jbucket))
        np.testing.assert_array_equal(pcolor[w].numpy(), np.asarray(jnew))
        assert int(pdrop[w]) == int(jdrop)
    assert not torch.equal(pbucket[0], pbucket[1])


def _shared_bodies(seed, C, B):
    """C random constraints among B < C bodies (each body in several
    constraints, as A and as B), B/4 of them static."""
    rng, f, fields = _random_cons(seed, C)
    ia = rng.randint(0, B, C).astype(np.int32)
    ib = ((ia + rng.randint(1, B, C)) % B).astype(np.int32)
    static = np.arange(B) < B // 4
    fields["inv_mass_a"] = np.where(static[ia], 0, fields["inv_mass_a"]).astype(np.float32)
    fields["inv_i_a"] = np.where(static[ia], 0, fields["inv_i_a"]).astype(np.float32)
    fields["inv_mass_b"] = np.where(static[ib], 0, fields["inv_mass_b"]).astype(np.float32)
    fields["inv_i_b"] = np.where(static[ib], 0, fields["inv_i_b"]).astype(np.float32)
    bs = np.concatenate([f(B, 2), f(B, 1), f(B, 2, scale=0.05), _rot(rng, B), np.zeros((B, 1), np.float32)], -1)
    dyn = ~static
    return rng, f, fields, bs, ia, ib, dyn


def _plan(fields, ia, ib, dyn):
    act = _t(fields["active"])
    d = _t(dyn)
    return pcommon.body_plan(_t(ia), _t(ib), act & d[:, ia], act & d[:, ib], dyn.shape[0])


@pytest.mark.parametrize("fixed_anchors", [False, True])
def test_warm_start_sums_in_jax_order(fixed_anchors):
    """The contact warm start on 96 constraints among 16 bodies (up to a
    dozen a body): the port's ordered sums equal the JAX scatter-add's bit
    for bit, where another order of the same sums does not."""
    C, B = 96, 16
    rng, f, fields, bs, ia, ib, dyn = _shared_bodies(15, C, B)
    n, t = np.abs(f(C, 2)), f(C, 2, scale=0.2)
    jcons = JCons(ia=jnp.asarray(ia), ib=jnp.asarray(ib), **{k: jnp.asarray(v) for k, v in fields.items()})
    with jax.disable_jit():
        ref = np.asarray(jcommon.warm_start_packed(jnp.asarray(bs), jcons, jnp.asarray(n), jnp.asarray(t),
                                                   fixed_anchors=fixed_anchors))
    pcons = ContactCons(**{k: _t(v) for k, v in fields.items()})
    got = pcommon.warm_start_packed(_t(bs), pcons, _t(ia), _t(ib), _t(n), _t(t), _plan(fields, ia, ib, dyn),
                                    fixed_anchors)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    # the same constraints in reverse: the same terms summed in another order
    fr = {k: v[::-1].copy() for k, v in fields.items()}
    ia_r, ib_r = ia[::-1].copy(), ib[::-1].copy()
    pr = ContactCons(**{k: _t(v) for k, v in fr.items()})
    back = pcommon.warm_start_packed(_t(bs), pr, _t(ia_r), _t(ib_r), _t(n[::-1]), _t(t[::-1]),
                                     _plan(fr, ia_r, ib_r, dyn), fixed_anchors)
    assert not np.array_equal(back[0].numpy(), ref)
    np.testing.assert_allclose(back[0].numpy(), ref, rtol=0, atol=1e-5)


def test_jacobi_sums_in_jax_order():
    """One Jacobi contact pass on 96 constraints among 16 bodies: equal to
    the JAX pass bit for bit (its scatter-add order)."""
    C, B = 96, 16
    rng, f, fields, bs, ia, ib, dyn = _shared_bodies(16, C, B)
    n, t = np.abs(f(C, 2)), f(C, 2, scale=0.2)
    jcons = JCons(ia=jnp.asarray(ia), ib=jnp.asarray(ib), **{k: jnp.asarray(v) for k, v in fields.items()})
    with jax.disable_jit():
        ref = jck.jacobi_contact_pass(jnp.asarray(bs), jcons, jnp.asarray(n), jnp.asarray(t), jck.JACOBI_SOFT,
                                      jnp.float32(INV_H), True)
    pcons = ContactCons(**{k: _t(v) for k, v in fields.items()})
    got = pck.jacobi_contact_pass(_t(bs), pcons, _t(ia), _t(ib), _t(n), _t(t), pck.JACOBI_SOFT, torch.tensor(INV_H),
                                  True, _plan(fields, ia, ib, dyn))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    assert not np.array_equal(np.asarray(ref[0]), bs)


def test_gather_apply_and_ngs_match_jax():
    """`gather_apply` (a body takes its constraint's A or B row) and the
    contact NGS pass, on constraints whose slot table leaves some bodies
    alone: equal."""
    C = 64
    rng, f, fields, bs, ia, ib, slot = _pair_world(17, C)
    slot = np.where(rng.rand(2 * C) < 0.8, slot, -1).astype(np.int32)
    jcons = JCons(ia=jnp.asarray(ia), ib=jnp.asarray(ib), **{k: jnp.asarray(v) for k, v in fields.items()})
    with jax.disable_jit():
        ref = jcommon.ngs_apply(jnp.asarray(bs), jcons, jnp.asarray(slot))
    pcons = ContactCons(**{k: _t(v) for k, v in fields.items()})
    got = pcommon.ngs_apply(_t(bs), pcons, _t(ia), _t(ib), _t(slot))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    moved = (np.asarray(ref) != bs).any(-1)
    assert moved.any() and not moved[slot < 0].any()


def test_narrowphase_names_run_k2():
    """The three narrowphase names of the JAX package run the same K2
    twin: two port steps under each give the same state; another name
    raises."""
    jstate, jcfg = jax_world_scene("pyramid")
    cfg = port_config(jcfg.replace(solver=JSolver.PGS_NGS_BLOCK, **SCENE_KW["pyramid"]))
    outs = []
    for impl in ("xla", "lanes", "pallas"):
        batch = state_from_numpy(stack(jax_worlds(jstate, 1)), device="cpu")
        step = batched_step(cfg.replace(narrowphase=impl))
        for _ in range(2):
            batch = step(batch, DT)
        outs.append(to_numpy(batch))
        assert int(batch.diag.contact_count[0]) == 12
    for out in outs[1:]:
        assert_tree_close(out, outs[0], dict(rtol=0, atol=0))
    with pytest.raises(ValueError, match="narrowphase"):
        batched_step(cfg.replace(narrowphase="gjk"))(batch, DT)
