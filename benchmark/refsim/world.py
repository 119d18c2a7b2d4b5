"""Host-side scene construction: a numpy `World` that `freeze`s into a
`State` of tensors and a `SimConfig`.

An own copy of the port's `world.py`, as far as the benchmark's scenes use
it: bodies, polygon shapes, revolute joints (reference:
src/joint.c:181-223), mass properties (src/body.c:152-218) and the
scene-aware default configuration (grid cell, colors, capacities). The
state keeps the port's joint types (0 revolute, 1 mouse).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .config import (
    AABB_MARGIN,
    FUSED_SOLVERS,
    K1_BODY_BYTES,
    K1_SMEM_BYTES,
    LANE_SOLVERS,
    MAX_POLYGON_VERTICES,
    SPECULATIVE_DISTANCE,
    BodyType,
    SimConfig,
    SolverType,
    k1_fits,
)
from . import native
from .ops import geometry
from .state import Bodies, Contacts, Diagnostics, Joints, Shapes, State


@dataclasses.dataclass
class BodyDef:
    """reference: include/solver2d/types.h:107-130"""

    type: BodyType = BodyType.STATIC
    position: tuple = (0.0, 0.0)
    angle: float = 0.0
    linear_velocity: tuple = (0.0, 0.0)
    angular_velocity: float = 0.0
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    gravity_scale: float = 1.0


@dataclasses.dataclass
class ShapeDef:
    """reference: include/solver2d/types.h:141-156"""

    friction: float = 0.6
    restitution: float = 0.0
    density: float = 1.0
    filter_category: int = 0x1
    filter_mask: int = 0xFFFFFFFF
    filter_group: int = 0


@dataclasses.dataclass
class _Body:
    def_: BodyDef
    shapes: list = dataclasses.field(default_factory=list)
    mass: float = 0.0
    inertia: float = 0.0
    local_center: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    linear_velocity: np.ndarray = None

    def __post_init__(self):
        self.linear_velocity = np.asarray(self.def_.linear_velocity, np.float64).copy()


@dataclasses.dataclass
class _Shape:
    body: int
    geom: geometry.ShapeGeom
    def_: ShapeDef


@dataclasses.dataclass
class _Joint:
    type: int  # 0 revolute, 1 mouse
    body_a: int
    body_b: int
    local_anchor_a: np.ndarray
    local_anchor_b: np.ndarray
    collide_connected: bool = False
    reference_angle: float = 0.0
    lower_angle: float = 0.0
    upper_angle: float = 0.0
    enable_limit: bool = False
    enable_motor: bool = False
    motor_speed: float = 0.0
    max_motor_torque: float = 0.0
    target: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    hertz: float = 0.0
    damping_ratio: float = 0.0


def _rot_of(angle):
    return np.array([np.sin(angle), np.cos(angle)], np.float64)


def _rotate(rot, v):
    s, c = rot
    return np.array([c * v[0] - s * v[1], s * v[0] + c * v[1]])


def _round(n, m):
    return max(m, ((n + m - 1) // m) * m)


class World:
    """Scene builder. One instance per scene; `freeze()` to simulate."""

    def __init__(self, solver: SolverType = SolverType.PGS_NGS_BLOCK, gravity=(0.0, -10.0)):
        """Every body's mass is computed at `freeze`, all in one call of the
        scene compiler (`native.compile_scene`, float32), as the port's
        default `World(defer_mass=True)` does."""
        self.solver = solver
        self.gravity = np.asarray(gravity, np.float64)
        self.bodies: list[_Body] = []
        self.shapes: list[_Shape] = []
        self.joints: list[_Joint] = []

    def create_body(self, def_: Optional[BodyDef] = None, **kw) -> int:
        if def_ is None:
            def_ = BodyDef(**kw)
        elif kw:
            def_ = dataclasses.replace(def_, **kw)
        self.bodies.append(_Body(def_))
        return len(self.bodies) - 1

    def create_shape(self, body: int, geom: geometry.ShapeGeom, def_: Optional[ShapeDef] = None, **kw) -> int:
        """Attach a shape to a body (reference: src/body.c:220-314). Mass
        properties wait for `freeze`."""
        if def_ is None:
            def_ = ShapeDef(**kw)
        elif kw:
            def_ = dataclasses.replace(def_, **kw)
        self.shapes.append(_Shape(body, geom, def_))
        self.bodies[body].shapes.append(len(self.shapes) - 1)
        return len(self.shapes) - 1

    def create_polygon_shape(self, body: int, geom_or_points, def_: Optional[ShapeDef] = None, **kw) -> int:
        geom = geom_or_points
        if not isinstance(geom, geometry.ShapeGeom):
            geom = geometry.polygon(geom_or_points)
        return self.create_shape(body, geom, def_, **kw)

    def get_local_point(self, body: int, world_point):
        """World point -> body origin frame (s2Body_GetLocalPoint)."""
        b = self.bodies[body]
        s, c = _rot_of(b.def_.angle)
        v = np.asarray(world_point, np.float64) - np.asarray(b.def_.position, np.float64)
        return np.array([c * v[0] + s * v[1], -s * v[0] + c * v[1]])

    def create_revolute_joint(
        self, body_a: int, body_b: int, local_anchor_a=(0.0, 0.0), local_anchor_b=(0.0, 0.0),
        reference_angle: float = 0.0, lower_angle: float = 0.0, upper_angle: float = 0.0,
        enable_limit: bool = False, enable_motor: bool = False, motor_speed: float = 0.0,
        max_motor_torque: float = 0.0, collide_connected: bool = False,
    ) -> int:
        """reference: src/joint.c:181-223"""
        self.joints.append(_Joint(
            0, body_a, body_b,
            np.asarray(local_anchor_a, np.float64), np.asarray(local_anchor_b, np.float64),
            collide_connected, reference_angle, lower_angle, upper_angle,
            enable_limit, enable_motor, motor_speed, max_motor_torque,
        ))
        return len(self.joints) - 1

    def _batch_compute_mass(self):
        """The deferred mass of every dynamic body that has shapes and no
        mass yet, in one call of the scene compiler (`native.compile_scene`;
        reference: src/body.c:152-218), each with the center-of-mass
        velocity fix-up of :215-217, as the JAX `World` does at freeze."""
        pending = [
            i for i, b in enumerate(self.bodies)
            if b.def_.type == BodyType.DYNAMIC and b.mass == 0.0 and b.shapes
        ]
        if not pending:
            return
        out = native.compile_scene(
            np.stack([s.geom.verts for s in self.shapes]).astype(np.float32),
            np.stack([s.geom.normals for s in self.shapes]).astype(np.float32),
            np.array([s.geom.count for s in self.shapes], np.int32),
            np.array([s.geom.radius for s in self.shapes], np.float32),
            np.array([s.def_.density for s in self.shapes], np.float32),
            np.array([s.body for s in self.shapes], np.int32),
            np.array([b.def_.position for b in self.bodies], np.float32).reshape(-1, 2),
            np.array([b.def_.angle for b in self.bodies], np.float32),
            np.array([int(b.def_.type) for b in self.bodies], np.int32),
            SPECULATIVE_DISTANCE, AABB_MARGIN,
        )
        for i in pending:
            b = self.bodies[i]
            b.mass = float(out["mass"][i])
            b.inertia = float(out["inertia"][i])
            old_center = b.local_center.copy()
            b.local_center = out["local_center"][i].astype(np.float64)
            delta_center = _rotate(_rot_of(b.def_.angle), b.local_center - old_center)
            w = b.def_.angular_velocity
            b.linear_velocity = b.linear_velocity + w * np.array([-delta_center[1], delta_center[0]])

    def _shape_bounds(self):
        """Initial world AABBs (with the speculative margin) and fat-AABB
        margins of every shape (reference: src/shape.c:48-67)."""
        out = []
        for s in self.shapes:
            g = s.geom
            b = self.bodies[s.body]
            rot = _rot_of(b.def_.angle)
            origin = np.asarray(b.def_.position, np.float64)
            world = origin + np.stack([_rotate(rot, v) for v in g.verts[: g.count]])
            lo = world.min(0) - g.radius - SPECULATIVE_DISTANCE
            hi = world.max(0) + g.radius + SPECULATIVE_DISTANCE
            static = b.def_.type == BodyType.STATIC
            margin = SPECULATIVE_DISTANCE if static else AABB_MARGIN + SPECULATIVE_DISTANCE
            out.append((lo, hi, margin))
        return out

    def _color_defaults(self) -> tuple[int, int]:
        """Scene-aware (max_colors, joint_max_colors): greedy first-fit needs
        about (max constraint degree + 1) colors, with a floor of 8. The joint
        degree is exact; the contact degree is estimated from the initial
        fat-AABB overlaps."""
        nb = len(self.bodies)
        dyn_body = np.array([b.def_.type == BodyType.DYNAMIC for b in self.bodies], bool)
        jdeg = np.zeros(max(nb, 1), np.int64)
        for j in self.joints:
            for b in (j.body_a, j.body_b):
                jdeg[b] += dyn_body[b]
        joint_colors = int(min(30, max(8, int(jdeg.max()) + 2)))
        n = len(self.shapes)
        if not n:
            return 8, joint_colors
        bounds = self._shape_bounds()
        lo = np.stack([b[0] - b[2] for b in bounds])
        hi = np.stack([b[1] + b[2] for b in bounds])
        sbody = np.array([s.body for s in self.shapes], np.int64)
        deg = np.zeros(max(nb, 1), np.int64)
        sdyn = dyn_body[sbody]
        for c0 in range(0, n, 512):
            c1 = min(c0 + 512, n)
            ov = (
                (lo[c0:c1, None, 0] <= hi[None, :, 0]) & (lo[None, :, 0] <= hi[c0:c1, None, 0])
                & (lo[c0:c1, None, 1] <= hi[None, :, 1]) & (lo[None, :, 1] <= hi[c0:c1, None, 1])
                & (sbody[c0:c1, None] != sbody[None, :])
                & (sdyn[c0:c1, None] | sdyn[None, :])
            )
            np.add.at(deg, sbody[c0:c1], ov.sum(axis=1))
        cdeg = int(deg[dyn_body].max()) if dyn_body.any() else 0
        return int(min(30, max(8, cdeg + 2))), joint_colors

    def default_config(self, **overrides) -> SimConfig:
        nb = _round(len(self.bodies) + 1, 8)
        ns = _round(len(self.shapes) + 1, 8)
        nj = _round(len(self.joints) + 1, 8)
        ndyn = sum(1 for s in self.shapes if self.bodies[s.body].def_.type == BodyType.DYNAMIC)
        nc = _round(max(64, 8 * max(ndyn, 1)), 64)

        # grid cell: fits the 90th-percentile dynamic fat AABB; larger
        # shapes go to the big list
        extents = []
        for s in self.shapes:
            g = s.geom
            v = g.verts[: g.count]
            ext = float(max(v[:, 0].max() - v[:, 0].min(), v[:, 1].max() - v[:, 1].min()) + 2 * g.radius)
            pad = 2 * (AABB_MARGIN + 2 * SPECULATIVE_DISTANCE)
            extents.append((ext + pad, self.bodies[s.body].def_.type == BodyType.DYNAMIC))
        dyn_ext = sorted(e for e, d in extents if d) or [1.0]
        cell = max(0.3, 1.05 * dyn_ext[int(0.9 * (len(dyn_ext) - 1))])
        n_big = sum(1 for e, _ in extents if e > cell)
        max_colors, joint_max_colors = self._color_defaults()
        cfg = SimConfig(
            solver=self.solver, max_bodies=nb, max_shapes=ns, max_contacts=nc, max_joints=nj,
            grid_cell=cell, max_big_shapes=_round(n_big + 4, 4),
            max_colors=max_colors, joint_max_colors=joint_max_colors,
        )
        return cfg.replace(**overrides) if overrides else cfg

    def freeze(self, config: Optional[SimConfig] = None, device="cuda", **overrides) -> tuple[State, SimConfig]:
        """Pack the scene into a `State` on `device` and its `SimConfig`.
        `contact_bucket_cap=-1` (`joint_bucket_cap=-1`) sizes a bucket
        capacity to twice the uniform share of the contact (joint) table.
        `lane_solve=False` configures the per-world step; its route is
        resolved here (`use_fused_solver`: K1 for its three soft solvers when
        a world's bodies fit its shared memory, else the XLA solvers) and
        the returned config names it. Above 30 colors the incremental
        coloring's bitmask no longer fits: the config falls back to the
        per-step MIS coloring with a warning, as in the JAX package. The
        contact table carries TGS_Sticky's friction anchors under that
        solver only."""
        if config is None:
            config = self.default_config(**overrides)
        assert config.max_bodies >= len(self.bodies)
        assert config.max_shapes >= len(self.shapes)
        assert config.max_joints >= len(self.joints)
        assert config.max_shapes * config.max_shapes < (1 << 31), "pair keys must fit int32"
        assert config.solve_joints or not self.joints, (
            "solve_joints=False is for joint-free scenes; this scene's joints would be ignored"
        )
        if config.broadphase not in ("grid", "sap"):
            raise ValueError(f"broadphase {config.broadphase!r}: 'grid' or 'sap'")
        if config.lane_solve:
            assert config.solve_contacts, "lane_solve IS the contact solve"
            assert config.solver in LANE_SOLVERS, f"the lane step runs {sorted(s.name for s in LANE_SOLVERS)}"
            assert config.contact_bucket_cap != 0, "the lane step needs the bucketed layout"
            assert not self.joints, "the lane step solves no joints"
            assert config.incremental_coloring, "the lane step colors incrementally"
            config = config.replace(use_fused_solver=False)
        else:
            fits = k1_fits(config)
            if config.use_fused_solver is None:
                config = config.replace(use_fused_solver=config.solver in FUSED_SOLVERS and fits)
            elif config.use_fused_solver and config.solver not in FUSED_SOLVERS:
                raise ValueError(
                    f"use_fused_solver=True: the fused solve (K1) runs "
                    f"{', '.join(s.name for s in sorted(FUSED_SOLVERS))}, not {config.solver.name}"
                )
            elif config.use_fused_solver and not fits:
                raise ValueError(
                    f"use_fused_solver=True with max_bodies={config.max_bodies}: the fused solve (K1) keeps a "
                    f"world's bodies in shared memory, at most {K1_SMEM_BYTES // K1_BODY_BYTES} a world; larger "
                    "worlds take the XLA solvers (use_fused_solver=False or None)"
                )
        if config.contact_bucket_cap < 0:
            cap = -(-2 * config.max_contacts // config.max_colors)
            config = config.replace(contact_bucket_cap=(cap + 7) // 8 * 8)
        if config.joint_bucket_cap < 0:
            jcap = -(-2 * config.max_joints // config.joint_max_colors)
            config = config.replace(joint_bucket_cap=(jcap + 7) // 8 * 8)
        if config.incremental_coloring and max(config.max_colors, config.joint_max_colors) > 30:
            # assign_colors packs the used colors into an int32 bitmask: fall
            # back to the per-step MIS coloring, as the JAX package does
            warnings.warn(
                f"max_colors={config.max_colors}/joint_max_colors={config.joint_max_colors} "
                "> 30: incremental coloring needs an i32 bitmask; falling back to "
                "per-step MIS coloring (incremental_coloring=False)",
                stacklevel=2,
            )
            config = config.replace(incremental_coloring=False)

        self._batch_compute_mass()

        B = _zeros_bodies(config.max_bodies)
        for i, b in enumerate(self.bodies):
            d = b.def_
            rot = _rot_of(d.angle)
            origin = np.asarray(d.position, np.float64)
            B["type"][i] = int(d.type)
            B["origin"][i] = origin
            B["position"][i] = origin + _rotate(rot, b.local_center)
            B["rot"][i] = rot
            B["rot0"][i] = rot
            B["local_center"][i] = b.local_center
            B["v"][i] = b.linear_velocity
            B["w"][i] = d.angular_velocity
            B["mass"][i] = b.mass
            B["inv_mass"][i] = 1.0 / b.mass if b.mass > 0 else 0.0
            B["inertia"][i] = b.inertia
            B["inv_inertia"][i] = 1.0 / b.inertia if b.inertia > 0 else 0.0
            B["linear_damping"][i] = d.linear_damping
            B["angular_damping"][i] = d.angular_damping
            B["gravity_scale"][i] = d.gravity_scale
            B["alive"][i] = True

        S = _zeros_shapes(config.max_shapes)
        for i, (s, (lo, hi, margin)) in enumerate(zip(self.shapes, self._shape_bounds())):
            g = s.geom
            S["body"][i] = s.body
            S["source_type"][i] = int(g.source_type)
            S["verts"][i] = g.verts
            S["normals"][i] = g.normals
            S["count"][i] = g.count
            S["radius"][i] = g.radius
            S["friction"][i] = s.def_.friction
            S["restitution"][i] = s.def_.restitution
            S["density"][i] = s.def_.density
            S["filter_category"][i] = s.def_.filter_category
            S["filter_mask"][i] = s.def_.filter_mask
            S["filter_group"][i] = s.def_.filter_group
            S["alive"][i] = True
            S["aabb"][i] = np.concatenate([lo, hi])
            S["fat_aabb"][i] = np.concatenate([lo - margin, hi + margin])

        def t(d):
            return {
                k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v).to(device)
                for k, v in d.items()
            }

        J = _zeros_joints(config.max_joints)
        for i, j in enumerate(self.joints):
            for k in ("type", "body_a", "body_b", "local_anchor_a", "local_anchor_b", "collide_connected",
                      "reference_angle", "lower_angle", "upper_angle", "enable_limit", "enable_motor",
                      "motor_speed", "max_motor_torque", "target", "hertz", "damping_ratio"):
                J[k][i] = getattr(j, k)
            J["alive"][i] = True

        C = config.max_contacts
        state = State(
            bodies=Bodies(**t(B)),
            shapes=Shapes(**t(S)),
            contacts=Contacts(**t(_zeros_contacts(C, sticky=config.solver == SolverType.TGS_STICKY))),
            joints=Joints(**t(J)),
            gravity=torch.tensor(self.gravity, dtype=torch.float32, device=device),
            diag=Diagnostics(**t(dict(
                contact_count=np.zeros((), np.int32), pair_count=np.zeros((), np.int32),
                pair_overflow=np.zeros((), bool), color_overflow=np.zeros((), np.int32),
                max_penetration=np.zeros((), np.float32), step_id=np.zeros((), np.int32),
            ))),
        )
        return state, config


def _zeros_bodies(n):
    f = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    rot = np.tile(np.array([0.0, 1.0], np.float32), (n, 1))
    return {
        "type": np.zeros((n,), np.int32),
        "origin": f(n, 2), "position": f(n, 2), "delta_pos": f(n, 2), "delta_pos0": f(n, 2),
        "rot": rot, "rot0": rot.copy(), "local_center": f(n, 2),
        "v": f(n, 2), "w": f(n), "v0": f(n, 2), "w0": f(n),
        "force": f(n, 2), "torque": f(n),
        "mass": f(n), "inv_mass": f(n), "inertia": f(n), "inv_inertia": f(n),
        "linear_damping": f(n), "angular_damping": f(n),
        "gravity_scale": np.ones((n,), np.float32),
        "alive": np.zeros((n,), bool),
    }


def _zeros_shapes(n):
    MPV = MAX_POLYGON_VERTICES
    f = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    return {
        "body": np.full((n,), -1, np.int32),
        "source_type": np.zeros((n,), np.int32),
        "verts": f(n, MPV, 2), "normals": f(n, MPV, 2),
        "count": np.ones((n,), np.int32),
        "radius": f(n), "friction": f(n), "restitution": f(n), "density": f(n),
        "filter_category": np.ones((n,), np.uint32),
        "filter_mask": np.full((n,), 0xFFFFFFFF, np.uint32),
        "filter_group": np.zeros((n,), np.int32),
        "aabb": f(n, 4), "fat_aabb": f(n, 4),
        "alive": np.zeros((n,), bool),
    }


def _zeros_contacts(n, sticky: bool = False):
    """An empty contact table of n slots; the sticky friction anchors have
    its width under TGS_Sticky (`sticky`), else width 0."""
    f = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    i = lambda *s: np.zeros(s, np.int32)  # noqa: E731
    ns = n if sticky else 0
    return {
        "key": np.full((n,), np.iinfo(np.int32).max, np.int32),
        "shape_a": i(n), "shape_b": i(n), "body_a": i(n), "body_b": i(n),
        "friction": f(n), "restitution": f(n),
        "normal": f(n, 2), "anchor_a": f(n, 2, 2), "anchor_b": f(n, 2, 2),
        "separation": f(n, 2), "normal_impulse": f(n, 2), "tangent_impulse": f(n, 2),
        "point_id": i(n, 2), "persisted": np.zeros((n, 2), bool), "point_count": i(n),
        "friction_normal_a": f(ns, 2, 2), "friction_normal_b": f(ns, 2, 2),
        "friction_anchor_a": f(ns, 2, 2), "friction_anchor_b": f(ns, 2, 2),
        "friction_persisted": np.zeros((ns,), bool),
        "cache_count": i(n), "cache_index_a": i(n, 3), "cache_index_b": i(n, 3),
        "color": np.full((n,), -1, np.int32),
        "alive": np.zeros((n,), bool),
    }


def _zeros_joints(n):
    f = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    i = lambda *s: np.zeros(s, np.int32)  # noqa: E731
    b = lambda *s: np.zeros(s, bool)  # noqa: E731
    return {
        "type": i(n), "body_a": i(n), "body_b": i(n),
        "local_anchor_a": f(n, 2), "local_anchor_b": f(n, 2),
        "collide_connected": b(n),
        "reference_angle": f(n), "lower_angle": f(n), "upper_angle": f(n),
        "enable_limit": b(n), "enable_motor": b(n),
        "motor_speed": f(n), "max_motor_torque": f(n),
        "target": f(n, 2), "hertz": f(n), "damping_ratio": f(n),
        "impulse": f(n, 2), "motor_impulse": f(n), "lower_impulse": f(n), "upper_impulse": f(n),
        "color": np.full((n,), -1, np.int32),
        "alive": b(n),
    }
