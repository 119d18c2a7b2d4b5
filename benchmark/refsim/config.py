"""Simulation constants and the configuration of the port's two steps.

An own copy of the constants and enums of the JAX package's `config.py`
(reference: include/solver2d/constants.h:6-22). `SimConfig` keeps only the
fields the port's steps read, all of them, so that the check can hold the
program's configuration to the reference's field by field. The reference
runs only the per-world step (`lane_solve=False`, `step.step`): each
world's own pairs (grid or sweep and prune, `broadphase`) and colors
(incremental or per-step MIS, `incremental_coloring`), then the fused soft
solve (`use_fused_solver`) or the XLA route's PGS_NGS_Block, dense.
"""

from __future__ import annotations

import dataclasses
import enum

PI = 3.14159265359
LINEAR_SLOP = 0.005
SPECULATIVE_DISTANCE = 4.0 * LINEAR_SLOP
AABB_MARGIN = 0.1
ANGULAR_SLOP = 2.0 / 180.0 * PI
MAX_POLYGON_VERTICES = 8
MAX_LINEAR_CORRECTION = 0.2
MAX_ANGULAR_CORRECTION = 8.0 / 180.0 * PI
BAUMGARTE = 0.2
MAX_BAUMGARTE_VELOCITY = 4.0
CONTACT_HERTZ = 30.0
JOINT_HERTZ = 60.0

# Soft-constraint damping ratio (reference: src/solve_common.c:266)
CONTACT_ZETA = 10.0

INT32_MAX = 2**31 - 1
# a large finite length: the capsule cast's "no candidate" fraction
HUGE = 100000.0


class SolverType(enum.IntEnum):
    """The ten solver algorithms (reference: include/solver2d/types.h:75-88).
    The port's lane solve runs the soft family (`LANE_SOLVERS`)."""

    JACOBI = 0
    PGS = 1
    PGS_NGS = 2
    PGS_NGS_BLOCK = 3
    PGS_SOFT = 4
    SOFT_STEP = 5
    TGS_STICKY = 6
    TGS_SOFT = 7
    TGS_NGS = 8
    XPBD = 9


# Solvers that sub-step: h = dt / iterations (reference: src/world.c:186-199)
SUBSTEPPING_SOLVERS = frozenset(
    {SolverType.XPBD, SolverType.TGS_SOFT, SolverType.TGS_STICKY, SolverType.TGS_NGS, SolverType.SOFT_STEP}
)
# Solvers whose contact sweeps take the color-bucketed layout
# (`contact_bucket_cap`); Jacobi and TGS_Sticky keep the dense contact
# table (joints bucket under every solver)
BUCKETABLE_SOLVERS = frozenset(
    {SolverType.PGS, SolverType.PGS_NGS, SolverType.PGS_SOFT, SolverType.SOFT_STEP, SolverType.TGS_SOFT,
     SolverType.TGS_NGS, SolverType.XPBD, SolverType.PGS_NGS_BLOCK}
)
LANE_SOLVERS = frozenset({SolverType.PGS_SOFT, SolverType.SOFT_STEP, SolverType.TGS_SOFT})
# Solvers of the per-world step's fused solve (the scripts of K1)
FUSED_SOLVERS = frozenset({SolverType.PGS_SOFT, SolverType.SOFT_STEP, SolverType.TGS_SOFT})
# Solvers of the per-world step's XLA route (`solvers/loops.py:SOLVERS`): all ten
XLA_SOLVERS = frozenset(SolverType)


class BodyType(enum.IntEnum):
    """reference: include/solver2d/types.h:99-105"""

    STATIC = 0
    KINEMATIC = 1
    DYNAMIC = 2


class ShapeType(enum.IntEnum):
    CIRCLE = 0
    CAPSULE = 1
    POLYGON = 2
    SEGMENT = 3


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration of a step.

    The defaults are the JAX package's; `World.freeze` sizes the capacities
    and the grid from the scene."""

    solver: SolverType = SolverType.PGS_NGS_BLOCK
    iterations: int = 4          # substeps (SUBSTEPPING_SOLVERS) or velocity iterations
    extra_iterations: int = 2    # relax or position iterations
    warm_start: bool = True

    max_bodies: int = 128
    max_shapes: int = 128
    max_contacts: int = 512
    max_joints: int = 16

    # the pair finder: "grid" (hashed uniform grid) or "sap" (sweep and
    # prune with a window of `sap_window` successors); both flag overflow
    broadphase: str = "grid"
    sap_window: int = 16
    grid_cell: float = 1.5       # broadphase cell size
    cell_capacity: int = 8       # max small shapes per cell
    max_big_shapes: int = 16     # shapes larger than a cell

    gjk_iters: int = 20          # fixed GJK trip count
    # the JAX package's narrowphase names: "xla", "lanes" and "pallas"
    # compute the same math (its ops/narrow_lanes.py mirrors ops/manifold.py
    # operation for operation); the port runs K2 for each
    narrowphase: str = "xla"

    # the per-world step's solve route: True the fused solve (K1, the soft
    # solvers, a world's bodies in shared memory), False the XLA solvers;
    # None picks K1 where it can run (`use_fused`). `World.freeze` resolves it.
    use_fused_solver: bool | None = None

    max_colors: int = 16         # colors of the contact graph
    joint_max_colors: int = 8    # colors of the joint graph
    contact_bucket_cap: int = 0  # per-color contact bucket capacity (> 0: bucketed)
    joint_bucket_cap: int = 0    # per-color joint bucket capacity (XLA route)
    # statically skip every contact (joint) solve phase; skipping the
    # contacts also skips the narrowphase
    solve_contacts: bool = True
    solve_joints: bool = True
    # True: colors persist across steps and new constraints take first-fit
    # rounds (needs <= 30 colors, an int32 bitmask; `World.freeze` falls
    # back above); False: a Jones-Plassmann MIS coloring every step
    incremental_coloring: bool = True
    color_rounds: int = 8        # first-fit rounds for new constraints per step

    lane_solve: bool = True      # the lane-batched step; False: the per-world step

    def substepping(self) -> bool:
        return self.solver in SUBSTEPPING_SOLVERS

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


# K1 (csrc/fused_solve.cu) keeps each world's body state and per-body
# constants, 16 floats a body, in shared memory: at most 227 KB a block
K1_SMEM_BYTES = 232448
K1_BODY_BYTES = 16 * 4


def k1_fits(cfg: SimConfig) -> bool:
    """A world of cfg.max_bodies fits K1's shared memory."""
    return cfg.max_bodies * K1_BODY_BYTES <= K1_SMEM_BYTES


def use_fused(cfg: SimConfig) -> bool:
    """The per-world step's route: `use_fused_solver` where it is set, else
    K1 when the solver is one of its scripts and the world fits it."""
    if cfg.use_fused_solver is not None:
        return cfg.use_fused_solver
    return cfg.solver in FUSED_SOLVERS and k1_fits(cfg)
