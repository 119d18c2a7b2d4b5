"""Simulation constants and the configuration of the port's two steps.

An own copy of the constants and enums of the JAX package's `config.py`
(reference: include/solver2d/constants.h:6-22). `SimConfig` keeps only the
fields the port's steps read. Both run the grid broadphase and the
lane-major narrowphase; `lane_solve` picks the step:

- True: the lane-batched step (`step.step_batch`): shared world-0 structure,
  bucketed contact solve, no joints;
- False: the per-world step (`step.step`, `parallel.batched_step`): each
  world's own pairs and colors, and the fused soft solve (kernel K1) of
  TGS_Soft, SoftStep or PGS_Soft with soft revolute and mouse joints.
"""

from __future__ import annotations

import dataclasses
import enum

PI = 3.14159265359
LINEAR_SLOP = 0.005
SPECULATIVE_DISTANCE = 4.0 * LINEAR_SLOP
AABB_MARGIN = 0.1
MAX_POLYGON_VERTICES = 8
MAX_BAUMGARTE_VELOCITY = 4.0
CONTACT_HERTZ = 30.0
JOINT_HERTZ = 60.0

# Soft-constraint damping ratio (reference: src/solve_common.c:266)
CONTACT_ZETA = 10.0

INT32_MAX = 2**31 - 1


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


LANE_SOLVERS = frozenset({SolverType.PGS_SOFT, SolverType.SOFT_STEP, SolverType.TGS_SOFT})
# Solvers of the per-world step's fused solve (the scripts of K1)
FUSED_SOLVERS = frozenset({SolverType.PGS_SOFT, SolverType.SOFT_STEP, SolverType.TGS_SOFT})


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

    solver: SolverType = SolverType.TGS_SOFT
    iterations: int = 4          # substeps (TGS_SOFT, SOFT_STEP) or velocity iterations
    extra_iterations: int = 2    # relax iterations
    warm_start: bool = True

    max_bodies: int = 128
    max_shapes: int = 128
    max_contacts: int = 512
    max_joints: int = 16

    grid_cell: float = 1.5       # broadphase cell size
    cell_capacity: int = 8       # max small shapes per cell
    max_big_shapes: int = 16     # shapes larger than a cell

    gjk_iters: int = 20          # fixed GJK trip count

    max_colors: int = 16         # colors of the contact graph (<= 30)
    joint_max_colors: int = 8    # colors of the joint graph (<= 30)
    contact_bucket_cap: int = 0  # per-color bucket capacity of the lane solve
    color_rounds: int = 8        # first-fit rounds for new constraints per step

    lane_solve: bool = True      # the lane-batched step; False: the per-world step

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
