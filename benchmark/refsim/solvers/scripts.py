"""The soft solvers' scripts of the per-world step's fused solve
(`fused_solve`, K1's twin): each solver's loop,
contact solve mode, warm-start anchors and stiffness factors, and its step
size."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SolverType
from . import contact_kernels as ck


class Script(NamedTuple):
    """A soft solver's script: its loop, its contact solve mode and its
    contact warm-start anchors (what pallas_solver.py:_kernel takes as
    `loop`, `mode` and `fixed_warm`), and the factors of 1/h that set its
    contact and joint stiffness (loops.py:solve_tgs_soft, solve_soft_step,
    solve_pgs_soft)."""

    loop: str             # "substep" (TGS_Soft, SoftStep) or "pgs" (PGS_Soft)
    mode: ck.SolveMode    # the contact solve
    fixed_warm: bool      # warm contacts at the prepare-time anchors r_a0, r_b0
    contact_hertz: float  # contact hertz = min(CONTACT_HERTZ, contact_hertz / h)
    joint_hertz: float    # joint hertz = min(JOINT_HERTZ, joint_hertz / h)


TGS_SOFT = Script("substep", ck.TGS_SOFT, False, 0.25, 0.125)
SOFT_STEP = Script("substep", ck.SOFT_STEP, True, 0.25, 0.25)
PGS_SOFT = Script("pgs", ck.PGS_SOFT, False, 0.333, 0.5)
# the scripts K1 is built for; a script's id in the kernel is its index
SCRIPTS = (TGS_SOFT, SOFT_STEP, PGS_SOFT)
# the script of each soft solver (config.LANE_SOLVERS, FUSED_SOLVERS)
SOLVER_SCRIPTS = {SolverType.TGS_SOFT: TGS_SOFT, SolverType.SOFT_STEP: SOFT_STEP, SolverType.PGS_SOFT: PGS_SOFT}


def step_size(script: Script, dt, iterations: int):
    """(h, 1/h) of a script for a step dt (a 0-dim float32 tensor): a
    substep of dt in the substep loop, dt itself in the PGS loop; 1/h is 0
    for dt <= 0."""
    n = torch.tensor(float(iterations if script.loop == "substep" else 1), dtype=torch.float32, device=dt.device)
    inv_h = torch.where(dt > 0, n / torch.where(dt > 0, dt, torch.ones_like(dt)), 0.0)
    return dt / n, inv_h
