"""The fused soft solve of the reference: the plain twin on any device
(`fused_solve.fused_solve_plain`), with no kernel."""

from __future__ import annotations

from .fused_solve import FusedInputs, fused_solve_plain


def fused_solve(x: FusedInputs, *, script, substeps: int, relax: int, warm_start: bool, n_colors: int,
                n_joint_colors: int, stage_bytes=None, phases=None):
    """The solve of W worlds in `script`; returns what `fused_solve_plain`
    does. `stage_bytes` and `phases` belong to the kernel and are ignored."""
    return fused_solve_plain(x, script=script, substeps=substeps, relax=relax, warm_start=warm_start,
                             n_colors=n_colors, n_joint_colors=n_joint_colors)
