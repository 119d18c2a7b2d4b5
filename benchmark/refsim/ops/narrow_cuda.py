"""The narrowphase entry of the reference: the plain lane-major twin on any
device (`narrow_lanes.collide_lanes_plain`), with no kernel."""

from __future__ import annotations

from .narrow_lanes import collide_lanes_plain


def collide(geom, sa, sb, pa, pb, cache, gjk_iters: int):
    """Narrowphase of a lockstep batch (layouts in `collide_lanes_plain`)."""
    return collide_lanes_plain(geom, sa, sb, pa, pb, cache, gjk_iters)
