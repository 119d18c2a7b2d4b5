"""Debug draw: a headless renderer of the testbed's layers.

An own copy of the JAX package's `utils/draw.py`: the s2DebugDraw surface
(reference: include/solver2d/debug_draw.h:9-55, src/world.c:308-563) on
matplotlib: shapes in each solver's color, joints, AABBs, contact points,
normals and impulses, and the testbed's overlay of one scene under several
solvers in different colors (reference: samples/main.cpp:689-711). It
reads the state on the host through `to_numpy` (one world: the state
itself, or world `world` of a [W, ...] batch) and imports matplotlib only
when it draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..state import State, world_to_numpy

# per-solver colors (reference: samples/main.cpp:689-703 color legend)
SOLVER_COLORS = [
    "#e6194B", "#3cb44b", "#ffe119", "#4363d8", "#f58231",
    "#911eb4", "#42d4f4", "#f032e6", "#bfef45", "#fabed4",
]


@dataclasses.dataclass
class DrawOptions:
    """reference: debug_draw.h:45-54 toggles"""

    draw_shapes: bool = True
    draw_joints: bool = True
    draw_aabbs: bool = False
    draw_mass: bool = False
    draw_contact_points: bool = False
    draw_contact_normals: bool = False
    draw_contact_impulses: bool = False
    draw_friction_impulses: bool = False


# contact lifecycle colors (reference: src/world.c:489-494)
_SPECULATIVE_COLOR = "#4d4d4d"
_ADD_COLOR = "#4df24d"
_PERSIST_COLOR = "#4d4df2"
_NORMAL_COLOR = "#e5e5e5"
_IMPULSE_COLOR = "#e5e54d"
_FRICTION_COLOR = "#e5e54d"


def _rot(q):
    s, c = q
    return np.array([[c, -s], [s, c]])


def draw_world(ax, state: State, color="#4363d8", alpha=0.9, options: DrawOptions | None = None, world: int = 0):
    """Draw one world's live shapes onto a matplotlib axis."""
    from matplotlib.patches import Circle as MplCircle, Polygon as MplPolygon

    options = options or DrawOptions()
    s = world_to_numpy(state, world)
    shapes = s["shapes"]
    bodies = s["bodies"]
    alive = shapes["alive"]
    body = shapes["body"]
    verts = shapes["verts"]
    counts = shapes["count"]
    radius = shapes["radius"]
    origin = bodies["origin"]
    rot = bodies["rot"]

    if options.draw_shapes:
        for i in np.nonzero(alive)[0]:
            b = body[i]
            R = _rot(rot[b])
            world = verts[i, : counts[i]] @ R.T + origin[b]
            if counts[i] == 1:
                ax.add_patch(MplCircle(world[0], radius[i], fill=False, ec=color, alpha=alpha, lw=1.0))
            elif counts[i] == 2:
                p1, p2 = world
                ax.plot(*zip(p1, p2), color=color, alpha=alpha, lw=1.0)
                if radius[i] > 0:
                    ax.add_patch(MplCircle(p1, radius[i], fill=False, ec=color, alpha=0.5 * alpha, lw=0.7))
                    ax.add_patch(MplCircle(p2, radius[i], fill=False, ec=color, alpha=0.5 * alpha, lw=0.7))
            else:
                ax.add_patch(MplPolygon(world, closed=True, fill=False, ec=color, alpha=alpha, lw=1.0))

    if options.draw_joints:
        j = s["joints"]
        for i in np.nonzero(j["alive"])[0]:
            ia, ib = int(j["body_a"][i]), int(j["body_b"][i])
            pa = origin[ia] + _rot(rot[ia]) @ j["local_anchor_a"][i]
            pb = origin[ib] + _rot(rot[ib]) @ j["local_anchor_b"][i]
            ax.plot(*zip(pa, pb), color="#80cccc", lw=0.8, alpha=alpha)

    if options.draw_aabbs:
        fat = shapes["fat_aabb"]
        for i in np.nonzero(alive)[0]:
            lo_x, lo_y, hi_x, hi_y = fat[i]
            ax.plot(
                [lo_x, hi_x, hi_x, lo_x, lo_x], [lo_y, lo_y, hi_y, hi_y, lo_y],
                color="#00cc00", lw=0.4, alpha=0.5,
            )

    if options.draw_mass:
        # transform axes + mass value at the center of mass
        # (reference: src/world.c:462-484)
        position = bodies["position"]
        mass = bodies["mass"]
        balive = bodies["alive"]
        k_axis = 0.4
        for i in np.nonzero(balive)[0]:
            p = position[i]
            R = _rot(rot[i])
            ax.plot([p[0], p[0] + k_axis * R[0, 0]], [p[1], p[1] + k_axis * R[1, 0]], color="#cc3333", lw=0.8)
            ax.plot([p[0], p[0] + k_axis * R[0, 1]], [p[1], p[1] + k_axis * R[1, 1]], color="#33cc33", lw=0.8)
            ax.annotate(f"{mass[i]:.2g}", p, fontsize=5, color=color, alpha=alpha)

    if options.draw_contact_points:
        # point size/color by lifecycle: speculative (sep > slop), add (new
        # this step), persist (reference: src/world.c:486-534)
        from ..config import LINEAR_SLOP

        con = s["contacts"]
        calive = con["alive"] & (con["point_count"] > 0)
        anchors = con["anchor_a"]
        normals = con["normal"]
        seps = con["separation"]
        persisted = con["persisted"]
        n_imp = con["normal_impulse"]
        t_imp = con["tangent_impulse"]
        k_impulse, k_axis = 1.0, 0.3
        for i in np.nonzero(calive)[0]:
            ia = int(con["body_a"][i])
            R = _rot(rot[ia])
            n = normals[i]
            tangent = np.array([n[1], -n[0]])  # s2RightPerp
            for jdx in range(int(con["point_count"][i])):
                p = origin[ia] + R @ anchors[i, jdx]
                if seps[i, jdx] > LINEAR_SLOP:
                    pc, ms = _SPECULATIVE_COLOR, 2.5
                elif not persisted[i, jdx]:
                    pc, ms = _ADD_COLOR, 5.0
                else:
                    pc, ms = _PERSIST_COLOR, 2.5
                ax.plot([p[0]], [p[1]], marker="o", ms=ms, color=pc)
                if options.draw_contact_normals:
                    ax.plot([p[0], p[0] + k_axis * n[0]], [p[1], p[1] + k_axis * n[1]],
                            color=_NORMAL_COLOR, lw=0.6)
                elif options.draw_contact_impulses:
                    v = k_impulse * n_imp[i, jdx]
                    ax.plot([p[0], p[0] + v * n[0]], [p[1], p[1] + v * n[1]],
                            color=_IMPULSE_COLOR, lw=0.8)
                    ax.annotate(f"{n_imp[i, jdx]:.2g}", p, fontsize=5, color=_IMPULSE_COLOR)
                if options.draw_friction_impulses:
                    v = k_impulse * t_imp[i, jdx]
                    ax.plot([p[0], p[0] + v * tangent[0]], [p[1], p[1] + v * tangent[1]],
                            color=_FRICTION_COLOR, lw=0.8)
                    ax.annotate(f"{t_imp[i, jdx]:.2g}", p, fontsize=5, color=_FRICTION_COLOR)


def render_states(states: dict[str, State], path: str | None = None, options=None, bounds=None, title=None):
    """Overlay multiple solver runs of the same scene (the testbed's
    side-by-side visualization, reference: samples/main.cpp:705-711,806-813).

    states: {label: State} (each one world, or world 0 of a batch). Returns
    the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    for k, (label, st) in enumerate(states.items()):
        draw_world(ax, st, color=SOLVER_COLORS[k % len(SOLVER_COLORS)], options=options)
        ax.plot([], [], color=SOLVER_COLORS[k % len(SOLVER_COLORS)], label=label)
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=7)
    if bounds is not None:
        ax.set_xlim(bounds[0], bounds[2])
        ax.set_ylim(bounds[1], bounds[3])
    else:
        ax.autoscale()
    if title:
        ax.set_title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
