"""Headless testbed CLI: the reference's samples app without a window.

An own copy of the JAX package's `testbed.py` for the port (reference:
samples/main.cpp, sample.cpp): runs one catalog scene under one or more
solvers (one world per solver, main.cpp:705-711), steps them in
lockstep with the scene's hooks on the per-world step (`step.make_step`: K2,
then K1 for the soft solvers where a world fits it, else the XLA solvers),
prints the per-solver stats overlay (sample.cpp:144-156), and renders the
overlaid solvers' frames on request (`--render`, `--render-every`, the
`--draw-*` layers; `utils/draw.py`), or runs the interactive testbed
(`--interactive`, or `--interactive-gif PATH` headless; `interactive.py`).
matplotlib and PIL are imported only for those.

Usage:
  python -m solver2d_tpu_torch.testbed --list
  python -m solver2d_tpu_torch.testbed "Contact/Pyramid" --solvers TGS_SOFT,PGS_NGS_BLOCK --steps 240
  python -m solver2d_tpu_torch.testbed "Joints/Ragdoll Stress" --solvers all --steps 240
  python -m solver2d_tpu_torch.testbed "Joints/Joint Grid" --solvers PGS_NGS --steps 60 --bucket-cap -1
  python -m solver2d_tpu_torch.testbed "Contact/Pyramid" --solvers TGS_STICKY,XPBD --broadphase sap --mis
  python -m solver2d_tpu_torch.testbed "Joints/Bridge" --solvers all --steps 60 --render out.png
  python -m solver2d_tpu_torch.testbed "Contact/Single Box" --solvers TGS_SOFT --steps 6 --interactive-gif itb.gif

Settings mirror samples/settings.h:16-24: 60 Hz, 4 primary iterations, 2
secondary, warm starting on. The scene runs on the card; `run_scene(...,
device="cpu")` runs it on the CPU through the kernels' plain twins.
`ms/step` is the host clock around each frame's steps, closed by a device
synchronisation, so it includes the first steps' kernel builds.
"""

from __future__ import annotations

import argparse
import time

import torch

from .config import XLA_SOLVERS, SolverType
from .models import build, scene_names
from .parallel.batch import replicate
from .step import make_step
from .utils.metrics import statistics


def parse_solvers(spec: str) -> list[SolverType]:
    """A comma list of solver names, or "all" (the ten solvers of the
    per-world step)."""
    if spec == "all":
        return sorted(XLA_SOLVERS)
    return [SolverType[s.strip()] for s in spec.split(",")]


def run_scene(
    category: str,
    name: str,
    solvers: list[SolverType],
    steps: int = 240,
    hertz: float = 60.0,
    iterations: int = 4,
    extra_iterations: int = 2,
    warm_start: bool = True,
    multi_steps: int = 1,
    bucket_cap: int = 0,
    device="cuda",
    verbose: bool = True,
    render: str | None = None,
    render_every: int = 0,
    draw_options=None,
    **overrides,
):
    """Step the scene `steps` frames under each solver (a batch of one
    world each). `bucket_cap` is the contact bucket capacity of the XLA
    route (-1 auto, 0 dense); `overrides` go to `freeze` (for example
    broadphase="sap", incremental_coloring=False). `render`: an image path
    for the overlaid last frame, or with `render_every` the prefix of a
    frame every that many steps (stitched into an animated GIF when the
    path ends in .gif). Returns {solver: dict(scene, state, cfg, step, ms)}."""
    dt = 1.0 / hertz if hertz > 0 else 0.0
    dev = torch.device(device)
    runs = {}
    for solver in solvers:
        scene = build(category, name, solver)
        state, cfg = scene.freeze(
            device=dev, iterations=iterations, extra_iterations=extra_iterations, warm_start=warm_start,
            contact_bucket_cap=bucket_cap, **overrides,
        )
        runs[solver] = dict(scene=scene, state=replicate(state, 1), cfg=cfg, step=make_step(cfg), ms=0.0)

    gif = bool(render) and render.endswith(".gif")
    frames = []
    for i in range(steps):
        for r in runs.values():
            state, scene = r["state"], r["scene"]
            if scene.pre_step is not None:
                state = scene.pre_step(state)
            if scene.on_step is not None:
                new = scene.on_step(state, i)
                if new is not None:
                    state = new
            t0 = time.perf_counter()
            # multi_steps world-steps per frame (reference: samples/sample.cpp:130-137)
            for _ in range(multi_steps):
                state = r["step"](state, dt)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            r["ms"] += 1e3 * (time.perf_counter() - t0)
            r["state"] = state
        if render and render_every and (i + 1) % render_every == 0:
            fp = f"{render}.{i + 1:05d}.png"
            _render(runs, fp, f"{category}/{name} step {i + 1}", draw_options)
            frames.append(fp)

    if verbose:
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"=== {category}/{name} after {steps} steps (dt={dt:.5f}) on {where} ===")
        print(f"{'solver':15s} {'ms/step':>8s} {'bodies':>7s} {'contacts':>8s} {'pen(max)':>9s} {'KE':>12s} "
              f"{'overflow':>8s} {'cap-use':>8s}")
        for solver, r in runs.items():
            st = statistics(r["state"])
            # capacity headroom: peak utilization across the fixed tables
            # (the reference's proxy-count high-water analog, timer.h:8-17)
            cap = max(st.utilization.values())
            print(f"{solver.name:15s} {r['ms'] / steps:8.2f} {st.body_count:7d} {st.contact_count:8d}"
                  f" {st.max_penetration:9.4f} {st.kinetic_energy:12.3f} {st.color_overflow:8d} {cap:7.0%}")
    if render and not render_every:
        _render(runs, render, f"{category}/{name} step {steps}", draw_options)
    if gif and frames:
        _stitch_gif(frames, render)
    return runs


def _stitch_gif(frames, path, fps=15):
    """The frames as one animated GIF, the headless view of the reference
    testbed's overlaid worlds over time (samples/main.cpp:805-813); the
    frame files are removed."""
    import os

    from PIL import Image

    imgs = [Image.open(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    for im in imgs:
        im.close()
    for f in frames:
        os.remove(f)
    print(f"wrote {path} ({len(frames)} frames)")


def _render(runs, path, title, options=None):
    from .utils.draw import render_states

    render_states({s.name: r["state"] for s, r in runs.items()}, path=path, title=title, options=options)
    print(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", help="Category/Name, e.g. 'Contact/Pyramid'")
    p.add_argument("--list", action="store_true", help="list the scene catalog")
    p.add_argument("--solvers", default="PGS_NGS_BLOCK",
                   help="comma list or 'all' (the ten solvers)")
    p.add_argument("--steps", type=int, default=240)
    p.add_argument("--hertz", type=float, default=60.0)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--extra-iters", type=int, default=2)
    p.add_argument("--no-warm-start", action="store_true")
    p.add_argument("--multi-steps", type=int, default=1,
                   help="world-steps per frame (reference: samples/sample.cpp:130-137)")
    p.add_argument("--bucket-cap", type=int, default=0,
                   help="color-bucketed solve per-color capacity (-1 auto, 0 dense)")
    p.add_argument("--broadphase", choices=("grid", "sap"), default="grid",
                   help="pair finder: hashed grid or sweep and prune")
    p.add_argument("--mis", action="store_true", help="per-step MIS coloring (incremental_coloring=False)")
    p.add_argument("--render", default=None, help="output PNG path (or .gif with --render-every)")
    p.add_argument("--render-every", type=int, default=0)
    p.add_argument("--interactive", action="store_true",
                   help="open a live matplotlib window with the reference's key bindings (P/O/R, [/], ,/.) "
                        "and mouse drag (reference: samples/main.cpp:151-289)")
    p.add_argument("--interactive-gif", default=None, metavar="PATH",
                   help="record --steps headless interactive frames to an animated GIF instead of opening a window")
    # debug-draw layer toggles (reference: debug_draw.h:45-54)
    p.add_argument("--draw-aabbs", action="store_true")
    p.add_argument("--draw-mass", action="store_true")
    p.add_argument("--draw-contact-points", action="store_true")
    p.add_argument("--draw-contact-normals", action="store_true")
    p.add_argument("--draw-contact-impulses", action="store_true")
    p.add_argument("--draw-friction-impulses", action="store_true")
    args = p.parse_args(argv)

    if args.list or not args.scene:
        for cat, name in scene_names():
            print(f"{cat}/{name}")
        return 0

    category, name = args.scene.split("/", 1)
    solvers = parse_solvers(args.solvers)
    if args.render or args.interactive or args.interactive_gif:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            p.error("--render, --interactive and --interactive-gif need matplotlib (a GIF also PIL)")
    if args.interactive or args.interactive_gif:
        from .interactive import InteractiveTestbed

        tb = InteractiveTestbed(
            solvers, scene=f"{category}/{name}", hertz=args.hertz, iterations=args.iters,
            extra_iterations=args.extra_iters, warm_start=not args.no_warm_start,
        )
        if args.interactive_gif:
            out = tb.record_gif(args.interactive_gif, frames=args.steps)
            print(f"wrote {out}")
        else:
            tb.run()
        return 0
    from .utils.draw import DrawOptions

    opts = DrawOptions(
        draw_aabbs=args.draw_aabbs,
        draw_mass=args.draw_mass,
        draw_contact_points=args.draw_contact_points or args.draw_contact_normals
        or args.draw_contact_impulses or args.draw_friction_impulses,
        draw_contact_normals=args.draw_contact_normals,
        draw_contact_impulses=args.draw_contact_impulses,
        draw_friction_impulses=args.draw_friction_impulses,
    )
    run_scene(
        category, name, solvers,
        steps=args.steps, hertz=args.hertz, iterations=args.iters, extra_iterations=args.extra_iters,
        warm_start=not args.no_warm_start, multi_steps=args.multi_steps, bucket_cap=args.bucket_cap,
        render=args.render, render_every=args.render_every, draw_options=opts,
        broadphase=args.broadphase, incremental_coloring=not args.mis,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
