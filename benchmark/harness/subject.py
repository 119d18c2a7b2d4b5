"""The system under test, built from a configuration and a cell.

`program` is the port (`solver2d_tpu_torch`): its scene builder, its
`World.freeze`, its per-world step (`parallel.batched_step`) on the whole
[W, ...] batch. `control` puts the plain reference (`refsim`) in the
program's place with its state rounded to bfloat16 before and after each
step: the lower precision that a later change could be tempted by, which
the check must refuse. `reference` is the plain reference in float32,
which the check runs on the CPU.

The program is imported inside `program` only, so that the reference and
the tests of the harness load nothing of it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

ROUTES = {"fused": True, "xla": False}
LAYOUTS = {"dense": 0}
COLORINGS = {"incremental": True, "mis": False}


def freeze_kwargs(cfg_doc: dict, wl: dict) -> dict:
    """`World.freeze` settings of a cell: the configuration's, then the
    cell's route, layout, broadphase and colouring, then its own extras."""
    kw = dict(cfg_doc.get("freeze", {}))
    kw.update(
        use_fused_solver=ROUTES[wl["route"]],
        contact_bucket_cap=LAYOUTS[wl["layout"]],
        joint_bucket_cap=LAYOUTS[wl["layout"]],
        broadphase=wl["broadphase"],
        incremental_coloring=COLORINGS[wl["coloring"]],
    )
    kw.update(wl.get("freeze", {}))
    return kw


@dataclasses.dataclass
class Subject:
    """One world frozen, the step of a batch, its configuration, and the
    function that adds velocity deltas to a batch's live dynamic bodies."""

    world: object
    step: Callable
    config: object
    replicate: Callable
    apply_jitter: Callable


def _scene(scenes, solver_type, cfg_doc):
    scene = scenes[tuple(cfg_doc["scene"])](solver_type, **cfg_doc.get("scene_args", {}))
    if scene.on_step is not None:
        raise ValueError(f"scene {cfg_doc['scene']}: on_step hooks are not driven by the harness")
    return scene


def _hooked(pre_step, step):
    if pre_step is None:
        return step
    return lambda b: step(pre_step(b))


def program(cfg_doc: dict, wl: dict, device) -> Subject:
    import solver2d_tpu_torch as s2t
    from solver2d_tpu_torch.models import SCENES
    from solver2d_tpu_torch.parallel import apply_velocity_deltas

    scene = _scene(SCENES, s2t.SolverType[wl["solver"]], cfg_doc)
    world, cfg = scene.freeze(device=device, **freeze_kwargs(cfg_doc, wl))
    run, dt = s2t.batched_step(cfg), float(cfg_doc["dt"])
    return Subject(world, _hooked(scene.pre_step, lambda b: run(b, dt)), cfg, s2t.replicate, apply_velocity_deltas)


def reference(cfg_doc: dict, wl: dict, device="cpu") -> Subject:
    import refsim

    scene = _scene(refsim.SCENES, refsim.SolverType[wl["solver"]], cfg_doc)
    world, cfg = scene.freeze(device=device, **freeze_kwargs(cfg_doc, wl))
    dt = float(cfg_doc["dt"])
    return Subject(world, _hooked(scene.pre_step, lambda b: refsim.step(b, dt, cfg)), cfg, refsim.replicate,
                   refsim.apply_velocity_deltas)


def round_bf16(state):
    """The state with every float tensor rounded to bfloat16 (and held in
    its own dtype again)."""
    return state.map(lambda x: x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x)


def control(cfg_doc: dict, wl: dict, device) -> Subject:
    ref = reference(cfg_doc, wl, device)
    step = ref.step
    return dataclasses.replace(ref, step=lambda b: round_bf16(step(round_bf16(b))))


SUBJECTS = {"program": program, "control": control}
