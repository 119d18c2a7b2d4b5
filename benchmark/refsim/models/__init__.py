"""Scene catalog: the reference's samples that the benchmark's
configurations name, as builders.

An own copy of the port's registry (reference: samples/sample.h:72-85,
sample.cpp:159-173): `register_scene(category, name)` decorates a builder
`fn(solver) -> Scene`; `SCENES[(category, name)]` looks it up. Every module
of this package is imported, so a later configuration's scene comes in as
a file of its own here.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Callable, Optional

from ..config import SolverType
from ..world import World


@dataclasses.dataclass
class Scene:
    """A built scene and its hooks.

    pre_step: state -> state applied to a [W, ...] batch before each step
              (in the reference, Rush's converging forces).
    on_step:  (state, step index) -> state or None, for discrete events
              (in the reference, Warm Start Energy's body destruction),
              which the harness does not drive.
    """

    world: World
    config_overrides: dict = dataclasses.field(default_factory=dict)
    pre_step: Optional[Callable] = None
    on_step: Optional[Callable] = None
    meta: dict = dataclasses.field(default_factory=dict)

    def freeze(self, **extra):
        """`World.freeze` with the scene's overrides, for the per-world step
        (`lane_solve=False`, the JAX `SimConfig`'s default) unless the
        caller asks otherwise."""
        return self.world.freeze(**{"lane_solve": False, **self.config_overrides, **extra})


SCENES: dict[tuple[str, str], Callable[[SolverType], Scene]] = {}


def register_scene(category: str, name: str):
    def deco(fn):
        SCENES[(category, name)] = fn
        fn.scene_key = (category, name)
        return fn

    return deco


for _m in pkgutil.iter_modules(__path__):
    importlib.import_module(f"{__name__}.{_m.name}")
