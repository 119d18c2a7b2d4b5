"""Scene catalog: the reference's samples as builders.

An own copy of the JAX package's registry (reference: samples/sample.h:72-85,
sample.cpp:159-173): `register_scene(category, name)` decorates a builder
`fn(solver) -> Scene`; `SCENES[(category, name)]` looks it up;
`scene_names()` lists them sorted by category and name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..config import SolverType
from ..world import World


@dataclasses.dataclass
class Scene:
    """A built scene and its hooks.

    pre_step: state -> state applied to a [W, ...] batch before each step
              (Rush's converging forces, sample_contact.cpp:631-650).
    on_step:  (state, step index) -> state or None, for discrete events
              (Warm Start Energy's body destruction at step 120,
              sample_contact.cpp:101-110).
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


def scene_names():
    return sorted(SCENES.keys())


def build(category: str, name: str, solver: SolverType = SolverType.PGS_NGS_BLOCK) -> Scene:
    """Build a registered scene. The default solver is the JAX package's
    (and the reference's), PGS_NGS_BLOCK."""
    try:
        factory = SCENES[(category, name)]
    except KeyError:
        known = ", ".join(f"{c}/{n}" for c, n in scene_names())
        raise SystemExit(f"unknown scene '{category}/{name}'. Known scenes: {known}") from None
    return factory(solver)


from . import contact_scenes  # noqa: E402,F401
from . import far_scenes  # noqa: E402,F401
from . import joint_scenes  # noqa: E402,F401
