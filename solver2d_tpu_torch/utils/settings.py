"""Testbed settings persistence.

An own copy of the JAX package's `utils/settings.py`: the reference's JSON
settings save and load (reference: samples/settings.{h,cpp}: 60 Hz, 4
primary iterations, 2 secondary, warm starting on, draw toggles) with the
stdlib json module in place of the vendored jsmn tokenizer. The file
format is the same, so a file either package writes loads in the other."""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class Settings:
    """reference: samples/settings.h:8-37"""

    sample_index: int = 0
    window_width: int = 1920
    window_height: int = 1080
    hertz: float = 60.0
    velocity_iterations: int = 4   # "primary iterations"
    relax_iterations: int = 2      # "secondary iterations"
    warm_start: bool = True
    multi_step: int = 1
    enable_sleep: bool = False
    draw_shapes: bool = True
    draw_joints: bool = True
    draw_aabbs: bool = False
    draw_contact_points: bool = False
    draw_contact_normals: bool = False
    draw_contact_impulses: bool = False
    draw_friction_impulses: bool = False
    draw_mass: bool = False
    draw_stats: bool = False
    solvers_enabled: list = dataclasses.field(default_factory=lambda: ["PGS_NGS_BLOCK"])

    DEFAULT_PATH = "settings.json"

    def save(self, path: str | None = None):
        """reference: settings.cpp:42-70"""
        with open(path or self.DEFAULT_PATH, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str | None = None) -> "Settings":
        """reference: settings.cpp:72-121 — missing/partial files fall back to
        defaults field-by-field."""
        path = path or cls.DEFAULT_PATH
        s = cls()
        if not os.path.exists(path):
            return s
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return s
        for field in dataclasses.fields(cls):
            if field.name in data:
                setattr(s, field.name, data[field.name])
        return s
