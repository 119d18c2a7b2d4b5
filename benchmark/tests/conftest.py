"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the repo root on the import path, and small versions of the cells (a
base-4 pyramid, a 4-plank bridge, 4 worlds) that run on the CPU, where
each kernel wrapper of the program runs its plain twin."""

import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (REPO, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_SCENE = {"Pyramid": ({"base_count": 4}, {"max_contacts": 64}), "Bridge": ({"count": 4}, {})}


def small_cell(cell: str, worlds: int = 4, **variant):
    """(workload, config) of a cell at a size the CPU runs in a second, with
    the fields of `variant` in place of the cell's."""
    from harness import cells

    wl = cells.workload(cell)
    cfg = cells.config(wl["config"])
    args, freeze = SMALL_SCENE[cfg["scene"][1]]
    cfg = dict(cfg, scene_args=args, freeze=dict(cfg["freeze"], **freeze))
    return dict(wl, worlds=worlds, **variant), cfg


def run_small(cell, seed=2**31 + 7, traced=False, subject_name="program", fault=None, metrics=None, worlds=4,
              seconds=0.3, **variant):
    """A whole run of a small cell on the CPU; returns (result, log lines)."""
    from harness import cells, core

    wl, cfg = small_cell(cell, worlds, **variant)
    doc = cells.benchmark_doc()
    metrics = cells.metrics_of(doc, cell, "per_layer" if traced else "end_to_end") if metrics is None else metrics
    readers = {m["name"]: cells.load_metric(m["name"]) for m in metrics}
    lines = []
    res = core.run(wl, cfg, metrics, readers, seed, seconds, traced, "cpu", lines.append, time.perf_counter(),
                   subject_name=subject_name, fault=fault)
    return res, lines


CELLS = ("pyramid20.tgs_soft.fused.w4096", "bridge160.tgs_soft.fused.w4096", "pyramid20.pgs_ngs_block.xla.w1024")
# the paths of the reference that a cell can take by its own fields: the
# sweep and prune, the MIS colouring, and the XLA route's joint solve
VARIANTS = {
    "sap": ("pyramid20.pgs_ngs_block.xla.w1024", {"broadphase": "sap", "freeze": {"sap_window": 48}}),
    "mis": ("pyramid20.pgs_ngs_block.xla.w1024", {"coloring": "mis"}),
    "sap.fused": ("pyramid20.tgs_soft.fused.w4096", {"broadphase": "sap", "freeze": {"sap_window": 48}}),
    "bridge.xla": ("bridge160.tgs_soft.fused.w4096", {"solver": "PGS_NGS_BLOCK", "route": "xla"}),
}


@pytest.fixture
def card():
    """Skips the test where this machine has no NVIDIA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
