"""Cells, configurations and metrics, found by the names in BENCHMARK.json.

A cell (`workloads/<name>.json`) names its configuration
(`configs/<name>.json`); a metric is a reader in `metrics/<name>.py`. No
list of them lives in code: a later cell, configuration or metric comes in
as files of its own and an entry of BENCHMARK.json.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r}: letters, digits, '_', '.' and '-', at most 64")
    return name


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_doc(root: str = REPO) -> dict:
    """The repo's BENCHMARK.json."""
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str) -> dict:
    """A cell's traffic file, with its name."""
    return dict(_json(os.path.join(BENCH_DIR, "workloads", _name("cell", name) + ".json")), name=name)


def config(name: str) -> dict:
    """A configuration's file, with its name."""
    return dict(_json(os.path.join(BENCH_DIR, "configs", _name("config", name) + ".json")), name=name)


def metrics_of(doc: dict, cell: str, kind: str) -> list[dict]:
    """The entries of `kind` ("end_to_end" or "per_layer") that cell reports:
    those that list it under "workloads", and those with no such list."""
    return [m for m in doc[kind] if "workloads" not in m or cell in m["workloads"]]


def cell_entry(doc: dict, cell: str) -> dict:
    for w in doc["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json; cells: {', '.join(w['name'] for w in doc['workloads'])}")


def load_metric(name: str):
    """The reader module of a metric: `metrics/<name>.py`, which defines
    read(ctx) -> float or None (None: nothing to read in this run)."""
    path = os.path.join(BENCH_DIR, "metrics", _name("metric", name) + ".py")
    spec = importlib.util.spec_from_file_location("benchmetric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
