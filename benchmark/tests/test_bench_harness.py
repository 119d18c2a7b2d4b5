"""The harness on the CPU: its arguments, the discovery of cells and
metrics by name, the bound arithmetic, the result's line, the isolation
of the harness and the reference, and the reference against the port's
CPU path."""

import json
import os
import subprocess
import sys
from collections import namedtuple

import pytest
import torch
from conftest import BENCH, CELLS, REPO, VARIANTS, run_small

from harness import bounds, cells, check

sys.path.insert(0, BENCH)
import run as bench_run  # noqa: E402


def test_arguments():
    a = bench_run.parse(["--workload", "x", "--seed", str(2**31 + 5), "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x", 2**31 + 5, 10.0, 1)
    assert bench_run.parse(["--workload", "x", "--seed", "3", "--seconds", "2.5"]).trace == 0
    for bad in (["--workload", "x", "--seed", "1", "--seconds", "0"],
                ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"],
                ["--seed", "1", "--seconds", "1"]):
        with pytest.raises(SystemExit):
            bench_run.parse(bad)


def test_every_name_of_the_benchmark_is_found():
    doc = cells.benchmark_doc()
    for w in doc["workloads"]:
        wl = cells.workload(w["name"])
        assert wl["config"] == w["config"]
        cfg = cells.config(w["config"])
        assert "frozen_mismatch" in wl["limits"] and set(wl["limits"]) <= set(check.NUMBERS)
        assert cfg["reduced"] == []
        for kind in ("end_to_end", "per_layer"):
            assert cells.metrics_of(doc, w["name"], kind), (w["name"], kind)
    for c in doc["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert callable(cells.load_metric(m["name"]).read)
    with pytest.raises(ValueError):
        cells.workload("../x")
    with pytest.raises(KeyError):
        cells.cell_entry(doc, "no.such.cell")


def test_metrics_of_a_cell_follow_their_lists():
    doc = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["c2"]}], "per_layer": []}
    assert [m["name"] for m in cells.metrics_of(doc, "c1", "end_to_end")] == ["a"]
    assert [m["name"] for m in cells.metrics_of(doc, "c2", "end_to_end")] == ["a", "b"]


def test_every_span_names_a_function_of_the_program():
    import importlib

    for name in os.listdir(os.path.join(BENCH, "metrics")):
        mod = cells.load_metric(name[:-3])
        for module, attr in list(getattr(mod, "SPANS", ())) + list(getattr(mod, "CAPTURE", ())):
            assert callable(getattr(importlib.import_module(module), attr)), (name, module, attr)


def test_k2_bytes_counted_by_hand():
    # 1 world, 2 slots, 3 shape rows: per slot 2 poses (2 x 16 bytes) and
    # the GJK cache (7 ints, 28) in, 12 floats and 10 ints (88) out; 2 shape
    # indices (8) a slot; 34 floats a shape row
    geom = torch.zeros(3, 34)
    args = (geom, None, None, torch.zeros(1, 4, 2), None, None)
    assert bounds.k2_bytes(args) == 2 * 60 + 2 * 88 + 2 * 8 + 3 * 136 == 720
    ms, by, nbytes, ops = bounds.k2_bound(args, ops=0.0)
    assert (by, nbytes) == ("bytes", 720) and ms == pytest.approx(720 / 3.35e12 * 1e3)
    ms, by, _, _ = bounds.k2_bound(args, ops=67e9)
    assert by == "ops" and ms == pytest.approx(1.0)


def test_k2_ops_of_one_sat_box_pair():
    # two boxes (4 vertices each), 2 GJK trips, the SAT path: the count of
    # k2_ops term by term
    one = torch.ones(1, 1, dtype=torch.bool)
    no = torch.zeros(1, 1, dtype=torch.bool)
    four = torch.full((1, 1), 4, dtype=torch.int32)
    work = dict(trips=torch.full((1, 1), 2, dtype=torch.int32), ca=four, cb=four, sat=one, vv=no, ev=no, cc=no,
                pc=no)
    trip = 54 + 15 + 2 + 3 * 8
    path = 7 * 8 + 10 * 16 + 63
    assert bounds.k2_ops(work) == 15 + 14 * 4 + 2 * trip + 54 + 42 + path + 25


def test_k1_bytes_counted_by_hand():
    from refsim.config import SolverType
    from refsim.solvers.fused_solve import C_ACTIVE, J_ACTIVE

    X = namedtuple("X", "cint jint bs body_const scal")
    cint = torch.zeros(1, 3, 4, dtype=torch.int32)
    cint[0, :2, 3] = C_ACTIVE  # 2 active contacts of 3 slots
    jint = torch.zeros(1, 2, 4, dtype=torch.int32)
    jint[0, 0, 3] = J_ACTIVE  # 1 live joint of 2 slots
    x = X(cint, jint, torch.zeros(1, 5, 8), torch.zeros(1, 5, 8), torch.zeros(2))
    slots = (12 + 8) * 4
    contacts = 2 * (27 + 8) * 4  # TGS_Soft reads 27 float columns
    joints = 1 * (23 + 10) * 4
    body = (2 * 40 + 40) * 4
    assert bounds.k1_bytes(x, SolverType.TGS_SOFT, True) == slots + contacts + joints + body + 8
    assert bounds.k1_contact_columns(SolverType.SOFT_STEP, True) == 35
    assert bounds.k1_contact_columns(SolverType.PGS_SOFT, False) == 27


def test_forbidden_names_are_compared_whole():
    f = bench_run.forbidden_modules
    assert f({"solver2d_tpu_torch": 1, "solver2d_tpu_torch.step": 1, "jaxtyping": 1, "flaxen": 1}) == []
    assert f({"solver2d_tpu.step": 1, "jax.numpy": 1, "torch": 1}) == ["jax", "solver2d_tpu"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_no_program_no_result(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's folder
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=BENCH, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, REPO])))
    assert out.returncode == 0, out.stderr[-3000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_the_reference_refuses_what_it_does_not_copy():
    from conftest import small_cell
    from harness import subject

    for variant in ({"solver": "TGS_NGS", "route": "xla"}, {"solver": "XPBD", "route": "xla"}):
        wl, cfg = small_cell("pyramid20.pgs_ngs_block.xla.w1024", **variant)
        ref = subject.reference(cfg, wl)
        with pytest.raises(NotImplementedError):
            ref.step(ref.replicate(ref.world, 1))


def test_the_reference_loads_nothing_of_the_program_or_of_jax():
    top = _modules_after("import refsim, refsim.models, refsim.solvers.loops, refsim.step")
    assert not top & {"jax", "jaxlib", "flax", "solver2d_tpu", "solver2d_tpu_torch"}


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, os, time\nsys.path.insert(0, 'tests')\nfrom conftest import run_small, CELLS\n"
            "for c in CELLS:\n    run_small(c, traced=True)\n")
    top = _modules_after(code)
    assert "solver2d_tpu_torch" in top and "refsim" in top
    assert not top & {"jax", "jaxlib", "flax", "solver2d_tpu"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_last_line(cell):
    res, lines = run_small(cell, traced=True)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    assert {"broadphase_ms", "narrowphase_ms", "coloring_ms", "post_solve_ms"} <= set(res["metrics"])
    assert ("fused_solve_ms" in res["metrics"]) == (".fused." in cell)
    assert ("xla_solve_ms" in res["metrics"]) == (".xla." in cell)
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}, name
    json.loads(json.dumps(res))
    e2e, _ = run_small(cell)
    assert set(e2e["metrics"]) >= {"world_steps_per_s", "setup_s"}
    assert "breakdown" not in e2e


@pytest.mark.parametrize("cell, variant", [(c, {}) for c in CELLS] + list(VARIANTS.values()),
                         ids=list(CELLS) + list(VARIANTS))
def test_reference_equals_the_port_on_the_cpu(cell, variant):
    # the port's CPU path runs the plain twins of K1 and K2: every step the
    # check follows equals the reference's bit for bit
    res, lines = run_small(cell, **variant)
    assert res["correct"]
    assert all(c["value"] == 0 for c in res["checks"].values()), res["checks"]
    assert sum("from the start" in ln for ln in lines) == 3 and any("last step" in ln for ln in lines)
