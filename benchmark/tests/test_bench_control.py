"""The check refuses what it must: the control (the plain reference in the
program's place, its state rounded to bfloat16) and faults planted under
the timed path, each driving the rest of a run. On the CPU at a small
size; the control at each cell's own size on the card (`cuda`)."""

import dataclasses

import pytest
import torch
from conftest import CELLS, run_small


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    res, _ = run_small(cell, subject_name="control")
    assert res["correct"] is False, res["checks"]


def unchanged(step):
    """A step that returns its state unchanged."""
    return lambda batch: batch


def half_left_out(step):
    """A step of the first half of the worlds only; the rest left as they were."""

    def run(batch):
        h = batch.bodies.v.shape[0] // 2
        done = step(batch.map(lambda x: x[:h]))
        return done.map(lambda x, y: torch.cat([x, y[h:]]), batch)

    return run


def answer_altered(step):
    """A step whose last world's first box ends 1 mm off where it was computed."""

    def run(batch):
        out = step(batch)
        pos = out.bodies.position.clone()
        pos[-1, 1, 0] += 1e-3
        return dataclasses.replace(out, bodies=dataclasses.replace(out.bodies, position=pos))

    return run


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    res, _ = run_small(cell, fault=fault)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card_at_the_cells_size(card, cell):
    import calibrate

    runs = list(calibrate.readings(cell, [], [4100000101, 4100000102, 4100000103], 1.0, device=card))
    assert len(runs) == 3
    for _, seed, res in runs:
        assert res["correct"] is False, (seed, res["checks"])
