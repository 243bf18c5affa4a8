"""The check that decides `correct` fails the control and every fault a
cell can have, planted under a run that skips only the look for a card."""

import pytest
import torch

from benchmark import harness
from benchmark.control import FAULTS, LevelBelow, LinkedBlocks
from benchmark.harness import Port

CPU = torch.device("cpu")


def _run(cell, bench, factory, seed=5):
    return harness.run_cell(cell, seed, 0.2, False, CPU, 0.0, bench=bench, port_factory=factory)


CELLS = ["lz4cli_default.real_files", "lz4cli_hc9.real_files", "lz4cli_default.random"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_is_correct(small_bench, cell):
    r = _run(cell, small_bench, Port)
    assert r["correct"] and all(v["value"] == 0 for k, v in r["compared"].items()
                                if k != "frames_checked")


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(small_bench, cell):
    r = _run(cell, small_bench, LinkedBlocks)
    assert not r["correct"]
    assert r["compared"]["frame_faults"]["value"] >= 1
    if cell.endswith(".real_files"):
        assert r["compared"]["block_faults"]["value"] >= 1


def test_the_level_below_is_not_correct(small_bench):
    r = _run("lz4cli_hc9.real_files", small_bench, LevelBelow)
    assert not r["correct"] and r["failed"] > 0
    assert r["compared"]["block_faults"]["value"] >= 1
    assert r["compared"]["frame_faults"]["value"] == 0


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["lz4cli_default.real_files", "lz4cli_default.random"])
def test_each_fault_is_not_correct(small_bench, cell, fault):
    r = _run(cell, small_bench, fault)
    assert not r["correct"] and r["failed"] > 0
