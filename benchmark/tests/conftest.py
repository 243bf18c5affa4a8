"""Shared fixtures of the benchmark's own tests (CPU; `gpu` marks those
that need a card).  Run from the repository's root:

    python -m pytest benchmark/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SMALL = 150_000  # three 64 KB blocks on the CPU's plain versions


@pytest.fixture
def small_bench(tmp_path):
    """A copy of the benchmark beside a copy of BENCHMARK.json, every
    object cut to `SMALL` bytes and every block to 64 KB, so that a run
    on the CPU's plain versions takes seconds; returns its directory."""
    bench = tmp_path / "benchmark"
    for part in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / part, bench / part)
    shutil.copy(ROOT / "benchmark" / "launch_counters.json", bench)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in (bench / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["object_bytes"] = SMALL
        for part in mix["parts"]:
            if "piece_bytes" in part:
                part["piece_bytes"] = SMALL // 3  # three kinds of file in a small object
        path.write_text(json.dumps(mix))
    for path in (bench / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config["block_size"] = 65536
        path.write_text(json.dumps(config))
    return bench


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
