"""The harness: BENCHMARK.json against the contract, each configuration,
mix and metric loaded by name, a cell added as files alone, and the
modules a run loads."""

import json
import re
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

from benchmark import harness
from benchmark.trace import Call, Trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return harness.load_spec()


def test_benchmark_json_keeps_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert c["source"].startswith("https://") and len(c["why"]) <= 200
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert {"setup_s", "compress_GBps", "decompress_GBps", "ratio"} <= e2e
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and len(m["layer"]) <= 200
    assert len(json.dumps(spec)) < 64 << 10


@pytest.mark.parametrize("kind", ["configs", "traffic"])
def test_each_named_file_loads(kind):
    spec = _spec()
    key = {"configs": "config", "traffic": "traffic"}[kind]
    for name in {w[key] for w in spec["workloads"]}:
        data = harness.load_json(kind, name)
        if kind == "configs":
            assert data["reduced"] == [] and len(data["source"]) <= 200
            harness.encoder_settings(data)
        else:
            assert data["object_bytes"] > 0 and data["parts"]


def test_each_metric_reader_loads_and_reads():
    t = Trace([Call("compress", 0.0, 10.0, 100, 50, [("k", 1.0, 2.0), ("Memcpy HtoD", 2.0, 3.0)]),
               Call("decompress", 10.0, 20.0, 100, 50, [("k", 11.0, 12.0)])])
    for m in _spec()["per_layer"]:
        value = harness.load_metric(m["name"]).read(t)
        assert isinstance(value, float), m["name"]
        assert harness.load_metric(m["name"]).read(Trace([])) is None


def test_a_cell_is_added_as_files_alone(small_bench):
    """A new configuration, mix, metric and cell: new files and entries in
    BENCHMARK.json, no edit to a file that is there."""
    (small_bench / "configs" / "tiny_l3.json").write_text(json.dumps({
        "source": "test", "compression_level": 3, "block_size": 65536,
        "chain_blocks": False, "content_checksum": True, "assumed": [], "reduced": []}))
    (small_bench / "traffic" / "tiny_pieces.json").write_text(json.dumps({
        "object_bytes": 70_000, "callers": 1, "calls": ["compress", "decompress"],
        "parts": [{"kind": "pool", "pool": "real", "piece_bytes": 9000, "share": [1, 2]},
                  {"kind": "uniform"}]}))
    (small_bench / "metrics" / "calls_traced.py").write_text(
        "def read(t):\n    return float(len(t.calls)) if t.calls else None\n")
    spec = json.loads((small_bench.parent / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_l3", "source": "https://example.org",
                            "file": "benchmark/configs/tiny_l3.json", "reduced": [], "why": "t"})
    spec["workloads"].append({"name": "tiny_l3.pieces", "config": "tiny_l3",
                              "traffic": "tiny_pieces", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "Device (one H100)",
                              "moves": "compress_GBps", "workloads": ["tiny_l3.pieces"]})
    (small_bench.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.run_cell("tiny_l3.pieces", 3, 0.2, False, torch.device("cpu"), 0.0,
                         bench=small_bench)
    assert r["correct"] and set(r["metrics"]) == {"compress_GBps", "decompress_GBps",
                                                   "ratio", "setup_s"}
    assert harness.load_metric("calls_traced", small_bench).read(Trace([Call("c", 0, 1, 1, 1)])) == 1.0
    assert [m["name"] for m in harness.metrics_of(spec, "per_layer", "tiny_l3.pieces")][-1] == "calls_traced"


def test_the_result_line_has_the_contracts_keys(small_bench):
    r = harness.run_cell("lz4cli_default.random", 2**31 + 3, 0.2, False, torch.device("cpu"),
                         0.0, bench=small_bench)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert r["metrics"]["ratio"]["unit"] == "raw/frame"
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_nothing_a_run_imports_is_jax():
    """The whole import graph of a run, the port's CPU route included:
    no module whose top-level name is jax, jaxlib, flax or lz4_tpu."""
    code = ("import sys, torch; sys.argv = ['x']; import benchmark.run, benchmark.harness as h, "
            "benchmark.control; from lz4_tpu_torch import frame; "
            "frame.decompress(frame.compress(b'x' * 1000, device='cpu'), device='cpu'); "
            "print(' '.join(h.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == ""
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "lz4_tpu")


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")), ids=lambda p: p.name)
def test_no_source_under_benchmark_imports_jax(path):
    import ast

    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & set(harness.FORBIDDEN)
    if path.name == "reference.py":
        assert not tops & {"lz4_tpu_torch", "torch"}


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lz4cli_default.real_files",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lz4cli_default.random",
                        "--seed", "4", "--seconds", "1", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and "breakdown" in r
