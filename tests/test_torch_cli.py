"""The port's command line on the CPU (``--device cpu``), held to
`lz4_tpu.cli` (``--backend host``): the same files from compress (every
option), decompress, roundtrip, pickle and unpickle, default output
names, and stdin input written to stdout."""

import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

import bench
from lz4_tpu.cli import main as jmain
from lz4_tpu_torch.cli import main as tmain

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def sample_file(tmp_path):
    p = tmp_path / "sample.txt"
    p.write_bytes(bench.make_corpus(50_000, seed=71))
    return p


@pytest.mark.parametrize("opts", [
    [], ["-l", "9", "-B", "5", "-BD", "-BX", "--store-size"],
    ["--no-content-checksum", "-B", "6"], ["-l", "3", "-BD"],
], ids=["default", "all_options", "no_checksum", "hc_chained"])
def test_compress_and_decompress_equal_the_jax_cli(tmp_path, sample_file, opts):
    ours, theirs = tmp_path / "o.lz4", tmp_path / "t.lz4"
    assert tmain(["compress", "--device", "cpu", *opts, str(sample_file), str(ours)]) == 0
    assert jmain(["compress", "--backend", "host", *opts, str(sample_file), str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    back = tmp_path / "o.out"
    assert tmain(["decompress", "--device", "cpu", str(theirs), str(back)]) == 0
    assert back.read_bytes() == sample_file.read_bytes()


def test_roundtrip_command(sample_file, capsys):
    assert tmain(["roundtrip", "--device", "cpu", "-l", "0", str(sample_file)]) == 0
    assert "OK" in capsys.readouterr().out


def test_pickle_unpickle(tmp_path, sample_file):
    ours, theirs, back = tmp_path / "p.bin", tmp_path / "q.bin", tmp_path / "p.out"
    assert tmain(["pickle", "--device", "cpu", "-l", "9", str(sample_file), str(ours)]) == 0
    assert jmain(["pickle", "-l", "9", str(sample_file), str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert tmain(["unpickle", "--device", "cpu", str(ours), str(back)]) == 0
    assert back.read_bytes() == sample_file.read_bytes()


def test_default_output_names(tmp_path, sample_file, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tmain(["compress", "--device", "cpu", str(sample_file)]) == 0
    assert os.path.exists(str(sample_file) + ".lz4")
    os.remove(sample_file)
    assert tmain(["decompress", "--device", "cpu", str(sample_file) + ".lz4"]) == 0
    assert sample_file.exists()
    assert tmain(["pickle", "--device", "cpu", str(sample_file)]) == 0
    assert tmain(["unpickle", "--device", "cpu", str(sample_file) + ".lz4pickle"]) == 0
    assert (tmp_path / "sample.txt.lz4pickle.out").read_bytes() == sample_file.read_bytes()


def test_stdin_input_goes_to_stdout(sample_file, monkeypatch, capsysbinary):
    data = sample_file.read_bytes()

    class Stdin:
        buffer = io.BytesIO(data)

    monkeypatch.setattr(sys, "stdin", Stdin)
    assert tmain(["compress", "--device", "cpu", "-"]) == 0
    blob = capsysbinary.readouterr().out
    Stdin.buffer = io.BytesIO(blob)
    assert tmain(["decompress", "--device", "cpu", "-"]) == 0
    assert capsysbinary.readouterr().out == data


def test_python_dash_m(tmp_path, sample_file):
    out = tmp_path / "m.lz4"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "lz4_tpu_torch", "compress", "--device", "cpu",
         str(sample_file), str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "->" in res.stderr and out.exists()
