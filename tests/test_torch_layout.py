"""The port's package boundaries: `lz4_tpu_torch` imports without JAX and
without the JAX package, its entry points refuse to run on a missing card
unless asked for the CPU, and its kernel wrappers take the plain versions
only for CPU tensors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lz4_tpu_torch
from lz4_tpu_torch import frame, parallel
from lz4_tpu_torch.ops import build, decode, encode
from lz4_tpu_torch.parallel import blocks

ROOT = Path(__file__).resolve().parents[1]


def test_import_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import lz4_tpu_torch, lz4_tpu_torch.frame, lz4_tpu_torch.parallel\n"
        "import lz4_tpu_torch.ops.encode, lz4_tpu_torch.ops.decode\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'lz4_tpu' or m.startswith('lz4_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


def _sources():
    files = sorted((ROOT / "lz4_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    banned = [
        n for n in names
        if n.split(".")[0] in ("jax", "jaxlib", "lz4_tpu")
    ]
    assert not banned, banned


ENTRY_POINTS = (
    "frame.compress", "frame.decompress", "parallel.encode_blocks",
    "parallel.decode_blocks", "encode_blocks_device", "decode_blocks_device",
)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_need_the_card_unless_asked_for_cpu(name, monkeypatch):
    data = b"abc" * 1000
    settings = frame.EncoderSettings(chain_blocks=False)
    blob = frame.compress(data, settings, device="cpu")
    comps = torch.zeros((1, 1024), dtype=torch.uint8)
    lens = torch.ones((1,), dtype=torch.int32)
    calls = {
        "frame.compress": lambda: frame.compress(data, settings),
        "frame.decompress": lambda: frame.decompress(blob),
        "parallel.encode_blocks": lambda: parallel.encode_blocks(data, 65536),
        "parallel.decode_blocks": lambda: parallel.decode_blocks(
            [b"\x00"], 65536
        ),
        "encode_blocks_device": lambda: blocks.encode_blocks_device(
            comps, lens, 1024
        ),
        "decode_blocks_device": lambda: blocks.decode_blocks_device(
            comps, lens, 1024
        ),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name]()


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    data = np.frombuffer(b"hello hello hello hello hello!!", np.uint8)
    bufs = torch.zeros((1, 64), dtype=torch.uint8)
    bufs[0, : data.size] = torch.from_numpy(data.copy())
    lens = torch.tensor([data.size], dtype=torch.int32)
    e0, d0 = encode.encode_blocks.launches, decode.decode_blocks.launches
    out, clens, errs = encode.encode_blocks(bufs, lens, 64)
    comps = torch.zeros((1, 128), dtype=torch.uint8)
    comps[0, : int(clens[0])] = out[0, : int(clens[0])]
    dec, dlens, derrs = decode.decode_blocks(comps, clens, 64)
    assert out.device.type == "cpu" and dec.device.type == "cpu"
    assert int(errs[0]) == 0 and int(derrs[0]) == 0
    assert dec[0, : int(dlens[0])].numpy().tobytes() == data.tobytes()
    assert encode.encode_blocks.launches == e0
    assert decode.decode_blocks.launches == d0


def test_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parallel.encode_blocks(b"x", 65536, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parallel.decode_blocks([b"\x00"], 65536, mesh=object(), device="cpu")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("decode")


def test_build_is_keyed_by_the_source(monkeypatch, tmp_path):
    for n in build.KERNEL_SOURCES:
        (tmp_path / f"{n}.cu").write_bytes((build._CSRC / f"{n}.cu").read_bytes())
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    before = {n: build._library(n) for n in build.KERNEL_SOURCES}
    assert len(set(before.values())) == len(before)
    with open(tmp_path / "decode.cu", "a") as f:
        f.write("// edited\n")
    assert build._library("decode") != before["decode"]
    assert build._library("encode") == before["encode"]


def test_launch_check_raises_on_a_cuda_error():
    build.check(0, "decode")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        build.check(9, "decode")


def test_public_names():
    for name in lz4_tpu_torch.__all__:
        assert hasattr(lz4_tpu_torch, name)
    assert issubclass(lz4_tpu_torch.LZ4Error, ValueError)
    assert issubclass(frame.LZ4FormatError, ValueError)
