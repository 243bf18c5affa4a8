"""The port's package boundaries: `lz4_tpu_torch` imports without JAX and
without the JAX package, its entry points refuse to run on a missing card
unless asked for the CPU, and its kernel wrappers take the plain versions
only for CPU tensors."""

import ast
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lz4_tpu_torch
from lz4_tpu_torch import block, frame, parallel
from lz4_tpu_torch.ops import build, decode, decode_stream, encode, encode_hc_passes, encode_stream
from lz4_tpu_torch.parallel import blocks

ROOT = Path(__file__).resolve().parents[1]


def test_import_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import lz4_tpu_torch, lz4_tpu_torch.frame, lz4_tpu_torch.parallel\n"
        "import lz4_tpu_torch.ops.encode, lz4_tpu_torch.ops.decode\n"
        "import lz4_tpu_torch.ops.encode_stream, lz4_tpu_torch.ops.decode_stream\n"
        "import lz4_tpu_torch.ops.encode_hc, lz4_tpu_torch.ops.xxh32\n"
        "import lz4_tpu_torch.ops.encode_hc_passes\n"
        "import lz4_tpu_torch.block, lz4_tpu_torch.block.incremental\n"
        "import lz4_tpu_torch.frame.aio, lz4_tpu_torch.legacy\n"
        "import lz4_tpu_torch.pickler, lz4_tpu_torch.cli\n"
        "import lz4_tpu_torch.ops.chain, lz4_tpu_torch.ops.decode_dense\n"
        "import lz4_tpu_torch.ops.encode_dense, lz4_tpu_torch.parallel.multihost\n"
        "import lz4_tpu_torch.ops.encode_continue, lz4_tpu_torch.ops.ubench\n"
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
    "frame.compress.chained", "frame.decompress.chained",
    "encode_blocks_chained_device", "block.encode", "block.decode",
    "frame.FrameReader", "frame.FrameWriter", "frame.open",
    "frame.decompress.two_frames", "block.partial_decode", "block.decode_into",
    "pickle", "legacy.wrap", "cli", "block.decode.unbounded", "make_mesh",
    "make_mesh.cuda", "multihost.compress_distributed",
    "multihost.decompress_distributed", "encode_chunked", "decode_chunked",
    "warmup_device", "frame.compress.canonical_chained", "encode_blocks_continue_device",
)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_need_the_card_unless_asked_for_cpu(name, monkeypatch, tmp_path):
    import io

    from lz4_tpu_torch import cli, legacy
    from lz4_tpu_torch.parallel import multihost

    data = b"abc" * 1000
    settings = frame.EncoderSettings(chain_blocks=False)
    blob = frame.compress(data, settings, device="cpu")
    chained = frame.compress(data * 30, device="cpu")
    comps = torch.zeros((1, 1024), dtype=torch.uint8)
    lens = torch.ones((1,), dtype=torch.int32)
    (tmp_path / "in.txt").write_bytes(data)
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
        "frame.compress.chained": lambda: frame.compress(data * 30),
        "frame.decompress.chained": lambda: frame.decompress(chained),
        "encode_blocks_chained_device": lambda: (
            blocks.encode_blocks_chained_device(data, 65536)
        ),
        "block.encode": lambda: block.encode(data, dictionary=b"xyz"),
        "block.decode": lambda: block.decode(b"\x00", 0),
        "frame.FrameReader": lambda: frame.FrameReader(io.BytesIO(blob)),
        "frame.FrameWriter": lambda: frame.FrameWriter(io.BytesIO()),
        "frame.open": lambda: frame.open(tmp_path / "out.lz4", "wb"),
        "frame.decompress.two_frames": lambda: frame.decompress(blob + blob),
        "block.partial_decode": lambda: block.partial_decode(b"\x00", 0),
        "block.decode_into": lambda: block.decode_into(b"\x00", bytearray(8)),
        "pickle": lambda: lz4_tpu_torch.pickle(data),
        "legacy.wrap": lambda: legacy.wrap(data),
        "cli": lambda: cli.main(["compress", str(tmp_path / "in.txt"),
                                 str(tmp_path / "in.lz4")]),
        "block.decode.unbounded": lambda: block.decode(b"\x00"),
        "make_mesh": lambda: parallel.make_mesh(),
        "make_mesh.cuda": lambda: parallel.make_mesh(["cuda:0", "cuda:0"]),
        "multihost.compress_distributed": lambda: multihost.compress_distributed(data),
        "multihost.decompress_distributed": lambda: multihost.decompress_distributed(blob),
        "encode_chunked": lambda: blocks.encode_chunked(comps, lens, 16),
        "decode_chunked": lambda: blocks.decode_chunked(comps, lens, 16),
        "warmup_device": lambda: parallel.warmup_device(),
        "frame.compress.canonical_chained": lambda: frame.compress(
            data * 30, frame.EncoderSettings(geometry="canonical")),
        "encode_blocks_continue_device": lambda: blocks.encode_blocks_continue_device(
            data * 30, 65536),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name]()
    assert not (tmp_path / "out.lz4").exists()


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    data = np.frombuffer(b"hello hello hello hello hello!!", np.uint8)
    bufs = torch.zeros((1, 64), dtype=torch.uint8)
    bufs[0, : data.size] = torch.from_numpy(data.copy())
    lens = torch.tensor([data.size], dtype=torch.int32)
    e0, d0 = encode.encode_blocks.launches, decode.decode_blocks.launches
    h0, o0 = encode_stream.encode_windows_hc.launches, encode_stream.encode_windows_opt.launches
    passes = [encode_hc_passes.hc_episodes, encode_hc_passes.hc_parse]
    p0 = [f.launches for f in passes]
    for level in (3, 9, 12):
        hc = encode.encode_blocks(bufs, lens, 64, level)
        assert hc[0].device.type == "cpu" and int(hc[2][0]) == 0
    assert encode_stream.encode_windows_hc.launches == h0
    assert encode_stream.encode_windows_opt.launches == o0
    assert [f.launches for f in passes] == p0
    out, clens, errs = encode.encode_blocks(bufs, lens, 64)
    comps = torch.zeros((1, 128), dtype=torch.uint8)
    comps[0, : int(clens[0])] = out[0, : int(clens[0])]
    dec, dlens, derrs = decode.decode_blocks(comps, clens, 64)
    assert out.device.type == "cpu" and dec.device.type == "cpu"
    assert int(errs[0]) == 0 and int(derrs[0]) == 0
    assert dec[0, : int(dlens[0])].numpy().tobytes() == data.tobytes()
    assert encode.encode_blocks.launches == e0
    assert decode.decode_blocks.launches == d0


def test_cpu_tensors_run_the_plain_streaming_versions_and_count_no_launch():
    data = b"hello hello hello hello hello!!" * 5000
    e0, c0 = encode_stream.encode_blocks_stream.launches, decode_stream.decode_chain.launches
    h0, o0 = encode_stream.encode_windows_hc.launches, encode_stream.encode_windows_opt.launches
    k0 = dict(decode_stream.chain_kernel_launches)
    s0 = decode_stream.decode_blocks_stream.launches
    blob = frame.compress(data, device="cpu")
    assert frame.decompress(blob, device="cpu") == data
    for level in (9, 12):
        hc = frame.compress(data, frame.EncoderSettings(compression_level=level), device="cpu")
        assert frame.decompress(hc, device="cpu") == data
    assert encode_stream.encode_windows_hc.launches == h0
    assert encode_stream.encode_windows_opt.launches == o0
    bufs = torch.zeros((1, 64), dtype=torch.uint8)
    out, clens, errs = encode_stream.encode_blocks_stream(
        bufs, torch.tensor([64], dtype=torch.int32), 64
    )
    assert out.device.type == "cpu" and int(errs[0]) == 0
    dec, dlens, derrs = decode_stream.decode_blocks_stream(
        out, clens, 64, torch.zeros((1, 65536), dtype=torch.uint8),
        torch.tensor([0], dtype=torch.int32))
    assert dec.device.type == "cpu" and int(derrs[0]) == 0 and int(dlens[0]) == 64
    assert encode_stream.encode_blocks_stream.launches == e0
    assert decode_stream.decode_chain.launches == c0
    assert decode_stream.chain_kernel_launches == k0
    assert decode_stream.decode_blocks_stream.launches == s0


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
    assert build._library("encode_stream") == before["encode_stream"]


def test_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    for f in build._CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    assert sorted(p.name for p in tmp_path.glob("*.cuh")) == [
        "lz4_decode_body.cuh", "lz4_encode_body.cuh", "lz4_hc_body.cuh",
    ]
    before = {n: build._library(n) for n in build.KERNEL_SOURCES}
    for header in ("lz4_encode_body.cuh", "lz4_hc_body.cuh"):
        with open(tmp_path / header, "a") as f:
            f.write("// edited\n")
        after = {n: build._library(n) for n in build.KERNEL_SOURCES}
        assert all(after[n] != before[n] for n in build.KERNEL_SOURCES)
        before = after


def test_launch_check_raises_on_a_cuda_error():
    build.check(0, "decode")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        build.check(9, "decode")


def test_public_names():
    for name in lz4_tpu_torch.__all__:
        assert hasattr(lz4_tpu_torch, name)
    assert issubclass(lz4_tpu_torch.LZ4Error, ValueError)
    assert issubclass(frame.LZ4FormatError, ValueError)


def _c_signatures():
    """Each `extern "C"` entry point of csrc/*.cu: its parameters as
    ctypes kinds (a pointer, an int, a long long)."""
    import re

    sigs = {}
    for src in build._CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                       src.read_text(), flags=re.S):
            kinds = []
            for prm in filter(None, (x.strip() for x in params.split(","))):
                kinds.append(ctypes.c_void_p if "*" in prm else
                             ctypes.c_longlong if "long long" in prm else ctypes.c_int)
            sigs[name] = kinds
    return sigs


BINDINGS = {"decode": ("lz4t_decode_warp",), "decode_stream": (),
            "encode_stream": (), "encode_opt": (), "encode_hc_passes": (),
            "xxh32": ("lz4t_xxh32", "lz4t_xxh32_stripes"),
            "encode_continue": ("lz4t_encode_continue", "lz4t_hash5_rows"),
            "ubench": ("lz4t_ubench",)}


@pytest.mark.parametrize("module", sorted(BINDINGS))
def test_bindings_match_the_c_signatures(module, monkeypatch):
    """Every argtypes list a wrapper sets holds one entry per parameter of
    its C entry point, of the same kind: ctypes passes an argument past
    the list as a 32-bit int, so a pointer there is cut."""
    import importlib

    mod = importlib.import_module(f"lz4_tpu_torch.ops.{module}")

    class Fn:
        argtypes = None
        restype = None

        def __call__(self, *args):
            return getattr(mod, "SEG", 0)

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    monkeypatch.setattr(mod, "load", lambda name: lib)
    monkeypatch.setattr(mod, "_lib", None)
    mod._kernel()
    sigs = _c_signatures()
    bound = {k: v for k, v in vars(lib).items() if v.argtypes is not None}
    assert bound
    assert set(BINDINGS[module]) <= set(bound)  # the entries this port added
    for name, fn in bound.items():
        assert list(fn.argtypes) == sigs[name], name
