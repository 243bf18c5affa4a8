"""Canonical chained FAST frames on the CPU: kernel F's plain versions
(`ops.encode_continue.continue_blocks_plain`, the serial continue schedule,
and `continue_blocks_warp`, the warp's 32-wide probe search) held to the
JAX package's native continue engine, its pure-Python twin and liblz4's
LZ4_compress_fast_continue; the port's frames to `lz4_tpu.frame.compress`
(its default route, `_host_chained_canonical_compress`) byte for byte; the
two packages decoding each other's frames; and the refusals the JAX
package makes."""

import io

import numpy as np
import pytest
import torch

from lz4_tpu import frame as jframe
from lz4_tpu import native
from lz4_tpu.block import incremental as jincremental
from lz4_tpu.block.hostref import ChainedCanonicalEncoder
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch import parallel
from lz4_tpu_torch.block import incremental as tincremental
from lz4_tpu_torch.constants import compress_bound
from lz4_tpu_torch.frame.api import _scan_single_frame
from lz4_tpu_torch.ops import encode_continue as F

import chip_smoke
import liblz4

pytestmark = pytest.mark.skipif(not native.available(), reason="native engine unavailable")

GRID = [(n, bs, accel) for n in (40, 9000, 90000, 250000)
        for bs in (10, 4096, 16384, 65536) for accel in (1, 3)]


def _data(n: int, seed: int) -> bytes:
    """n bytes of the bench mix (text, records, runs, noise), from a seed."""
    data = chip_smoke.make_corpus(n + 64, seed)[:n]
    assert len(data) == n
    return data


@pytest.mark.parametrize("n,bs,accel", GRID, ids=[f"{n}-{bs}-a{a}" for n, bs, a in GRID])
def test_plain_schedule_equals_the_native_engine(n, bs, accel):
    data = _data(n, 7000 + n % 97 + bs % 89 + accel)
    mine = F.continue_blocks_plain(data, bs, accel)
    assert mine == native.chained_canonical_blocks(data, bs, accel)
    enc = ChainedCanonicalEncoder(data)
    assert mine == [enc.encode_block(off, min(bs, n - off), accel) for off in range(0, n, bs)]
    if liblz4.LIB is not None:
        assert mine == liblz4.compress_blocks_continue(data, bs, accel)


@pytest.mark.parametrize("lanes", [1, 2, 32])
@pytest.mark.parametrize("bs,accel", [(4096, 1), (4096, 3), (65536, 1), (16384, 8)])
def test_warp_model_equals_the_serial_schedule(lanes, bs, accel):
    """The warp's search at any width gives the serial schedule's bytes and
    leaves its table: a search that runs out of probes still makes the
    writes of the probes before its end, which the next block reads."""
    data = _data(300_000, 31 + bs + accel)
    steps = []
    got = F.continue_blocks_warp(data, bs, accel, lanes=lanes, steps=steps)
    assert got == F.continue_blocks_plain(data, bs, accel)
    assert len(steps) == len(got)
    assert all(s["probe_steps"] >= 0 and s["sequences"] >= 0 for s in steps)
    if lanes == 32:
        one = []
        F.continue_blocks_warp(data, bs, accel, lanes=1, steps=one)
        assert sum(s["probe_steps"] for s in steps) < sum(s["probe_steps"] for s in one)
        assert [s["sequences"] for s in steps] == [s["sequences"] for s in one]


@pytest.mark.parametrize("n, seed", [(70_000, 1), (13, 2), (200_000, 3), (0, 4)])
def test_the_kernels_cpu_route_is_the_plain_version(n, seed):
    """`encode_continue` on a CPU tensor: each block's row and length as
    the plain schedule gives them, steps from the warp model, no launch."""
    data = _data(n, seed)
    payload = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    nb = -(-n // 65536)
    steps = torch.zeros((nb, 2), dtype=torch.int32)
    launches = F.encode_continue.launches
    out, clens = F.encode_continue(payload, 65536, steps=steps)
    assert F.encode_continue.launches == launches
    assert out.shape == (nb, compress_bound(65536)) and clens.shape == (nb,)
    want = F.continue_blocks_plain(data, 65536)
    assert [out[k, :int(clens[k])].numpy().tobytes() for k in range(nb)] == want
    if nb:
        assert int(steps[:, 0].min()) >= 1 and int(steps.sum()) > 0
    plain = F.encode_continue_plain(payload, 65536)
    assert all(torch.equal(a, b) for a, b in zip(plain, (out, clens)))


def _noisy_payload(bs: int, tail: int) -> bytes:
    """Blocks of the mix, one block of random bytes (stored raw), and a
    last block of ``tail`` bytes (0: an exact multiple of ``bs``)."""
    rng = np.random.default_rng(bs + tail)
    body = _data(3 * bs, 11)
    noise = rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
    return body[:2 * bs] + noise + body[2 * bs:] + body[:tail]


FRAMES = [
    (level, bs, tail, sums)
    for level in (0, 1, 2)
    for bs, tail in ((65536, 7), (65536, 0), (262144, 12))
    for sums in ((False, False), (True, True))
]


@pytest.mark.parametrize("level,bs,tail,sums", FRAMES)
def test_frames_equal_the_jax_package(level, bs, tail, sums):
    data = _noisy_payload(bs, tail)
    kw = dict(geometry="canonical", compression_level=level, block_size=bs,
              block_checksum=sums[0], content_checksum=sums[1])
    for extra in ({}, {"content_length": len(data)}):
        ours = tframe.compress(data, tframe.EncoderSettings(**kw, **extra), device="cpu")
        theirs = jframe.compress(data, jframe.EncoderSettings(**kw, **extra), backend="auto")
        assert ours == theirs
    _, blocks, _ = _scan_single_frame(ours)
    assert any(stored for _, _, stored in blocks)  # the noise block
    assert tframe.decompress(theirs, device="cpu") == data
    assert jframe.decompress(ours) == data


def test_compress_into_and_store_size_follow_compress():
    data = _noisy_payload(65536, 5)
    s = tframe.EncoderSettings(geometry="canonical")
    want = jframe.compress(data, jframe.EncoderSettings(geometry="canonical"), store_size=True)
    assert tframe.compress(data, s, store_size=True, device="cpu") == want
    buf = bytearray(len(data) + 1024)
    n = tframe.compress_into(data, buf, s, device="cpu")
    assert bytes(buf[:n]) == jframe.compress(data, jframe.EncoderSettings(geometry="canonical"))


def test_a_mesh_refuses_as_the_jax_device_route_does():
    data = _data(200_000, 5)
    with pytest.raises(ValueError, match="canonical chained") as theirs:
        jframe.compress(data, jframe.EncoderSettings(geometry="canonical"), backend="tpu")
    mesh = parallel.make_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="canonical chained") as ours:
        tframe.compress(data, tframe.EncoderSettings(geometry="canonical"), mesh=mesh)
    assert type(ours.value) is type(theirs.value)


@pytest.mark.parametrize("surface", ["FrameWriter", "open", "create_encoder"])
def test_streaming_surfaces_refuse_as_in_the_jax_package(surface, tmp_path):
    def call(pkg, frame_mod, incremental):
        s = frame_mod.EncoderSettings(geometry="canonical")
        if surface == "FrameWriter":
            return frame_mod.FrameWriter(io.BytesIO(), s, **pkg)
        if surface == "open":
            return frame_mod.open(tmp_path / "x.lz4", "wb", settings=s, **pkg)
        return incremental.create_encoder(True, 0, geometry="canonical", **pkg)

    with pytest.raises(ValueError) as theirs:
        call({}, jframe, jincremental)
    with pytest.raises(ValueError) as ours:
        call({"device": "cpu"}, tframe, tincremental)
    assert str(ours.value) == str(theirs.value)


class _Longer(bytes):
    """Bytes that report a length past the bound, to reach the JAX
    package's check without 2 GiB."""

    def __len__(self):
        return (1 << 31) - (64 << 20) + 1

    def __bytes__(self):
        return self


def test_the_size_bound_raises_what_the_jax_package_raises(monkeypatch):
    with pytest.raises(ValueError) as theirs:
        native.chained_canonical_blocks(_Longer(b"abc"), 65536)
    assert F.MAX_FRAME == (1 << 31) - (64 << 20)
    monkeypatch.setattr(F, "MAX_FRAME", 100_000)
    data = _data(100_001, 9)
    with pytest.raises(ValueError) as ours:
        tframe.compress(data, tframe.EncoderSettings(geometry="canonical"), device="cpu")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="2 GiB"):
        F.continue_blocks_plain(data, 65536)
    with pytest.raises(ValueError, match="2 GiB"):
        F.encode_continue(torch.frombuffer(bytearray(data), dtype=torch.uint8), 65536)
    assert len(F.continue_blocks_plain(data[:100_000], 65536)) == 2
