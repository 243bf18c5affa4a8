"""The port's slice as a whole on the CPU: independent-block frames
byte-identical to the JAX package's canonical frames, JAX-made frames
decoded, and corrupt frames refused with the JAX package's exception
types."""

import io
import random
import struct

import pytest

from lz4_tpu import frame as jframe
from lz4_tpu.frame.writer import FrameWriter
from lz4_tpu.xxh32 import xxh32 as jxxh32
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch import parallel as tparallel
from lz4_tpu_torch.frame.api import _scan_single_frame
from lz4_tpu_torch.parallel.blocks import comp_capacity
from lz4_tpu_torch.xxh32 import XXH32 as TXXH32, xxh32 as txxh32

import bench

CORPUS = bench.make_corpus(1 << 20, seed=0)
CHECKSUMS = [(False, False), (True, False), (False, True), (True, True)]


def _jax_frame(data, **kw):
    return jframe.compress(
        data, jframe.EncoderSettings(chain_blocks=False, **kw), backend="host"
    )


@pytest.mark.parametrize("block_checksum,content_checksum", CHECKSUMS)
@pytest.mark.parametrize("size", [0, 1000, 65536, 300000])
def test_frames_match_the_jax_package(size, block_checksum, content_checksum):
    data = CORPUS[:size]
    kw = dict(block_checksum=block_checksum, content_checksum=content_checksum)
    ours = tframe.compress(
        data, tframe.EncoderSettings(chain_blocks=False, **kw), device="cpu"
    )
    assert ours == _jax_frame(data, **kw)
    assert tframe.decompress(ours, device="cpu") == data


@pytest.mark.parametrize("geometry", ["auto", "canonical", "dense"])
def test_geometries_and_content_size_match(geometry):
    data = CORPUS[100000:400000]
    kw = dict(geometry=geometry, content_length=len(data))
    ours = tframe.compress(
        data, tframe.EncoderSettings(chain_blocks=False, **kw), device="cpu"
    )
    assert ours == _jax_frame(data, **kw)
    assert ours == tframe.compress(
        data, tframe.EncoderSettings(chain_blocks=False, geometry=geometry),
        store_size=True, device="cpu",
    )


def test_blocks_above_64k_are_not_ported():
    """Independent 256 KB blocks (kernel D's plain version) give the JAX
    package's canonical frames."""
    data = CORPUS[:700000]
    ours = tframe.compress(
        data, tframe.EncoderSettings(chain_blocks=False, block_size=1 << 18),
        device="cpu",
    )
    assert ours == _jax_frame(data, block_size=1 << 18)
    assert tframe.decompress(ours, device="cpu") == data


def test_single_block_canonical_chain_is_independent():
    data = CORPUS[:5000]
    settings = tframe.EncoderSettings(geometry="canonical")
    assert tframe.compress(data, settings, device="cpu") == jframe.compress(
        data, jframe.EncoderSettings(geometry="canonical"), backend="host"
    )


def _stored_blocks(blob, kw):
    stored = 0
    pos = 7 + (8 if "content_length" in kw else 0)
    while True:
        (word,) = struct.unpack_from("<I", blob, pos)
        if word == 0:
            return stored
        stored += bool(word & 0x80000000)
        pos += 4 + (word & 0x7FFFFFFF) + (4 if kw.get("block_checksum") else 0)


@pytest.mark.parametrize("kw", [
    {}, {"block_checksum": True, "content_checksum": True},
    {"content_length": 655288}, {"block_size": 1 << 18},
], ids=["plain", "checksums", "content_length", "256k_blocks"])
def test_decodes_jax_frames_with_stored_blocks(kw):
    rng = random.Random(3)
    data = (
        CORPUS[:70000] + rng.randbytes(65536 * 8) + CORPUS[200000:260000]
        + rng.randbytes(1000)
    )
    assert len(data) == 655288
    blob = _jax_frame(data, **kw)
    assert _stored_blocks(blob, kw) >= 1
    assert tframe.decompress(blob, device="cpu") == data


def _corrupt_cases():
    d = CORPUS[:200000]
    base = _jax_frame(d)
    hdr = 7
    cases = {"bad_magic": b"\x00" + base[1:], "truncated": base[: len(base) // 2],
             "truncated_header": base[:5], "trailing_garbage": base + b"xyz12"}
    b = bytearray(base)
    b[6] ^= 0xFF
    cases["header_checksum"] = bytes(b)
    b = bytearray(_jax_frame(d, block_checksum=True))
    b[hdr + 4 + 100] ^= 1
    cases["block_checksum"] = bytes(b)
    b = bytearray(_jax_frame(d, content_checksum=True))
    b[-1] ^= 1
    cases["content_checksum"] = bytes(b)
    b = bytearray(base)
    b[hdr + 4 : hdr + 12] = bytes([0x40, 1, 2, 3, 4, 0, 0, 0])
    cases["offset_zero"] = bytes(b)
    b = bytearray(base)
    b[hdr + 4 : hdr + 24] = b"\xff" * 20
    cases["runaway_length"] = bytes(b)
    b = bytearray(base)
    struct.pack_into("<I", b, hdr, 0x7FFFFFF0)
    cases["block_length"] = bytes(b)
    b = bytearray(_jax_frame(d, content_length=len(d)))
    struct.pack_into("<Q", b, 6, len(d) + 1)
    b[14] = (jxxh32(bytes(b[4:14])) >> 8) & 0xFF
    cases["content_length"] = bytes(b)
    return cases


CORRUPT = _corrupt_cases()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_frames_raise_the_jax_exception_types(case):
    blob = CORRUPT[case]
    with pytest.raises(ValueError) as jax_err:
        jframe.decompress(blob, backend="tpu")
    with pytest.raises(ValueError) as our_err:
        tframe.decompress(blob, device="cpu")
    assert type(our_err.value).__name__ == type(jax_err.value).__name__
    assert type(our_err.value).__module__.startswith("lz4_tpu_torch.")


@pytest.mark.parametrize("what", [
    "chained", "dictionary_id", "two_frames", "preset_dictionary",
    "independent_with_dictionary",
])
def test_streaming_cases_are_not_ported(what):
    """Chained frames, with or without a preset dictionary, compress and
    decode as the JAX package's; an independent frame decodes as if a
    preset dictionary were absent, as the JAX package's does; what the
    JAX package's FrameReader decodes (a dictionary ID, two frames) the
    port's FrameReader decodes to the same bytes."""
    data = CORPUS[:150000]
    if what == "independent_with_dictionary":
        blob = _jax_frame(data)
        settings = tframe.DecoderSettings(dictionary=b"abc")
        want = jframe.decompress(blob, jframe.DecoderSettings(dictionary=b"abc"))
        assert tframe.decompress(blob, settings, device="cpu") == want == data
        return
    if what == "chained":
        blob = jframe.compress(data, jframe.EncoderSettings(), backend="host")
        assert tframe.compress(data, tframe.EncoderSettings(), device="cpu") == blob
        assert tframe.decompress(blob, device="cpu") == data
        return
    if what == "preset_dictionary":
        preset = CORPUS[500000:600000]
        sink = io.BytesIO()
        with FrameWriter(sink, jframe.EncoderSettings(), backend="host",
                         dictionary=preset) as w:
            w.write(data)
        settings = tframe.DecoderSettings(dictionary=preset)
        assert tframe.decompress(sink.getvalue(), settings, device="cpu") == data
        return
    if what == "dictionary_id":
        blob = _jax_frame(data, dictionary_id=7)
    elif what == "two_frames":
        blob = _jax_frame(data) * 2
    want = jframe.decompress(blob, backend="host")
    assert tframe.decompress(blob, device="cpu") == want == data * (
        2 if what == "two_frames" else 1)


def test_parallel_blocks_round_trip_and_refuse_malformed_blocks():
    """`parallel.encode_blocks` gives the canonical frame's blocks;
    `parallel.decode_blocks` decodes them in one batch and names the first
    malformed or oversized block."""
    data = CORPUS[:300000]
    blocks = tparallel.encode_blocks(data, 65536, device="cpu")
    assert len(blocks) == 5
    blob = _jax_frame(data)
    _, table, _ = _scan_single_frame(blob)
    assert blocks == [blob[off:off + n] for off, n, _ in table]
    assert tparallel.decode_blocks(blocks, 65536, len(data), device="cpu") == data
    assert tparallel.decode_blocks([], 65536, device="cpu") == b""
    for bad, match in (
        (blocks[:1] + [b"\xff" * 10] + blocks[2:], "malformed LZ4 block 1"),
        (blocks[:2] + [bytes(comp_capacity(65536) - 19)], "block 2 of"),
    ):
        with pytest.raises(ValueError, match=match):
            tparallel.decode_blocks(bad, 65536, device="cpu")
    with pytest.raises(ValueError, match="decoded length"):
        tparallel.decode_blocks(blocks, 65536, len(data) + 1, device="cpu")


def test_empty_input_and_xxh32():
    assert tframe.decompress(b"", device="cpu") == b""
    rng = random.Random(9)
    for n in (0, 1, 15, 16, 17, 1000, 4099):
        d = rng.randbytes(n)
        assert txxh32(d) == jxxh32(d)
        h = TXXH32()
        h.update(d[: n // 3]).update(d[n // 3 :])
        assert h.digest() == jxxh32(d)
