"""The port's slice as a whole on the CPU: independent-block frames
byte-identical to the JAX package's canonical frames, JAX-made frames
decoded, and corrupt frames refused with the JAX package's exception
types."""

import random
import struct

import pytest

from lz4_tpu import frame as jframe
from lz4_tpu.xxh32 import xxh32 as jxxh32
from lz4_tpu_torch import frame as tframe
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
    settings = tframe.EncoderSettings(chain_blocks=False, block_size=1 << 18)
    with pytest.raises(NotImplementedError, match="kernel D"):
        tframe.compress(CORPUS[:300000], settings, device="cpu")


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


@pytest.mark.parametrize(
    "what", ["chained", "dictionary_id", "two_frames", "preset_dictionary"]
)
def test_streaming_cases_are_not_ported(what):
    data = CORPUS[:150000]
    if what == "chained":
        with pytest.raises(NotImplementedError, match="kernels C and D"):
            tframe.compress(data, tframe.EncoderSettings(), device="cpu")
        blob = jframe.compress(data, jframe.EncoderSettings(), backend="host")
    elif what == "dictionary_id":
        blob = _jax_frame(data, dictionary_id=7)
    elif what == "two_frames":
        blob = _jax_frame(data) * 2
    else:
        blob = _jax_frame(data)
    settings = tframe.DecoderSettings(
        dictionary=b"abc" if what == "preset_dictionary" else b""
    )
    with pytest.raises(NotImplementedError, match="kernels C and D"):
        tframe.decompress(blob, settings, device="cpu")


def test_empty_input_and_xxh32():
    assert tframe.decompress(b"", device="cpu") == b""
    rng = random.Random(9)
    for n in (0, 1, 15, 16, 17, 1000, 4099):
        d = rng.randbytes(n)
        assert txxh32(d) == jxxh32(d)
        h = TXXH32()
        h.update(d[: n // 3]).update(d[n // 3 :])
        assert h.digest() == jxxh32(d)
