"""Checksummed frames on the CPU: every block and content checksum comes
from kernel E's plain version, the frames are byte for byte the JAX
package's host frames (the `lz4` command line's default settings among
them), no payload reaches the host hash, and corrupt checksummed frames
are refused with the same messages as a sequential reader gives."""

import importlib
import random
import struct
import sys

import pytest

from lz4_tpu import frame as jframe
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.frame.api import _scan_single_frame

import bench

CORPUS = bench.make_corpus(1 << 20, seed=11)
# `lz4`'s command line: independent 4 MB blocks and a content checksum
CLI = dict(chain_blocks=False, block_size=4 << 20, content_checksum=True)
BOTH = dict(block_checksum=True, content_checksum=True)


def _jax(data, **kw):
    return jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")


def _ours(data, **kw):
    return tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")


@pytest.mark.parametrize("size", [0, 1000, 300000])
def test_cli_default_frames_match_the_jax_package(size):
    data = CORPUS[:size]
    ours = _ours(data, **CLI)
    assert ours == _jax(data, **CLI)
    assert tframe.decompress(ours, device="cpu") == data


def _with_stored_blocks():
    rng = random.Random(2)
    return CORPUS[:100000] + rng.randbytes(150000) + CORPUS[500000:600000]


@pytest.mark.parametrize("chain", [False, True], ids=["independent", "chained"])
def test_stored_blocks_carry_the_checksum_of_their_raw_bytes(chain):
    """Blocks that LZ4 cannot shrink are stored: their checksums come from
    the payload, the others' from the compressed rows."""
    data = _with_stored_blocks()
    kw = dict(BOTH, chain_blocks=chain)
    ours = _ours(data, **kw)
    _, blocks, _ = _scan_single_frame(ours)
    assert any(st for _, _, st in blocks) and not all(st for _, _, st in blocks)
    assert ours == _jax(data, **kw)
    assert tframe.decompress(ours, device="cpu") == data


@pytest.fixture
def no_host_hash(monkeypatch):
    """`lz4_tpu_torch.xxh32`'s host stripe loop made to fail (a frame
    descriptor, at most 15 bytes, has no whole stripe), and its one-shot
    hash to fail on more than 15 bytes wherever the port has bound it.  A
    stream's content hash (`XXH32.update` on a tensor) goes through kernel
    E's streaming form, here its plain version."""
    mod = importlib.import_module("lz4_tpu_torch.xxh32")
    real = mod.xxh32

    def short_only(data, seed=0):
        assert len(data) <= 15, f"{len(data)} bytes reached the host hash"
        return real(data, seed)

    def no_stripes(accs, data, n_stripes):
        raise AssertionError(f"{n_stripes} stripes reached the host hash")

    for name, m in list(sys.modules.items()):
        if name.split(".")[0] == "lz4_tpu_torch" and getattr(m, "xxh32", None) is real:
            monkeypatch.setattr(m, "xxh32", short_only)
    monkeypatch.setattr(mod, "host_stripes", no_stripes)
    with pytest.raises(AssertionError):
        mod.xxh32(bytes(16))
    with pytest.raises(AssertionError):
        mod.XXH32().update(bytes(16))
    return mod


@pytest.mark.parametrize("kw", [
    CLI, dict(BOTH, chain_blocks=False), BOTH, dict(BOTH, content_length=300000),
    dict(BOTH, chain_blocks=False, block_size=1 << 18),
], ids=["cli_default", "independent", "chained", "content_size", "256k_blocks"])
def test_no_payload_reaches_the_host_hash(kw, no_host_hash):
    data = CORPUS[:300000]
    blob = _ours(data, **kw)
    assert blob == _jax(data, **kw)
    assert tframe.decompress(blob, device="cpu") == data


def _flip(blob, at):
    b = bytearray(blob)
    b[at] ^= 0x10
    return bytes(b)


def _corrupt_cases():
    data = CORPUS[:300000]
    ind = _jax(data, **dict(BOTH, chain_blocks=False))
    chained = _jax(data, **BOTH)
    _, blocks, pos = _scan_single_frame(ind)
    _, cblocks, _ = _scan_single_frame(chained)
    (off0, len0, _), (off1, len1, _) = blocks[0], blocks[1]
    last_off, last_len, _ = blocks[-1]
    bad_word = bytearray(_flip(ind, off0 + 5))
    struct.pack_into("<I", bad_word, last_off - 4, 0x7FFFFFF0)
    return {
        "block_byte": (_flip(ind, off1 + len1 // 2), "block checksum mismatch"),
        "block_checksum_field": (_flip(ind, off0 + len0 + 1), "block checksum mismatch"),
        "content_checksum_field": (_flip(ind, pos + 2), "content checksum mismatch"),
        "chained_block_byte": (_flip(chained, cblocks[2][0] + 7), "block checksum mismatch"),
        "chained_content_field": (_flip(chained, len(chained) - 1), "content checksum mismatch"),
        "cli_content_field": (_flip(_jax(data, **CLI), -3), "content checksum mismatch"),
        # a sequential reader stops at the first bad block, before the fault
        # further on
        "mismatch_before_truncation": (
            _flip(ind, off0 + 5)[:last_off + last_len // 2], "block checksum mismatch"),
        "mismatch_before_bad_length": (bytes(bad_word), "block checksum mismatch"),
        "truncated_checksum_field": (ind[:last_off + last_len + 2], "truncated block checksum"),
    }


CORRUPT = _corrupt_cases()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_checksummed_frames_raise_the_same_message(case):
    blob, message = CORRUPT[case]
    with pytest.raises(ValueError) as theirs:
        jframe.decompress(blob, backend="host")
    with pytest.raises(ValueError) as ours:
        tframe.decompress(blob, device="cpu")
    assert type(ours.value).__name__ == type(theirs.value).__name__ == "LZ4FormatError"
    # the one-block CLI frame takes both packages' FrameReader, whose
    # content checksum message names the two hashes
    assert str(ours.value) == str(theirs.value)
    assert str(ours.value).startswith(message)


@pytest.fixture
def device_route(monkeypatch):
    """The JAX package's device route as it runs on a TPU (its Pallas
    stream decoder in interpret mode, `_on_tpu` true): the route a chained
    frame's one-shot decode ports (`lz4_tpu/frame/api.py:690-745`)."""
    import functools

    from jax.experimental import pallas as pl
    from lz4_tpu.ops import decode_pallas_stream as DS
    from lz4_tpu.parallel import blocks as PB

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(PB, "_on_tpu", lambda: True)
    DS.pallas_decode_stream.clear_cache()
    yield
    DS.pallas_decode_stream.clear_cache()


@pytest.mark.parametrize("chain", [False, True], ids=["independent", "chained"])
@pytest.mark.parametrize("length", ["true", "false"])
def test_a_corrupt_content_checksum_raises_before_a_false_content_length(
        chain, length, device_route):
    """The content checksum is verified before the content length, one-shot
    and through the reader, as the JAX package's device route does: a
    flipped checksum raises the checksum fault whether the header's length
    is true or not.  (The JAX host route checks a chained frame's length
    first.)"""
    import io

    import chip_smoke

    data = CORPUS[:150000]
    kw = dict(chain_blocks=chain, content_checksum=True, content_length=len(data))
    blob = bytearray(_jax(data, **kw))
    assert bytes(blob) == _ours(data, **kw)
    blob[-1] ^= 0x10
    bad = bytes(blob) if length == "true" else \
        chip_smoke.with_content_length(bytes(blob), len(data) + 3)
    with pytest.raises(ValueError) as theirs:
        jframe.decompress(bad, backend="tpu")
    with pytest.raises(ValueError) as ours:
        tframe.decompress(bad, device="cpu")
    assert type(ours.value).__name__ == type(theirs.value).__name__ == "LZ4FormatError"
    assert str(ours.value) == str(theirs.value) == "content checksum mismatch"
    with pytest.raises(ValueError, match="^content checksum mismatch 0x"):
        tframe.LZ4FrameFile(io.BytesIO(bad), "rb", device="cpu").read()
