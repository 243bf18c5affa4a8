"""Frame faults of the port held to the JAX package on the CPU.

- A frame with a malformed block, then cut short or followed by other
  bytes, raises what `lz4_tpu.frame.decompress` raises: the exception class
  and which fault wins (a checksum mismatch, the malformed block, or the
  cut).  Block faults are worded differently on the JAX package's host and
  device routes, so for them only the class is pinned; the frame faults'
  messages are equal.
- A declared content length that a one-block payload does not have raises
  the JAX package's ValueError; above one block the frame is written as
  declared, as the JAX package's device route writes it on a TPU (its host
  route raises on an independent payload of one to two blocks, its device
  route on a chained one off a TPU), and both packages refuse that frame.
- A declared content length outside [0, 2^64) raises the JAX package's
  struct.error at every size.
- An independent frame decodes as if a preset dictionary were absent.
"""

import functools
import struct

import numpy as np
import pytest

from lz4_tpu import frame as jframe
from lz4_tpu.xxh32 import xxh32
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.frame.api import _scan_frame

PAYLOAD = (b"abcdefgh" * 9000)[:70000]
CUTS = ["block_length", "block_data", "block_checksum", "content_checksum",
        "trailing_1", "trailing_2", "trailing_3", "invalid_magic"]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome under test
        return type(e).__name__, str(e)


def _frame(chain: bool, corrupt: str) -> bytes:
    """A two-block frame with block and content checksums whose block 0 is
    malformed (its token promises 15 literals and a 270-byte extension),
    with its checksum made whole again ("block"), left stale ("checksum"),
    or untouched ("none")."""
    s = jframe.EncoderSettings(chain_blocks=chain, block_checksum=True,
                               content_checksum=True)
    blob = bytearray(jframe.compress(PAYLOAD, s, backend="host"))
    if corrupt != "none":
        blob[11], blob[12] = 0xF0, 0xFF
    if corrupt == "block":
        off, length, _ = _scan_frame(bytes(blob)).blocks[0]
        blob[off + length:off + length + 4] = struct.pack(
            "<I", xxh32(bytes(blob[off:off + length])))
    return bytes(blob)


def _cut(blob: bytes, cut: str) -> bytes:
    off1, len1, _ = _scan_frame(blob).blocks[1]
    if cut == "block_length":
        return blob[:off1 - 2]
    if cut == "block_data":
        return blob[:off1 + 3]
    if cut == "block_checksum":
        return blob[:off1 + len1 + 2]
    if cut == "content_checksum":
        return blob[:-2]
    if cut.startswith("trailing_"):
        return blob + b"\x00" * int(cut[-1])
    return blob + b"\x01\x02\x03\x04"


@pytest.mark.parametrize("corrupt", ["block", "checksum", "none"])
@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("chain", [True, False])
def test_cut_frames_raise_the_reference_fault_first(chain, cut, corrupt):
    blob = _cut(_frame(chain, corrupt), cut)
    ours = _outcome(lambda: tframe.decompress(blob, device="cpu"))
    theirs = _outcome(lambda: jframe.decompress(blob))
    assert ours[0] == theirs[0], (ours, theirs)
    expect = {"block": "LZ4Error", "checksum": "LZ4FormatError",
              "none": "LZ4FormatError"}[corrupt]
    assert ours[0] == expect
    if ours[0] == "LZ4FormatError":
        assert ours[1] == theirs[1]


@pytest.mark.parametrize("chain", [True, False])
def test_a_length_over_the_limit_is_raised_before_any_block_decodes(chain):
    blob = bytearray(_frame(chain, "block"))
    off1 = _scan_frame(bytes(blob)).blocks[1][0]
    blob[off1 - 4:off1] = struct.pack("<I", 1 << 22)
    blob = bytes(blob)
    ours = _outcome(lambda: tframe.decompress(blob, device="cpu"))
    theirs = _outcome(lambda: jframe.decompress(blob))
    assert ours == theirs
    assert ours == ("LZ4FormatError", f"block length {1 << 22} exceeds block size limit")


def test_the_reported_cut_frame_raises_the_block_fault():
    """The re-anchor input: a chained frame without checksums, block 0
    malformed, its last 10 bytes dropped."""
    blob = bytearray(jframe.compress(PAYLOAD, backend="host"))
    blob[11], blob[12] = 0xF0, 0xFF
    blob = bytes(blob[:-10])
    ours = _outcome(lambda: tframe.decompress(blob, device="cpu"))
    theirs = _outcome(lambda: jframe.decompress(blob))
    assert ours[0] == theirs[0] == "LZ4Error"


@pytest.mark.parametrize("size, declared", [
    (0, 5), (29952, 5), (65536, 65535), (1000, 0),
])
def test_a_false_content_length_of_one_block_raises(size, declared):
    data = np.random.default_rng(size).integers(0, 4, size, dtype=np.uint8).tobytes()
    settings = dict(content_length=declared)
    with pytest.raises(ValueError) as theirs:
        jframe.compress(data, jframe.EncoderSettings(**settings))
    with pytest.raises(ValueError) as ours:
        tframe.compress(data, tframe.EncoderSettings(**settings), device="cpu")
    assert type(ours.value) is ValueError
    assert str(ours.value) == str(theirs.value) == (
        f"content length mismatch: declared {declared}, wrote {size}")


@pytest.mark.parametrize("chain", [True, False])
def test_a_false_content_length_above_one_block_is_framed_as_declared(chain):
    data = (b"lorem ipsum dolor " * 12000)[:200000]
    kw = dict(content_length=5, chain_blocks=chain)
    ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    theirs = jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
    assert ours == theirs
    with pytest.raises(ValueError, match="content length mismatch"):
        tframe.decompress(ours, device="cpu")


@pytest.fixture
def on_a_tpu(monkeypatch):
    """The JAX package's device route as it runs on a TPU: its Pallas
    kernels in interpret mode, `_on_tpu` true."""
    from jax.experimental import pallas as pl
    from lz4_tpu.ops import encode_pallas5 as E5
    from lz4_tpu.ops import encode_pallas_stream as ES
    from lz4_tpu.parallel import blocks as PB

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(PB, "_on_tpu", lambda: True)
    for f in (E5.pallas_encode5, ES.pallas_encode_stream):
        f.clear_cache()
    yield
    for f in (E5.pallas_encode5, ES.pallas_encode_stream):
        f.clear_cache()


@pytest.mark.parametrize("chain", [True, False])
def test_a_false_content_length_of_one_to_two_blocks_is_framed_as_declared(chain, on_a_tpu):
    data = (b"lorem ipsum dolor " * 12000)[:100000]
    kw = dict(content_length=5, chain_blocks=chain)
    ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    # the route the port ports, on its device: both frames as declared
    theirs = jframe.compress(data, jframe.EncoderSettings(**kw), backend="tpu")
    assert ours == theirs
    # the JAX host route frames the chained payload alike and refuses the
    # independent one (its threaded route takes only more than two blocks)
    host = _outcome(lambda: jframe.compress(data, jframe.EncoderSettings(**kw),
                                            backend="host"))
    assert host == (("ok", ours) if chain else (
        "ValueError", "content length mismatch: declared 5, wrote 100000"))
    refused = [_outcome(lambda: tframe.decompress(ours, device="cpu")),
               _outcome(lambda: jframe.decompress(ours))]
    # the class only: the JAX package's chained decode names the block
    # that overruns the declared length, the port the length
    assert [r[0] for r in refused] == ["LZ4FormatError"] * 2, refused


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("declared", [-1, 2 ** 64])
@pytest.mark.parametrize("size", [0, 5, 100000])
def test_a_content_length_outside_u64_raises_struct_error(size, declared, chain):
    data = (b"lorem ipsum dolor " * 6000)[:size]
    kw = dict(content_length=declared, chain_blocks=chain)
    with pytest.raises(struct.error) as theirs:
        jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
    with pytest.raises(struct.error) as ours:
        tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("content_checksum", [False, True])
def test_an_independent_frame_ignores_a_preset_dictionary(content_checksum):
    data = np.random.default_rng(15).integers(0, 8, 153600, dtype=np.uint8).tobytes()
    blob = jframe.compress(data, jframe.EncoderSettings(
        chain_blocks=False, content_checksum=content_checksum), backend="host")
    preset = b"xyz" * 100
    theirs = jframe.decompress(blob, jframe.DecoderSettings(dictionary=preset))
    ours = tframe.decompress(blob, tframe.DecoderSettings(dictionary=preset),
                             device="cpu")
    assert ours == theirs == data
