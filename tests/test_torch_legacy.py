"""The port's legacy formats on the CPU, held to `lz4_tpu.legacy`
(backend "host"): wrap and wrap_hc blobs and varint-chunk streams byte for
byte, their decodes, random write sizes, crafted chunk lengths (the 255x
expansion bound and the 1 GiB cap), and `unwrap` of a stored payload
longer than the original."""

import io
import random
import struct

import pytest

from conftest import sample_corpus
from lz4_tpu import legacy as jl
from lz4_tpu_torch import legacy as tl

CORPUS = sample_corpus(random.Random(1234))


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome under test
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_wraps_equal_the_jax_package(name):
    data = CORPUS[name]
    for ours_fn, theirs_fn in ((tl.wrap, jl.wrap), (tl.wrap_hc, jl.wrap_hc)):
        blob = ours_fn(data, device="cpu")
        assert blob == theirs_fn(data, backend="host")
        assert tl.unwrap(blob, device="cpu") == data


def test_wrap_header_and_stored_forms():
    data = CORPUS["lorem"]
    blob = tl.wrap(data, device="cpu")
    original, stored = struct.unpack_from("<II", blob)
    assert original == len(data) and stored == len(blob) - 8 < len(data)
    raw = random.Random(4).randbytes(1000)
    assert tl.wrap(raw, device="cpu") == struct.pack("<II", 1000, 1000) + raw
    assert tl.wrap(b"", device="cpu") == bytes(8)
    assert tl.unwrap(bytes(8), device="cpu") == b""


@pytest.mark.parametrize("blob", [b"", b"\x01\x02", struct.pack("<II", 100, 50) + b"x" * 10,
                                  struct.pack("<II", 100, 10) + b"\xff" * 10])
def test_unwrap_faults(blob):
    ours = _outcome(lambda: tl.unwrap(blob, device="cpu"))
    theirs = _outcome(lambda: jl.unwrap(blob, backend="host"))
    assert ours[0] == theirs[0] == "LZ4Error"
    if "wrapped" in theirs[1]:
        assert ours == theirs


def test_unwrap_returns_a_stored_payload_longer_than_the_original():
    blob = struct.pack("<II", 3, 5) + b"abcde"
    assert tl.unwrap(blob, device="cpu") == jl.unwrap(blob, backend="host") == b"abcde"


@pytest.mark.parametrize("hc", [False, True])
@pytest.mark.parametrize("block_size", [1000, 65536, 1 << 20])
def test_streams_equal_the_jax_package(hc, block_size):
    data = b"".join(CORPUS[k] for k in sorted(CORPUS)) * 2
    blob = tl.encode(data, hc, block_size, device="cpu")
    assert blob == jl.encode(data, hc, block_size, backend="host")
    assert tl.decode(blob, device="cpu") == data


def test_random_write_sizes_and_flushes():
    data = CORPUS["lorem"] + CORPUS["semi"]
    rng = random.Random(8)
    ours_sink, theirs_sink = io.BytesIO(), io.BytesIO()
    ours = tl.LegacyStreamWriter(ours_sink, block_size=4096, device="cpu")
    theirs = jl.LegacyStreamWriter(theirs_sink, block_size=4096, backend="host")
    pos = 0
    while pos < len(data):
        n = rng.randint(1, 9000)
        assert ours.write(data[pos:pos + n]) == theirs.write(data[pos:pos + n])
        pos += n
        if rng.random() < 0.2:
            ours.flush()
            theirs.flush()
    with ours, theirs:
        pass
    assert ours_sink.getvalue() == theirs_sink.getvalue()
    with pytest.raises(ValueError):
        ours.write(b"x")
    reader = tl.LegacyStreamReader(io.BytesIO(ours_sink.getvalue()), device="cpu")
    out = bytearray()
    with reader:
        while chunk := reader.read(rng.randint(1, 5000)):
            out += chunk
    assert bytes(out) == data


def _chunk(flags, original, stored=None, payload=b""):
    out = bytearray()
    for v in [flags, original] + ([stored] if stored is not None else []):
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                break
    return bytes(out) + payload


@pytest.mark.parametrize("blob", [
    _chunk(1, 10_000_000, 100, b"\x00" * 100),  # over 255x expansion
    _chunk(0, (1 << 30) + 1),  # over the 1 GiB cap
    _chunk(1, 5, 10),  # stored > original
    _chunk(4, 5),  # passes set
    _chunk(1, 5),  # cut header
    b"\x81",  # cut varint
    b"\xff" * 10 + b"\x01",  # varint too long
    _chunk(0, 50, None, b"abc"),  # cut payload
    _chunk(1, 50, 5, b"\xf0\x01\x02\x03\x04"),  # malformed block
])
def test_crafted_chunks_raise_the_jax_faults(blob):
    ours = _outcome(lambda: tl.decode(blob, device="cpu"))
    theirs = _outcome(lambda: jl.decode(blob, backend="host"))
    assert ours[0] == theirs[0] == "LZ4Error"
    if "legacy" in theirs[1] or "varint" in theirs[1]:
        assert ours == theirs
