"""The port's pickler on the CPU, held to `lz4_tpu.pickler` (backend
"host"): the same blobs at levels 0 and 9, the stored form, the header
width ladder, `pickle_into`/`unpickle_into`, `unpickled_size`, and
PickleError with the same message on every fault the pickler reports
itself (the class only where it wraps the block decoder's)."""

import random

import numpy as np
import pytest

import lz4_tpu_torch
from conftest import sample_corpus
from lz4_tpu import pickler as jp
from lz4_tpu_torch import pickler as tp

CORPUS = sample_corpus(random.Random(1234))


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome under test
        return type(e).__name__, str(e)


@pytest.mark.parametrize("level", [0, 9])
@pytest.mark.parametrize("name", sorted(CORPUS))
def test_blobs_equal_the_jax_pickler(name, level):
    data = CORPUS[name]
    blob = tp.pickle(data, level=level, device="cpu")
    assert blob == jp.pickle(data, level=level, backend="host")
    assert tp.unpickle(blob, device="cpu") == data
    assert tp.unpickled_size(blob) == jp.unpickled_size(blob) == len(data)


def test_empty_and_stored():
    assert tp.pickle(b"", device="cpu") == b""
    assert tp.unpickle(b"", device="cpu") == b""
    assert tp.unpickled_size(b"") == 0
    raw = random.Random(3).randbytes(500)
    assert tp.pickle(raw, device="cpu") == b"\x00" + raw


@pytest.mark.parametrize("data, code", [
    (b"ab" * 40, 0x40), (b"ab" * 2000, 0x80), (bytes(300_000), 0xC0),
])
def test_header_width_ladder(data, code):
    blob = tp.pickle(data, device="cpu")
    assert blob[0] == code and blob == jp.pickle(data, backend="host")


@pytest.mark.parametrize("blob", [b"\x01abc", b"\xc0\x01", b"\x80\x05",
                                  b"\x07", b"\x40\x05" + b"\xff" * 30,
                                  b"\x40\x02\x40abcd", b"\x40\xff\x10abc"])
def test_faults_raise_pickle_errors(blob):
    ours = _outcome(lambda: tp.unpickle(blob, device="cpu"))
    theirs = _outcome(lambda: jp.unpickle(blob, backend="host"))
    assert ours[0] == theirs[0] == "PickleError"
    if not theirs[1].startswith("corrupted pickle payload"):
        assert ours == theirs
    room = np.empty(4096, np.uint8)
    ours = _outcome(lambda: tp.unpickle_into(blob, room, device="cpu"))
    theirs = _outcome(lambda: jp.unpickle_into(blob, room, backend="host"))
    assert ours[0] == theirs[0] == "PickleError"
    if not theirs[1].startswith("corrupted pickle payload"):
        assert ours == theirs


@pytest.mark.parametrize("name", ["lorem", "random", "zeros", "tiny"])
def test_pickle_into_and_unpickle_into(name):
    data = CORPUS[name]
    blob = jp.pickle(data, backend="host")
    for room in (len(blob), len(blob) + 16, 4, 0):
        ours, theirs = bytearray(room), bytearray(room)
        n = tp.pickle_into(data, ours, device="cpu")
        assert n == jp.pickle_into(data, theirs, backend="host")
        if n > 0:
            assert ours[:n] == theirs[:n] == blob
    for room in (len(data), len(data) + 8, len(data) - 1):
        out = bytearray(max(room, 0))
        ours = _outcome(lambda: tp.unpickle_into(blob, out, device="cpu"))
        theirs = _outcome(lambda: jp.unpickle_into(blob, bytearray(max(room, 0)),
                                                   backend="host"))
        assert ours == theirs
        if ours[0] == "ok":
            assert bytes(out[:len(data)]) == data


def test_a_short_payload_raises_the_pickler_message():
    """A payload that decodes to fewer bytes than the header says: the
    pickler's own size message, from `unpickle_into`."""
    comp = jp.pickle(b"abcdefgh" * 64, backend="host")
    blob = bytes([comp[0], comp[1] + 5]) + comp[2:]
    out = bytearray(1000)
    assert _outcome(lambda: tp.unpickle_into(blob, out, device="cpu")) == _outcome(
        lambda: jp.unpickle_into(blob, bytearray(1000), backend="host"))


def test_via_package_namespace():
    data = CORPUS["lorem"]
    assert lz4_tpu_torch.unpickle(lz4_tpu_torch.pickle(data, device="cpu"),
                                  device="cpu") == data
    dest = bytearray(len(data) + 64)
    n = lz4_tpu_torch.pickle_into(data, dest, level=9, device="cpu")
    out = bytearray(lz4_tpu_torch.unpickled_size(bytes(dest[:n])))
    assert lz4_tpu_torch.unpickle_into(bytes(dest[:n]), out, device="cpu") == len(data)
