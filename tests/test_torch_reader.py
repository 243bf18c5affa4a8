"""The port's FrameReader on the CPU, held to `lz4_tpu.frame.FrameReader`
and `lz4_tpu.frame.decompress` (backend "host"): concatenated, skippable,
legacy and dictionary-ID frames decode to the same bytes at odd read
sizes; `read1`, `peek`, `extra_memory`, `frame_length`, `bytes_read` and
iteration behave alike; and a fault at every block boundary (a cut length
word, cut data, a cut checksum, a bad checksum, a bad magic after the
EndMark, bytes after a skippable frame) raises the same exception class,
and for format faults the same message."""

import io
import struct

import pytest

import bench
from lz4_tpu import frame as jframe
from lz4_tpu.block import api as jblock
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.frame.api import _scan_frame

CORPUS = bench.make_corpus(1 << 18, seed=51)


def _jax(data, **kw):
    return jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")


def _legacy(data, chunk=50000):
    parts = [struct.pack("<I", 0x184C2102)]
    for a in range(0, len(data), chunk):
        c = jblock.encode(data[a:a + chunk], backend="host")
        parts += [struct.pack("<I", len(c)), c]
    return b"".join(parts)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome under test
        return type(e).__name__, str(e)


def _same(ours, theirs):
    assert ours[0] == theirs[0], (ours, theirs)
    if ours[0] in ("ok", "LZ4FormatError"):
        assert ours == theirs


A, B = CORPUS[:70000], CORPUS[100000:130000]
FA = _jax(A, block_checksum=True, content_checksum=True)
FB = _jax(B, chain_blocks=False, content_checksum=True)
SKIP = jframe.skippable_frame(b"meta", nibble=3)
STREAMS = {
    "two_frames": FA + FB,
    "skippable_between": FA + SKIP + FB,
    "skippable_first": SKIP + FA,
    "three_frames": FA + SKIP + FB + FA,
    "legacy": _legacy(B),
    "legacy_then_frame": _legacy(B) + FA,
    "frame_then_legacy": FA + _legacy(B),
    "dictionary_id": _jax(A, dictionary_id=7, content_length=len(A)),
    "empty_frame": _jax(b"", content_checksum=True),
    "one_block_independent": _jax(B, chain_blocks=False, block_checksum=True),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_decode_as_the_jax_package_decodes_them(name):
    blob = STREAMS[name]
    want = jframe.decompress(blob, backend="host")
    assert tframe.decompress(blob, device="cpu") == want
    r = tframe.FrameReader(io.BytesIO(blob), device="cpu")
    assert r.read_all() == want
    assert r.bytes_read == len(blob)


@pytest.mark.parametrize("sizes", [[1], [15, 16, 17], [65535, 1], [200000], [-1]])
@pytest.mark.parametrize("name", ["three_frames", "legacy_then_frame", "dictionary_id"])
def test_reads_at_odd_sizes(name, sizes):
    blob = STREAMS[name]
    ours = tframe.FrameReader(io.BytesIO(blob), device="cpu")
    theirs = jframe.FrameReader(io.BytesIO(blob), backend="host")
    k = 0
    while True:
        n = sizes[k % len(sizes)]
        k += 1
        a, b = ours.read(n), theirs.read(n)
        assert a == b
        if not a:
            break
        if n == 1 and k > 40:  # a byte at a time: enough of it
            assert ours.read() == theirs.read()
            break
    assert ours.bytes_read == theirs.bytes_read


@pytest.mark.parametrize("extra", [0, 65536, 200000])
def test_read1_iteration_and_extra_memory(extra):
    blob = _jax(CORPUS[:200000], block_checksum=True) + FB
    ours = tframe.FrameReader(io.BytesIO(blob), device="cpu", extra_memory=extra)
    theirs = jframe.FrameReader(io.BytesIO(blob), backend="host", extra_memory=extra)
    assert ours.read1(10) == theirs.read1(10)
    assert ours.read1() == theirs.read1()
    assert list(ours) == list(theirs)


def test_peek_frame_length_and_descriptor():
    blob = STREAMS["dictionary_id"] + FB
    ours = tframe.FrameReader(io.BytesIO(blob), device="cpu")
    theirs = jframe.FrameReader(io.BytesIO(blob), backend="host")
    assert ours.frame_length() == theirs.frame_length() == len(A)
    assert ours.peek(5) == theirs.peek(5)
    assert ours.peek() == theirs.peek()
    assert ours.read(100) == theirs.read(100)
    assert ours.frame_descriptor.dictionary_id == 7
    with ours, theirs:
        assert ours.read() == theirs.read()
    assert ours.frame_length() is None and ours.read() == b""


def test_a_slow_source():
    class Slow:
        def __init__(self, data):
            self._b = io.BytesIO(data)

        def read(self, n):
            return self._b.read(min(1, n))

    blob = STREAMS["legacy_then_frame"]
    assert tframe.FrameReader(Slow(blob), device="cpu").read_all() == (
        jframe.decompress(blob, backend="host"))


@pytest.mark.parametrize("chain", [True, False], ids=["chained", "independent"])
def test_a_preset_dictionary_decodes_chained_frames_only(chain):
    preset = CORPUS[200000:240000]
    data = preset[:5000] + CORPUS[:80000]
    sink = io.BytesIO()
    with jframe.FrameWriter(sink, jframe.EncoderSettings(chain_blocks=chain),
                            backend="host", dictionary=preset if chain else b"") as w:
        w.write(data)
    blob = sink.getvalue() * 2
    want = jframe.FrameReader(io.BytesIO(blob), dictionary=preset, backend="host").read_all()
    assert tframe.FrameReader(io.BytesIO(blob), dictionary=preset,
                              device="cpu").read_all() == want
    settings = tframe.DecoderSettings(dictionary=preset)
    assert tframe.decompress(blob, settings, device="cpu") == want


def _cuts(chain):
    """A three-block frame with both checksums, cut or spoiled at every
    block boundary."""
    blob = _jax(CORPUS[:150000], chain_blocks=chain, block_checksum=True,
                content_checksum=True)
    scan = _scan_frame(blob)
    cases = {}
    for i, (off, n, _) in enumerate(scan.blocks):
        cases[f"length_word_{i}"] = blob[:off - 2]
        cases[f"data_start_{i}"] = blob[:off]
        cases[f"data_mid_{i}"] = blob[:off + n // 2]
        cases[f"checksum_{i}"] = blob[:off + n + 2]
        bad = bytearray(blob)
        bad[off + n] ^= 1
        cases[f"bad_checksum_{i}"] = bytes(bad)
        bad = bytearray(blob)
        bad[off + 1] ^= 0x40
        cases[f"bad_block_{i}"] = bytes(bad)
    cases["end_mark"] = blob[:scan.tail - 2]
    cases["content_checksum"] = blob[:-2]
    bad = bytearray(blob)
    bad[-1] ^= 1
    cases["bad_content_checksum"] = bytes(bad)
    cases["bad_magic_after"] = blob + b"\x01\x02\x03\x04"
    for k in (1, 2, 3):
        cases[f"trailing_{k}"] = blob + bytes(k)
        cases[f"after_skippable_{k}"] = blob + SKIP + b"\x04\x22\x4d"[:k]
    cases["cut_skippable"] = blob + SKIP[:-2]
    cases["second_frame_cut"] = blob + blob[:-7]
    bad = bytearray(blob + blob)
    bad[len(blob) + scan.blocks[1][0] + 3] ^= 0x10
    cases["second_frame_bad_checksum"] = bytes(bad)
    return cases


CUTS = {chain: _cuts(chain) for chain in (True, False)}


@pytest.mark.parametrize("case", sorted(CUTS[True]))
@pytest.mark.parametrize("chain", [True, False], ids=["chained", "independent"])
def test_faults_at_every_block_boundary(chain, case):
    blob = CUTS[chain][case]
    _same(_outcome(lambda: tframe.decompress(blob, device="cpu")),
          _outcome(lambda: jframe.decompress(blob, backend="host")))
    _same(_outcome(lambda: tframe.FrameReader(io.BytesIO(blob), device="cpu").read_all()),
          _outcome(lambda: jframe.FrameReader(io.BytesIO(blob), backend="host").read_all()))


@pytest.mark.parametrize("case", ["bad_checksum_1", "bad_block_2", "data_mid_2",
                                  "bad_content_checksum", "second_frame_cut"])
def test_faults_reached_by_small_reads(case):
    """Read 20,000 bytes at a time: the same bytes come out before the
    same fault."""
    blob = CUTS[True][case]

    def drain(reader):
        out = bytearray()
        while True:
            chunk = reader.read(20000)
            if not chunk:
                return bytes(out)
            out += chunk

    ours = tframe.FrameReader(io.BytesIO(blob), device="cpu")
    theirs = jframe.FrameReader(io.BytesIO(blob), backend="host")
    _same(_outcome(lambda: drain(ours)), _outcome(lambda: drain(theirs)))


@pytest.mark.parametrize("word", [0x7FFFFFFF, (1 << 23) * 2])
def test_legacy_block_lengths_are_bounded(word):
    blob = struct.pack("<II", 0x184C2102, word) + b"x" * 100
    _same(_outcome(lambda: tframe.decompress(blob, device="cpu")),
          _outcome(lambda: jframe.decompress(blob, backend="host")))


@pytest.mark.parametrize("blob", [b"\x02\x21\x4c\x18\x05", b"\x02\x21\x4c\x18\x05\x00\x00\x00ab",
                                  b"\x02\x21\x4c\x18\x03\x00\x00\x00abc"],
                         ids=["header", "data", "malformed"])
def test_legacy_cuts(blob):
    _same(_outcome(lambda: tframe.decompress(blob, device="cpu")),
          _outcome(lambda: jframe.decompress(blob, backend="host")))


def test_a_pull_stops_at_its_device_memory_budget(monkeypatch):
    """A stream of many blocks decodes in several launches when their rows
    would pass `_PULL_BYTES`."""
    from lz4_tpu_torch.frame import reader

    monkeypatch.setattr(reader, "_PULL_BYTES", 3 * (65536 + 70000))
    blob = _jax(CORPUS[:250000], chain_blocks=False) + _legacy(CORPUS[:120000], 10000)
    r = tframe.FrameReader(io.BytesIO(blob), device="cpu")
    assert r.read_all() == CORPUS[:250000] + CORPUS[:120000]
