"""The port's frame facades on the CPU, held to the JAX package's
(backend "host"): `LZ4FrameFile` and `open` over paths and file objects,
`compress_into` and `decompress_into` (sizes, a too-small or read-only
buffer, the empty frame), `skippable_frame`, and the async facades
(`frame.aio`)."""

import asyncio
import io

import numpy as np
import pytest

import bench
from lz4_tpu import frame as jframe
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.frame import aio

CORPUS = bench.make_corpus(1 << 18, seed=61)
DATA = CORPUS[:90000]


@pytest.mark.parametrize("kw", [dict(), dict(chain_blocks=False, content_checksum=True),
                                dict(block_checksum=True, content_length=len(DATA))])
def test_open_writes_the_jax_frame_and_reads_it_back(tmp_path, kw):
    path = tmp_path / "x.lz4"
    with tframe.open(path, "wb", settings=tframe.EncoderSettings(**kw), device="cpu") as f:
        assert f.writable() and not f.readable()
        for a in range(0, len(DATA), 7000):
            assert f.write(DATA[a:a + 7000]) == len(DATA[a:a + 7000])
        assert f.tell() == len(DATA)
        assert f.length is None
    with jframe.open(tmp_path / "y.lz4", "wb", settings=jframe.EncoderSettings(**kw),
                     backend="host") as f:
        for a in range(0, len(DATA), 7000):
            f.write(DATA[a:a + 7000])
    assert path.read_bytes() == (tmp_path / "y.lz4").read_bytes()
    with tframe.open(path, "rb", device="cpu") as f:
        assert f.readable() and not f.writable()
        assert f.length == kw.get("content_length")
        assert f.read(10) == DATA[:10]
        assert f.read1(5) == DATA[10:15]
        buf = bytearray(100)
        assert f.readinto(buf) == 100 and bytes(buf) == DATA[15:115]
        assert f.read() == DATA[115:]
        assert f.tell() == len(DATA)
    with tframe.open(path, "rb", device="cpu") as f:
        assert io.BufferedReader(f).read() == DATA


def test_file_objects_are_not_closed_and_modes_are_checked():
    sink = io.BytesIO()
    with tframe.open(sink, "wb", device="cpu") as f:
        f.write(DATA[:1000])
        f.flush()
        for read in (f.read, f.read1):
            with pytest.raises(io.UnsupportedOperation):
                read()
    assert not sink.closed
    with tframe.LZ4FrameFile(io.BytesIO(sink.getvalue()), device="cpu",
                             close_inner=False) as f:
        with pytest.raises(io.UnsupportedOperation):
            f.write(b"x")
        assert f.read() == DATA[:1000]
    f.close()  # a second close does nothing


@pytest.mark.parametrize("length", [0, 1337, 0x10000, 90000])
def test_compress_into_sizes(length):
    data = DATA[:length]
    blob = tframe.compress(data, device="cpu")
    assert blob == jframe.compress(data, backend="host")
    buf = bytearray(len(blob))
    assert tframe.compress_into(data, buf, device="cpu") == len(blob)
    assert bytes(buf) == blob
    for dst in (bytearray(len(blob) - 1), bytes(len(blob))):
        with pytest.raises(ValueError) as ours:
            tframe.compress_into(data, dst, device="cpu")
        with pytest.raises(ValueError) as theirs:
            jframe.compress_into(data, dst)
        assert str(ours.value) == str(theirs.value)


STREAMS = {
    "chained": jframe.compress(DATA, backend="host"),
    "independent": jframe.compress(DATA, jframe.EncoderSettings(chain_blocks=False),
                                   backend="host"),
    "two_frames": jframe.compress(DATA[:5000], backend="host") * 2,
    "checksums": jframe.compress(DATA, jframe.EncoderSettings(
        block_checksum=True, content_checksum=True), backend="host"),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decompress_into(name):
    blob = STREAMS[name]
    want = jframe.decompress(blob, backend="host")
    dst = bytearray(len(want) + 10)
    assert tframe.decompress_into(blob, dst, device="cpu") == len(want)
    assert bytes(dst[:len(want)]) == want
    with pytest.raises(ValueError):
        tframe.decompress_into(blob, bytearray(len(want) - 1), device="cpu")
    with pytest.raises(ValueError) as ours:
        tframe.decompress_into(blob, bytes(len(want)), device="cpu")
    with pytest.raises(ValueError) as theirs:
        jframe.decompress_into(blob, bytes(len(want)))
    assert str(ours.value) == str(theirs.value)


def test_decompress_into_an_empty_frame():
    dst = np.empty(8, np.uint8)
    for chain in (False, True):
        for cs in (False, True):
            blob = tframe.compress(b"", tframe.EncoderSettings(
                chain_blocks=chain, content_checksum=cs), device="cpu")
            assert blob == jframe.compress(b"", jframe.EncoderSettings(
                chain_blocks=chain, content_checksum=cs), backend="host")
            assert tframe.decompress(blob, device="cpu") == b""
            assert tframe.decompress_into(blob, dst, device="cpu") == 0
    assert tframe.decompress_into(b"", dst, device="cpu") == 0


def test_decompress_into_a_bad_content_checksum_of_one_block():
    bad = bytearray(jframe.compress(DATA[:5000], jframe.EncoderSettings(
        chain_blocks=False, content_checksum=True), backend="host"))
    bad[-1] ^= 1
    with pytest.raises(ValueError) as ours:
        tframe.decompress_into(bytes(bad), bytearray(6000), device="cpu")
    with pytest.raises(ValueError) as theirs:
        jframe.decompress_into(bytes(bad), bytearray(6000))
    assert (type(ours.value).__name__, str(ours.value)) == (
        type(theirs.value).__name__, str(theirs.value))


@pytest.mark.parametrize("nibble", [0, 7, 15])
@pytest.mark.parametrize("payload", [b"", b"app-metadata"])
def test_skippable_frames(nibble, payload):
    meta = tframe.skippable_frame(payload, nibble=nibble)
    assert meta == jframe.skippable_frame(payload, nibble=nibble)
    blob = meta + STREAMS["chained"] + meta
    assert tframe.decompress(blob, device="cpu") == DATA


def test_skippable_frame_refuses_a_bad_nibble():
    for nibble in (-1, 16):
        with pytest.raises(ValueError) as ours:
            tframe.skippable_frame(b"x", nibble=nibble)
        with pytest.raises(ValueError) as theirs:
            jframe.skippable_frame(b"x", nibble=nibble)
        assert str(ours.value) == str(theirs.value)


def test_async_facades():
    async def run():
        blob = await aio.compress(DATA, device="cpu")
        return blob, await aio.decompress(blob, device="cpu")

    blob, out = asyncio.run(run())
    assert out == DATA and blob == jframe.compress(DATA, backend="host")


def test_async_writer_and_reader():
    class Sink:
        def __init__(self):
            self.parts = []

        async def write(self, b):
            self.parts.append(bytes(b))

    class Source:
        def __init__(self, data):
            self.data, self.pos, self.requests = data, 0, []

        async def read(self, n):
            self.requests.append(n)
            out = self.data[self.pos:self.pos + n + 3]  # over-returns
            self.pos += len(out)
            return out

    async def run():
        sink = Sink()
        async with aio.AsyncFrameWriter(sink, device="cpu") as w:
            await asyncio.gather(*(w.write(DATA[i:i + 7000])
                                   for i in range(0, 21000, 7000)))
        blob = b"".join(sink.parts)
        src = Source(blob)
        r = aio.AsyncFrameReader(src, device="cpu")
        async with r:
            head = await r.read(100)
            assert src.pos < len(blob)
            rest = await r.read(-1)
        assert all(0 < n <= 4 * 1024 * 1024 + 8 for n in src.requests)
        return blob, head + rest

    blob, out = asyncio.run(run())
    assert out == DATA[:21000]
    assert jframe.decompress(blob, backend="host") == DATA[:21000]
