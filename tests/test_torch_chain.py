"""Chained frames on the CPU: the chained decoder's plain version against
the JAX package's chained-decode logic (`_try_chained_device_decompress`:
kernel C once per block, the 64 KB window carried on the host) and its
host decoder; `frame.compress` with the default settings byte-identical to
the JAX package's frames; the one-block API with dictionaries."""

import functools
import io
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lz4_tpu import frame as jframe
from lz4_tpu.block import api as jblock
from lz4_tpu.frame import api as jframe_api
from lz4_tpu.frame.writer import FrameWriter
from lz4_tpu.ops import decode_jax
from lz4_tpu.ops import decode_pallas_stream as JDS
from lz4_tpu.parallel.blocks import comp_capacity
from lz4_tpu_torch import block as tblock
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.frame.api import _scan_single_frame
from lz4_tpu_torch.ops import decode_stream as DS

import bench
import chip_smoke

CORPUS = bench.make_corpus(1 << 20, seed=8)
CHECKSUMS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            pl, "pallas_call",
            functools.partial(pl.pallas_call, interpret=True),
        )
        JDS.pallas_decode_stream.clear_cache()
        yield
        JDS.pallas_decode_stream.clear_cache()


def _jax_chained(data, dictionary=b"", **kw):
    """A chained frame from the JAX package's sequential FrameWriter."""
    sink = io.BytesIO()
    w = FrameWriter(sink, jframe.EncoderSettings(**kw), backend="host",
                    dictionary=dictionary)
    w.write(data)
    w.close()
    return sink.getvalue()


def _jax_chain_decode(blob, dictionary=b""):
    """The JAX package's device chained decode, block by block through
    `pallas_decode_stream` over the JAX package's own block-table scan,
    stopping at the first malformed block: (decoded bytes, bad block or
    -1, its error code)."""
    d, blocks, _ = jframe_api._scan_single_frame(blob, allow_chained=True)
    cap = comp_capacity(d.block_size)
    window = bytes(dictionary[-65536:])
    out = b""
    for k, (off, length, stored) in enumerate(blocks):
        chunk = blob[off:off + length]
        if stored:
            raw = chunk
        else:
            comps = np.zeros((1, cap), np.uint8)
            comps[0, :length] = np.frombuffer(chunk, np.uint8)
            dicts = np.zeros((1, 65536), np.uint8)
            if window:
                dicts[0, 65536 - len(window):] = np.frombuffer(window, np.uint8)
            o, lens, errs = JDS.decode_blocks_pallas_stream(
                comps, np.asarray([length], np.int32), d.block_size, dicts,
                np.asarray([len(window)], np.int32),
            )
            raw = o[0, : lens[0]].tobytes()
            if errs[0]:
                return out + raw, k, int(errs[0])
        out += raw
        window = (window + raw)[-65536:]
    return out, -1, 0


def _ours(blob, dictionary=b""):
    d, blocks, _ = _scan_single_frame(blob)
    table = torch.tensor(blocks, dtype=torch.int64).reshape(-1, 3)
    preset = torch.frombuffer(bytearray(dictionary), dtype=torch.uint8) if dictionary else None
    stream, status = DS.decode_chain(
        torch.frombuffer(bytearray(blob), dtype=torch.uint8), table,
        d.block_size, preset,
    )
    written, bad, err = status.tolist()
    return stream[:written].numpy().tobytes(), bad, err


def _flip(blob, rng):
    _, blocks, _ = _scan_single_frame(blob)
    off, length, _ = blocks[rng.randrange(len(blocks))]
    b = bytearray(blob)
    b[off + rng.randrange(length)] ^= 1 << rng.randrange(8)
    return bytes(b)


def test_decode_chain_matches_the_jax_chained_decode(interpret):
    """Valid, preset-dictionary and corrupt chained frames: the same bytes,
    the same failing block, length and error code."""
    rng = random.Random(12)
    data = CORPUS[:100000]
    preset = CORPUS[600000:680000]
    cases = [(_jax_chained(data), b""),
             (_jax_chained(data, preset), preset)]
    while len(cases) < 4:  # most flips hit a literal: no error
        blob = _flip(cases[0][0], rng)
        if _ours(blob)[1] >= 0:
            cases.append((blob, b""))
    for blob, dictionary in cases:
        assert _ours(blob, dictionary) == _jax_chain_decode(blob, dictionary)
    assert _ours(cases[1][0], preset)[0] == data


@pytest.mark.parametrize("kw", [
    {}, {"block_checksum": True, "content_checksum": True},
    {"content_length": 864680}, {"block_size": 1 << 18},
], ids=["plain", "checksums", "content_length", "256k_blocks"])
def test_decodes_jax_chained_frames_with_stored_blocks(kw):
    rng = random.Random(5)
    data = CORPUS[:200000] + rng.randbytes(600000) + CORPUS[300000:330000] + b"z" * 34680
    assert len(data) == 864680
    blob = _jax_chained(data, **kw)
    d, blocks, pos = _scan_single_frame(blob)
    assert d.block_chaining and any(st for _, _, st in blocks)
    assert (blocks, pos) == jframe_api._scan_single_frame(blob, allow_chained=True)[1:]
    assert tframe.decompress(blob, device="cpu") == data
    assert _ours(blob) == (data, -1, 0)


def test_blocks_at_maximum_expansion_fit_their_slots():
    """chip_smoke's frame of tiny blocks that each decode to close to 255
    times their length: each fits the slot the chained decoder caps it
    with, min(255 * length, block_size), and the bytes are the JAX host
    decoder's; the block past 64 KB fails in both packages."""
    preset = CORPUS[:1000]
    ks = (0, 1, 2, 7, 50, 200, 255)
    expect = preset[-1:] * sum(19 + 255 * k + 254 for k in ks)
    blob = chip_smoke.expansion_frame(ks)
    assert jframe.decompress(
        blob, jframe.DecoderSettings(dictionary=preset), backend="host"
    ) == expect
    assert tframe.decompress(
        blob, tframe.DecoderSettings(dictionary=preset), device="cpu"
    ) == expect
    assert _ours(blob, preset) == (expect, -1, 0)
    blob = chip_smoke.expansion_frame()
    with pytest.raises(ValueError):
        jframe.decompress(blob, jframe.DecoderSettings(dictionary=preset),
                          backend="host")
    with pytest.raises(ValueError):
        tframe.decompress(blob, tframe.DecoderSettings(dictionary=preset),
                          device="cpu")
    assert _ours(blob, preset) == (expect, len(ks), 1)


@pytest.mark.parametrize("size", [0, 1000, 65536, 70000, 200000])
def test_preset_dictionary_frames_decode(size):
    preset = CORPUS[500000:600000]
    data = CORPUS[:size]
    blob = _jax_chained(data, preset)
    settings = tframe.DecoderSettings(dictionary=preset)
    assert tframe.decompress(blob, settings, device="cpu") == data
    assert jframe.decompress(
        blob, jframe.DecoderSettings(dictionary=preset), backend="host"
    ) == data


def test_chip_smoke_frame_with_a_dictionary_is_the_writer_frame():
    """chip_smoke's chained frame over [preset | body] (kernel D's windows)
    is the frame the JAX package's writer makes with that dictionary."""
    preset, body = CORPUS[:100000], CORPUS[400000:400000 + 200000]
    assert chip_smoke.chained_frame(body, preset, torch.device("cpu")) == \
        _jax_chained(body, preset)


def test_corrupt_chained_frames_raise_the_jax_exception_types():
    rng = random.Random(4)
    blob = _jax_chained(CORPUS[:200000])
    found = 0
    while found < 3:
        bad = _flip(blob, rng)
        try:
            want = jframe.decompress(bad, backend="host")
        except ValueError as e:
            with pytest.raises(ValueError) as ours:
                tframe.decompress(bad, device="cpu")
            assert type(ours.value).__name__ == type(e).__name__ == "LZ4FormatError"
            found += 1
        else:
            assert tframe.decompress(bad, device="cpu") == want


@pytest.mark.parametrize("block_checksum,content_checksum", CHECKSUMS)
@pytest.mark.parametrize("size", [0, 1000, 65536, 65537, 150000, 300000])
def test_default_frames_match_the_jax_package(size, block_checksum, content_checksum):
    """The default settings: a chained frame whose bytes are the JAX
    package's (and the sequential writer's)."""
    data = CORPUS[:size]
    kw = dict(block_checksum=block_checksum, content_checksum=content_checksum)
    ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    assert ours == jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
    assert tframe.decompress(ours, device="cpu") == data


@pytest.mark.parametrize("kw,store_size", [
    ({"geometry": "dense"}, False), ({"block_size": 1 << 18}, False),
    ({}, True),
], ids=["dense", "256k_blocks", "content_size"])
def test_chained_settings_match_the_jax_package(kw, store_size):
    data = CORPUS[:400000]
    ours = tframe.compress(data, tframe.EncoderSettings(**kw),
                           store_size=store_size, device="cpu")
    assert ours == jframe.compress(data, jframe.EncoderSettings(**kw),
                                   store_size=store_size, backend="host")
    assert tframe.decompress(ours, device="cpu") == data


def test_canonical_chained_device_requests_raise_as_in_the_jax_package():
    data = CORPUS[:200000]
    with pytest.raises(ValueError, match="canonical chained"):
        jframe.compress(data, jframe.EncoderSettings(geometry="canonical"),
                        backend="tpu")
    with pytest.raises(ValueError, match="canonical chained"):
        tframe.compress(data, tframe.EncoderSettings(geometry="canonical"),
                        device="cpu")
    # HC chains meet the canonical request with their per-block windows
    hc = dict(geometry="canonical", compression_level=9)
    assert tframe.compress(data, tframe.EncoderSettings(**hc), device="cpu") == \
        jframe.compress(data, jframe.EncoderSettings(**hc), backend="host")
    # one block: upstream's single-block rule makes the frame independent
    one = CORPUS[:60000]
    assert tframe.compress(
        one, tframe.EncoderSettings(geometry="canonical"), device="cpu"
    ) == jframe.compress(
        one, jframe.EncoderSettings(geometry="canonical"), backend="host"
    )


@pytest.mark.parametrize("dict_len", [0, 100, 5000, 70000])
@pytest.mark.parametrize("geometry", ["canonical", "dense"])
def test_block_api_matches_the_jax_host_route(dict_len, geometry):
    rng = random.Random(dict_len)
    for n in (0, 10, 1000, 65536, 100000):
        at = rng.randrange(dict_len, len(CORPUS) - n)
        d, s = CORPUS[at - dict_len:at], CORPUS[at:at + n]
        ours = tblock.encode(s, dictionary=d, geometry=geometry, device="cpu")
        assert ours == jblock.encode(s, dictionary=d, geometry=geometry, backend="host")
        assert tblock.decode(ours, n, dictionary=d, device="cpu") == s
        assert tblock.decode(ours, capacity=n + 5, dictionary=d, device="cpu") == s


def test_block_api_errors_match():
    comp = jblock.encode(CORPUS[:5000], backend="host")
    for kw in ({"target_length": 4999}, {"capacity": 4000}):
        with pytest.raises(ValueError) as theirs:
            jblock.decode(comp, backend="host", **kw)
        with pytest.raises(ValueError) as ours:
            tblock.decode(comp, device="cpu", **kw)
        assert type(ours.value).__name__ == type(theirs.value).__name__
    with pytest.raises(ValueError, match="geometry"):
        tblock.encode(b"abc", geometry="auto", device="cpu")
    assert tblock.decode(comp, device="cpu") == decode_jax.decode_block_bytes(comp)
    assert tblock.encode(b"abc", level=9, device="cpu") == \
        jblock.encode(b"abc", level=9, backend="host")
