"""The port's FrameWriter on the CPU, held to `lz4_tpu.frame.FrameWriter`
(backend "host"): the same frame for the same sequence of writes, at odd
split points, with flushes, extra_memory, preset dictionaries shorter and
longer than 64 KB, a first write shorter than a block, checksums and
content sizes; the same refusals; `bytes_written` and `closed`."""

import io

import pytest

import bench
from lz4_tpu import frame as jframe
from lz4_tpu_torch import frame as tframe

CORPUS = bench.make_corpus(1 << 18, seed=41)


def _write(writer_cls, settings, splits, data, flush_at=(), **kw):
    sink = io.BytesIO()
    w = writer_cls(sink, settings, **kw)
    pos, k, written = 0, 0, []
    while pos < len(data):
        n = splits[k % len(splits)]
        assert w.write(data[pos:pos + n]) == len(data[pos:pos + n])
        pos, k = pos + n, k + 1
        if k in flush_at:
            w.flush()
        written.append(w.bytes_written)
    assert not w.closed
    w.close()
    assert w.closed
    w.close()  # a second close writes nothing
    return sink.getvalue(), written + [w.bytes_written]


def _both(kw, splits, data, flush_at=(), dictionary=b""):
    ours = _write(tframe.FrameWriter, tframe.EncoderSettings(**kw), splits, data,
                  flush_at, device="cpu", dictionary=dictionary)
    theirs = _write(jframe.FrameWriter, jframe.EncoderSettings(**kw), splits, data,
                    flush_at, backend="host", dictionary=dictionary)
    assert ours == theirs
    return ours[0]


SPLITS = [[1, 15, 16, 17], [65535, 2], [65536], [200000], [1, 70000, 3]]


@pytest.mark.parametrize("splits", SPLITS, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("kw", [
    dict(), dict(chain_blocks=False), dict(block_checksum=True, content_checksum=True),
    dict(chain_blocks=False, block_checksum=True, content_checksum=True),
], ids=["chained", "independent", "chained_both", "independent_both"])
def test_frames_equal_the_jax_writer_at_odd_splits(kw, splits):
    data = CORPUS[:140000] if splits[0] != 1 else CORPUS[:3000]
    blob = _both(kw, splits, data)
    assert tframe.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("flush_at", [(1,), (1, 2, 3), (2, 5)])
@pytest.mark.parametrize("chain", [True, False])
def test_flushes_make_short_blocks(chain, flush_at):
    data = CORPUS[:150000]
    blob = _both(dict(chain_blocks=chain, block_checksum=True), [30000, 5], data, flush_at)
    assert tframe.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("dict_len", [1, 1000, 65535, 65536, 100000])
@pytest.mark.parametrize("first", [100, 65536, 140000])
def test_preset_dictionaries_reach_the_first_window(dict_len, first):
    preset = CORPUS[150000:150000 + dict_len]
    data = CORPUS[150000:150000 + min(dict_len, 8000)] + CORPUS[:first]
    blob = _both(dict(), [first, 70000], data, dictionary=preset)
    settings = tframe.DecoderSettings(dictionary=preset)
    assert tframe.decompress(blob, settings, device="cpu") == data


@pytest.mark.parametrize("extra", [0, 65536, 3 * 65536])
def test_extra_memory_batches_independent_blocks(extra):
    data = CORPUS[:250000]
    _both(dict(chain_blocks=False, extra_memory=extra), [40000], data, flush_at=(3,))
    _both(dict(extra_memory=extra), [40000], data)


def test_levels_3_and_9_and_geometries():
    data = CORPUS[:20000]
    _both(dict(compression_level=3), [7000], data)
    _both(dict(chain_blocks=False, compression_level=9), [7000], data)
    _both(dict(chain_blocks=False, geometry="dense"), [7000], data)
    _both(dict(geometry="dense"), [7000], data)


@pytest.mark.parametrize("declared", [0, 9999, 10000, 10001])
def test_content_size_is_checked_at_close(declared):
    data = CORPUS[:10000]
    kw = dict(content_length=declared)
    outcomes = []
    for cls, settings, extra in (
        (tframe.FrameWriter, tframe.EncoderSettings(**kw), dict(device="cpu")),
        (jframe.FrameWriter, jframe.EncoderSettings(**kw), dict(backend="host")),
    ):
        sink = io.BytesIO()
        w = cls(sink, settings, **extra)
        w.write(data)
        try:
            w.close()
            outcomes.append(("ok", sink.getvalue()))
        except ValueError as e:
            outcomes.append(("ValueError", str(e)))
    assert outcomes[0] == outcomes[1]


def test_empty_frames():
    for kw in (dict(), dict(content_checksum=True), dict(content_length=0)):
        blob = _both(kw, [1], b"")
        assert tframe.decompress(blob, device="cpu") == b""


def test_refusals_match():
    cases = [
        (dict(chain_blocks=False), dict(dictionary=b"abc")),
        (dict(geometry="canonical"), {}),
    ]
    for kw, extra in cases:
        with pytest.raises(ValueError) as theirs:
            jframe.FrameWriter(io.BytesIO(), jframe.EncoderSettings(**kw), **extra)
        with pytest.raises(ValueError) as ours:
            tframe.FrameWriter(io.BytesIO(), tframe.EncoderSettings(**kw),
                               device="cpu", **extra)
        assert str(ours.value) == str(theirs.value)
    w = tframe.FrameWriter(io.BytesIO(), device="cpu")
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.write(b"x")
    w.flush()  # a closed writer's flush does nothing


def test_canonical_chains_at_levels_3_and_up_are_written():
    data = CORPUS[:70000]
    _both(dict(geometry="canonical", compression_level=3), [30000], data)


def test_a_tensor_write_equals_a_bytes_write():
    import torch

    data = CORPUS[:100000]
    sink = io.BytesIO()
    with tframe.FrameWriter(sink, tframe.EncoderSettings(content_checksum=True),
                            device="cpu") as w:
        w.write(torch.frombuffer(bytearray(data[:60000]), dtype=torch.uint8))
        w.write(data[60000:])
    assert sink.getvalue() == _both(dict(content_checksum=True), [60000, 40000], data)
