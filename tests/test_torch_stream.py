"""Kernel D's plain version against the JAX package's `pallas_encode_stream`
(interpret mode on the CPU) and the host parity oracles, and kernel C's
batch form against `pallas_decode_stream`: the same rows, made from a seed,
give the same compressed bytes, lengths and flags, and the same decoded
bytes, lengths and error codes."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import liblz4
from lz4_tpu import native
from lz4_tpu.block import hostref
from lz4_tpu.ops import decode_pallas_stream as JDS
from lz4_tpu.ops import encode_pallas_stream as JES
from lz4_tpu_torch.ops import decode_stream as DS
from lz4_tpu_torch.ops import encode_stream as ES
from lz4_tpu_torch.parallel.blocks import comp_capacity
from test_cross_backend_fuzz import _random_structured

import bench

CORPUS = bench.make_corpus(2 << 20, seed=6)


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode, kept for the whole module so that each
    kernel shape traces once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            pl, "pallas_call",
            functools.partial(pl.pallas_call, interpret=True),
        )
        JES.pallas_encode_stream.clear_cache()
        JDS.pallas_decode_stream.clear_cache()
        yield
        JES.pallas_encode_stream.clear_cache()
        JDS.pallas_decode_stream.clear_cache()


def _stage(rows, width):
    bufs = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        bufs[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return bufs, lens


def _right_aligned(windows, width):
    dicts = np.zeros((len(windows), width), np.uint8)
    for i, w in enumerate(windows):
        if w:
            dicts[i, width - len(w):] = np.frombuffer(w, np.uint8)
    return dicts, np.asarray([len(w) for w in windows], np.int32)


def _assert_same(ours, theirs):
    out, clens, errs = (np.asarray(t) for t in ours)
    jout, jclens, jerrs = (np.asarray(t) for t in theirs)
    assert np.array_equal(clens, jclens), (clens, jclens)
    assert np.array_equal(errs, jerrs), (errs, jerrs)
    for b in range(out.shape[0]):
        n = min(int(clens[b]), out.shape[1])
        assert np.array_equal(out[b, :n], jout[b, :n]), b


SMALL = 20000


def _small_rows():
    rng = random.Random(41)
    return [
        b"", b"q", b"abcdefghijklm", CORPUS[:SMALL],
        CORPUS[700000:700000 + 5000], _random_structured(rng, 12000),
    ]


@pytest.mark.parametrize("geometry", ["canonical", "dense"])
@pytest.mark.parametrize("accel", [1, 8])
def test_plain_matches_pallas_small_rows(geometry, accel, interpret):
    bufs, lens = _stage(_small_rows(), SMALL)
    theirs = JES.encode_blocks_pallas_stream(
        bufs, lens, SMALL, 0, accel, fast_schedule=geometry
    )
    ours = ES.encode_blocks_stream(
        torch.from_numpy(bufs), torch.from_numpy(lens), SMALL, 0, accel,
        fast_schedule=geometry,
    )
    _assert_same(ours, theirs)
    assert ours[0].shape == theirs[0].shape


@pytest.mark.parametrize("accel", [1, 8])
def test_plain_matches_pallas_with_dictionaries(accel, interpret):
    rows, windows = [], []
    for k, dl in enumerate((0, 3000, 8192, 8192, 100)):
        at = 100000 + k * 300000
        rows.append(CORPUS[at:at + SMALL - 1000 * k])
        windows.append(CORPUS[at - dl:at])
    bufs, lens = _stage(rows, SMALL)
    dicts, dls = _right_aligned(windows, 8192)
    theirs = JES.encode_blocks_pallas_stream(
        bufs, lens, SMALL, 0, accel, dicts=dicts, dict_lens=dls
    )
    ours = ES.encode_blocks_stream(
        torch.from_numpy(bufs), torch.from_numpy(lens), SMALL, 0, accel,
        torch.from_numpy(dicts), torch.from_numpy(dls),
    )
    _assert_same(ours, theirs)


@pytest.mark.parametrize("accel", [1, 2, 7, 65537])
def test_canonical_byu32_matches_the_host_oracle(accel):
    """The byU16/byU32 edge (65,546 and 65,547 bytes) and whole byU32
    blocks: byte-identical to upstream's one-shot schedule."""
    sizes = [65546, 65547, 100000, 262144]
    rows = [CORPUS[k * 400000:k * 400000 + n] for k, n in enumerate(sizes)]
    bufs, lens = _stage(rows, max(sizes))
    out, clens, errs = ES.encode_blocks_stream(
        torch.from_numpy(bufs), torch.from_numpy(lens), max(sizes), 0, accel
    )
    assert not errs.any()
    for i, r in enumerate(rows):
        got = out[i, : int(clens[i])].numpy().tobytes()
        assert got == hostref.encode_fast_canonical(r, accel), (sizes[i], accel)
    if accel == 1:
        assert got == liblz4.compress_block(rows[-1])


@pytest.mark.parametrize("dict_len", [0, 100, 4000, 65535, 65536, 70000])
def test_dictionary_rows_match_the_host_oracle(dict_len):
    """Dense rows with a preset dictionary up to a full 64 KB window (a
    longer one is cut to its last 64 KB, as the host engines cut it)."""
    at = 1 << 20
    window = CORPUS[at - dict_len:at]
    rows = [CORPUS[at:at + 65536], CORPUS[at + 70000:at + 75000]]
    bufs, lens = _stage(rows, 65536)
    dicts, dls = _right_aligned([window] * 2, 70000)
    out, clens, errs = ES.encode_blocks_stream(
        torch.from_numpy(bufs), torch.from_numpy(lens), 65536, 0, 1,
        torch.from_numpy(dicts), torch.from_numpy(dls),
    )
    assert not errs.any()
    for i, r in enumerate(rows):
        got = out[i, : int(clens[i])].numpy().tobytes()
        assert got == hostref.encode_fast(r, window), i


def test_windows_of_one_payload_equal_staged_dictionary_rows():
    """The chained path's layout (overlapping windows of one payload)
    gives the bytes of the same rows staged with right-aligned
    dictionaries."""
    bs = 16384
    data = CORPUS[:5 * bs + 777]
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    starts = torch.arange(6, dtype=torch.int64) * bs
    dls = starts.clamp(max=65536)
    ends = (starts + bs).clamp(max=len(data))
    ours = ES.encode_windows(
        payload, starts - dls, dls, ends - starts + dls, bs,
        fast_schedule="dense",
    )
    rows = [data[a:b] for a, b in zip(starts.tolist(), ends.tolist())]
    windows = [data[a - d:a] for a, d in zip(starts.tolist(), dls.tolist())]
    bufs, lens = _stage(rows, bs)
    dicts, dl = _right_aligned(windows, 65536)
    staged = ES.encode_blocks_stream(
        torch.from_numpy(bufs), torch.from_numpy(lens), bs, 0, 1,
        torch.from_numpy(dicts), torch.from_numpy(dl),
    )
    _assert_same(ours, staged)


def test_bad_arguments_raise():
    payload = torch.zeros((100,), dtype=torch.uint8)
    one = torch.tensor([0], dtype=torch.int64)
    with pytest.raises(ValueError, match="canonical schedule takes no prefix"):
        ES.encode_windows(payload, one, [4], [50], 64)
    with pytest.raises(ValueError, match="outside base_u8"):
        ES.encode_windows(payload, [60], [0], [50], 64)
    with pytest.raises(ValueError, match="block lengths"):
        ES.encode_windows(payload, one, [0], [80], 64)
    with pytest.raises(ValueError, match="src_offs"):
        ES.encode_windows(payload, one, [70000], [70010], 64, fast_schedule="dense")
    with pytest.raises(ValueError, match="geometry"):
        ES.encode_windows(payload, one, [0], [50], 64, fast_schedule="auto")
    for level in (3, 10):  # the HC and OPT arms take any geometry and prefix
        out, clens, _ = ES.encode_blocks_stream(
            torch.zeros((1, 64), dtype=torch.uint8), [5], 64, level)
        assert out[0, : int(clens[0])].numpy().tobytes() == native.encode(bytes(5), level)
        out, clens, _ = ES.encode_windows(payload, one, [4], [50], 64, level)
        assert out[0, : int(clens[0])].numpy().tobytes() == native.encode(
            bytes(46), level, dictionary=bytes(4))


def _flipped(rng, comp):
    comp = bytearray(comp)
    for _ in range(rng.randrange(1, 6)):
        comp[rng.randrange(len(comp))] ^= 1 << rng.randrange(8)
    return bytes(comp)


@pytest.mark.parametrize("mode", ["full", "full2v"])
def test_stream_decode_matches_pallas(mode, interpret):
    """C's batch form at out_cap 131,072: valid rows with dictionaries of
    0 to 65,536 bytes, rows with flipped bits and malformed rows give the
    same bytes, lengths and error codes as `pallas_decode_stream`."""
    rng = random.Random(17)
    out_cap = 131072
    streams, windows, datas = [], [], []
    for k, dl in enumerate((0, 100, 5000, 65536)):
        at = 200000 + k * 400000
        data = CORPUS[at:at + 30000 + 7000 * k]
        window = CORPUS[at - dl:at]
        streams.append(liblz4.compress_block_with_dict(data, window)
                       if dl else liblz4.compress_block(data))
        windows.append(window)
        datas.append(data)
    for k in range(4):
        streams.append(_flipped(rng, streams[k]))
        windows.append(windows[k % 4])
    malformed = [bytes([0xFF]) + b"\xff" * 19, bytes([0x04, 113, 0xFF, 0xFF, 0]),
                 b"", b"\x00\x00", bytes([0x00, 0x05, 0x00])]
    streams += malformed
    windows += [b"wxyz"] * len(malformed)
    cap = comp_capacity(out_cap)
    comps, clens = _stage(streams, cap)
    dicts, dls = _right_aligned(windows, 65536)
    theirs = JDS.decode_blocks_pallas_stream(comps, clens, out_cap, dicts, dls, mode=mode)
    ours = DS.decode_blocks_stream(
        torch.from_numpy(comps), torch.from_numpy(clens), out_cap,
        torch.from_numpy(dicts), torch.from_numpy(dls), mode=mode,
    )
    o, lens, errs = (np.asarray(t) for t in ours)
    jo, jlens, jerrs = (np.asarray(t) for t in theirs)
    assert np.array_equal(lens, jlens), (lens, jlens)
    assert np.array_equal(errs, jerrs), (errs, jerrs)
    for b in range(len(streams)):
        assert np.array_equal(o[b, : lens[b]], jo[b, : lens[b]]), b
    for i, d in enumerate(datas):
        assert o[i, : lens[i]].tobytes() == d
    assert (errs[-len(malformed):] != 0).all()


@pytest.mark.parametrize("mode", ["full2", "parse", "bogus"])
def test_unknown_stream_modes_raise(mode):
    comps = torch.zeros((1, 64), dtype=torch.uint8)
    clens = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown streaming decode mode"):
        DS.decode_blocks_stream(comps, clens, 64, mode=mode)
    with pytest.raises(ValueError, match="unknown streaming decode mode"):
        JDS.decode_blocks_pallas_stream(comps.numpy(), clens.numpy(), 64, mode=mode)
