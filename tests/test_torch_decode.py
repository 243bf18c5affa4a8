"""Kernel A's plain version against the JAX package's `pallas_decode6`
(interpret mode on the CPU): the same rows, made from a seed, give the
same lengths and error flags exactly, and the same bytes where a row
decodes cleanly."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import liblz4
from lz4_tpu.block import hostref
from lz4_tpu.ops import decode_pallas6 as D6
from lz4_tpu.parallel.blocks import comp_capacity as jax_comp_capacity
from lz4_tpu_torch.ops import decode as D
from lz4_tpu_torch.parallel.blocks import comp_capacity
from test_cross_backend_fuzz import _random_structured

import bench


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode, kept for the whole module so that each
    kernel shape traces once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            pl, "pallas_call",
            functools.partial(pl.pallas_call, interpret=True),
        )
        D6.pallas_decode6.clear_cache()
        yield
        D6.pallas_decode6.clear_cache()


def _stage(streams, cap):
    comps = np.zeros((len(streams), cap), np.uint8)
    clens = np.zeros((len(streams),), np.int32)
    for i, c in enumerate(streams):
        comps[i, : len(c)] = np.frombuffer(c, np.uint8)
        clens[i] = len(c)
    return comps, clens


def _flipped(seed, n):
    """The corrupted rows of test_cross_backend_fuzz: a FAST stream with
    one to five random bit flips."""
    rng = random.Random(7000 + seed)
    comp = bytearray(hostref.encode_fast(_random_structured(rng, n)))
    for _ in range(rng.randrange(1, 6)):
        comp[rng.randrange(len(comp))] ^= 1 << rng.randrange(8)
    return bytes(comp)


def _malformed():
    return [
        bytes([0xFF]) + b"\xff" * 19,               # runaway literal VLE
        bytes([0x04, ord("q"), 0xFF, 0xFF, 0]),    # offset beyond window
        bytes([0x1F, ord("z"), 0x01]),             # match VLE off the end
        bytes([0x44]) + b"abcd" + b"\x00\x00" + b"\x10qrstu",  # offset 0
        bytes([0x4F]) + b"qqqq" + b"\x00\x00",     # offset 0, ml VLE
        b"", b"\x00", b"\x10", b"\x00\x00",        # empty, short, trailing
        bytes([0x00, 0x01, 0x00]),                 # match before any output
    ]


def _assert_same(ours, theirs):
    o, lens, errs = (np.asarray(t) for t in ours)
    jo, jlens, jerrs = (np.asarray(t) for t in theirs)
    assert np.array_equal(lens, jlens), (lens, jlens)
    assert np.array_equal(errs, jerrs), (errs, jerrs)
    for b in np.nonzero(errs == 0)[0]:
        assert np.array_equal(o[b, : lens[b]], jo[b, : jlens[b]]), b


def _rows_4k(rng):
    n = 4096
    datas = [
        _random_structured(rng, rng.choice([100, 2000, 4000]))
        for _ in range(6)
    ] + [
        (bytes([65 + (k % p) for k in range(p)]) * 4000)[:3900]
        for p in (1, 2, 3, 5, 7, 9, 16)
    ] + [
        rng.randbytes(300) + b"A" * 500 + rng.randbytes(270),
        b"E" * 19 + rng.randbytes(1),
        b"F" * 274 + rng.randbytes(3),
        rng.randbytes(15) + rng.randbytes(255) + b"BC" * 200,
        b"x",
    ]
    streams = [liblz4.compress_block(d) for d in datas]
    streams += [liblz4.compress_block(d, level=9) for d in datas[:4]]
    streams += [_flipped(s, n) for s in range(16)]
    streams += _malformed()
    return n, streams


@pytest.mark.parametrize("mode", ["full", "full2", "full2v"])
def test_plain_matches_pallas_4k(mode, interpret):
    n, streams = _rows_4k(random.Random(11))
    cap = comp_capacity(n)
    assert cap == jax_comp_capacity(n)
    comps, clens = _stage(streams, cap)
    theirs = D6.decode_blocks_pallas6(comps, clens, n, mode=mode)
    ours = D.decode_blocks(torch.from_numpy(comps), torch.from_numpy(clens), n, mode=mode)
    _assert_same(ours, theirs)
    errs = np.asarray(ours[2])
    assert (errs != 0).sum() >= len(_malformed()) - 1


@pytest.mark.parametrize("mode", ["full2", "full2v"])
def test_plain_matches_pallas_64k(mode, interpret):
    n = 65536
    corpus = bench.make_corpus(16 * n, seed=3)
    datas = [corpus[k * n : (k + 1) * n] for k in (1, 6, 10, 15)]
    comps, clens = _stage([liblz4.compress_block(d) for d in datas], comp_capacity(n))
    theirs = D6.decode_blocks_pallas6(comps, clens, n, mode=mode)
    ours = D.decode_blocks(torch.from_numpy(comps), torch.from_numpy(clens), n, mode=mode)
    _assert_same(ours, theirs)
    for i, d in enumerate(datas):
        assert ours[0][i, : int(ours[1][i])].numpy().tobytes() == d


def test_plain_matches_pallas_with_dictionaries(interpret):
    rng = random.Random(21)
    n = 4096
    streams, dicts_l, datas = [], [], []
    for k in range(8):
        dct = _random_structured(rng, [0, 100, 4000, 65536, 70000][k % 5])
        start = rng.randrange(max(1, len(dct)))
        data = (dct[start : start + 1500] + _random_structured(rng, 1500))[:n]
        streams.append(liblz4.compress_block_with_dict(data, dct))
        dicts_l.append(dct[-65536:])
        datas.append(data)
    streams.append(bytes([0x00, 0x05, 0x00]))  # reaches before a 4-byte dict
    dicts_l.append(b"wxyz")
    comps, clens = _stage(streams, comp_capacity(n))
    dicts = np.zeros((len(streams), 65536), np.uint8)
    dlens = np.zeros((len(streams),), np.int32)
    for i, d in enumerate(dicts_l):
        if d:
            dicts[i, 65536 - len(d):] = np.frombuffer(d, np.uint8)
        dlens[i] = len(d)
    theirs = D6.decode_blocks_pallas6(comps, clens, n, dicts, dlens)
    ours = D.decode_blocks(
        torch.from_numpy(comps), torch.from_numpy(clens), n,
        torch.from_numpy(dicts), torch.from_numpy(dlens),
    )
    _assert_same(ours, theirs)
    for i, d in enumerate(datas):
        assert int(ours[2][i]) == 0
        assert ours[0][i, : int(ours[1][i])].numpy().tobytes() == d


def test_padding_contract():
    comps = np.zeros((1, 64), np.uint8)
    clens = np.asarray([45], np.int32)
    with pytest.raises(ValueError, match="20 bytes of padding"):
        D6.decode_blocks_pallas6(comps, clens, 64)
    with pytest.raises(ValueError, match="20 bytes of padding"):
        D.decode_blocks(torch.from_numpy(comps), torch.from_numpy(clens), 64)


@pytest.mark.parametrize("mode", ["bogus", "parse", "parse2", "lit"])
def test_unknown_and_profiling_modes_raise(mode):
    comps = torch.zeros((1, 64), dtype=torch.uint8)
    clens = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown decode mode"):
        D.decode_blocks(comps, clens, 64, mode=mode)
