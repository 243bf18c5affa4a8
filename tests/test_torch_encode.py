"""Kernel B's plain version against the JAX package's `pallas_encode5`
(interpret mode on the CPU) at the FAST levels: the same rows, made from a
seed, give the same compressed bytes, lengths and flags; the canonical
geometry also equals LZ4_compress_default."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import liblz4
from lz4_tpu.ops import encode_pallas5 as E5
from lz4_tpu.ops.common import LEVEL_ATTEMPTS
from lz4_tpu_torch.ops import encode as E
from lz4_tpu_torch.ops import encode_stream as ES
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
        E5.pallas_encode5.clear_cache()
        yield
        E5.pallas_encode5.clear_cache()


def _stage(datas, bcap):
    bufs = np.zeros((len(datas), bcap + 1024), np.uint8)
    lens = np.zeros((len(datas),), np.int32)
    for i, d in enumerate(datas):
        bufs[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return bufs, lens


def _assert_same(ours, theirs):
    out, clens, errs = (np.asarray(t) for t in ours)
    jout, jclens, jerrs = (np.asarray(t) for t in theirs)
    assert np.array_equal(clens, jclens), (clens, jclens)
    assert np.array_equal(errs, jerrs)
    for b in range(out.shape[0]):
        assert np.array_equal(out[b, : clens[b]], jout[b, : clens[b]]), b


def _rows_4k():
    rng = random.Random(31)
    return [
        b"", b"q", b"abcdefghijklm", b"x" * 12, b"yz" * 6 + b"w",
        bytes(4096), rng.randbytes(4096), b"ab" * 2048,
    ] + [_random_structured(rng, rng.choice([200, 3000, 4096])) for _ in range(6)]


def _rows_64k():
    n = 65536
    corpus = bench.make_corpus(16 * n, seed=5)
    return [corpus[k * n : (k + 1) * n] for k in (2, 7, 13)]


@pytest.mark.parametrize("geometry", ["canonical", "dense"])
@pytest.mark.parametrize("accel", [1, 8])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_plain_matches_pallas_4k(level, accel, geometry, interpret):
    bufs, lens = _stage(_rows_4k(), 4096)
    theirs = E5.encode_blocks_pallas5(bufs, lens, 4096, level, accel, geometry)
    ours = E.encode_blocks(
        torch.from_numpy(bufs), torch.from_numpy(lens), 4096, level, accel,
        geometry,
    )
    _assert_same(ours, theirs)
    assert ours[0].shape[1] == 5120  # align1024(compress_bound(4096))


@pytest.mark.parametrize("geometry", ["canonical", "dense"])
@pytest.mark.parametrize("accel", [1, 8])
def test_plain_matches_pallas_64k(accel, geometry, interpret):
    datas = _rows_64k()
    bufs, lens = _stage(datas, 65536)
    theirs = E5.encode_blocks_pallas5(bufs, lens, 65536, 0, accel, geometry)
    # levels 0-2 are one arm (depth 0) in both packages
    assert all(LEVEL_ATTEMPTS[lv] == 0 for lv in (0, 1, 2))
    for level in (0, 1, 2):
        ours = E.encode_blocks(
            torch.from_numpy(bufs), torch.from_numpy(lens), 65536, level,
            accel, geometry,
        )
        _assert_same(ours, theirs)
    if geometry == "canonical" and accel == 1:
        out, clens, _ = ours
        for i, d in enumerate(datas):
            assert out[i, : int(clens[i])].numpy().tobytes() == \
                liblz4.compress_block(d)


def test_canonical_equals_lz4_compress_default():
    datas = _rows_4k()
    bufs, lens = _stage(datas, 4096)
    out, clens, errs = E.encode_blocks(torch.from_numpy(bufs), torch.from_numpy(lens), 4096)
    assert not errs.any()
    for i, d in enumerate(datas):
        assert out[i, : int(clens[i])].numpy().tobytes() == liblz4.compress_block(d), i


@pytest.mark.parametrize("bcap", [65537, 1 << 18])
def test_blocks_above_64k_are_not_ported(bcap):
    """Kernel B (16-bit tables) refuses blocks above 64 KB; kernel D takes
    them, with LZ4_compress_default's bytes."""
    data = bench.make_corpus(bcap, seed=2)
    bufs, lens = _stage([data], bcap)
    b, n = torch.from_numpy(bufs), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="kernel D"):
        E.encode_blocks(b, n, bcap)
    out, clens, errs = ES.encode_blocks_stream(b, n, bcap)
    assert int(errs[0]) == 0
    assert out[0, : int(clens[0])].numpy().tobytes() == liblz4.compress_block(data)


def test_bad_arguments_raise():
    bufs, lens = _stage([b"abc"], 64)
    b, n = torch.from_numpy(bufs), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="geometry"):
        E.encode_blocks(b, n, 64, fast_schedule="auto")
    with pytest.raises(ValueError, match="row lengths"):
        E.encode_blocks(b, torch.tensor([65], dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="bcap"):
        E.encode_blocks(b, n, 4096)


def test_copied_helpers_equal_the_reference():
    from lz4_tpu.constants import compress_bound as jcb
    from lz4_tpu.ops import common as jc
    from lz4_tpu_torch.constants import compress_bound
    from lz4_tpu_torch.ops import common

    assert common.LEVEL_ATTEMPTS == jc.LEVEL_ATTEMPTS
    for n in (0, 1, 1000, 4096, 4097, 65536, 65537, 1 << 22):
        assert common.bucket(n) == jc.bucket(n)
        assert common.align1024(n) == jc.align1024(n)
        assert common.round_up(n, 128) == jc.round_up(n, 128)
        assert compress_bound(n) == jcb(n)
