"""Kernel B's HC (levels 3-9) and OPT (levels 10-12) arms: the plain
versions against the JAX package's `pallas_encode5` in interpret mode on the
CPU, on the 4 KB rows of its own HC and OPT tests.  The same rows, made from
a seed, give the same compressed bytes, lengths and flags (exact equality);
levels above 12 give level 12's bytes."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lz4_tpu.ops import encode_pallas5 as E5
from lz4_tpu_torch.ops import encode as E
from lz4_tpu_torch.ops import encode_stream as ES
from test_pallas_encode5 import _cases

N = 4096


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            pl, "pallas_call",
            functools.partial(pl.pallas_call, interpret=True),
        )
        E5.pallas_encode5.clear_cache()
        yield
        E5.pallas_encode5.clear_cache()


def _rows():
    """The 4 KB cases of the JAX package's HC/OPT tests, from one seed."""
    rng = random.Random(1234)
    return _cases(rng) + [
        (b"abcabcabcabd" * 300)[:3500],
        rng.randbytes(64) * 60,
        b"".join(
            rng.choice([b"the ", b"quick ", b"brown ", b"fox "])
            for _ in range(800)
        )[:3500],
        b"", b"q" * 12, b"abcdefghijklm",
    ]


def _stage(datas, width):
    bufs = np.zeros((len(datas), width), np.uint8)
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


@pytest.mark.parametrize("level", [3, 6, 9, 10, 11, 12])
def test_hc_and_opt_match_pallas(level, interpret):
    bufs, lens = _stage(_rows(), N + 1024)
    theirs = E5.encode_blocks_pallas5(bufs, lens, N, level)
    ours = E.encode_blocks(torch.from_numpy(bufs), torch.from_numpy(lens), N, level)
    assert not ours[2].any()
    _assert_same(ours, theirs)


@pytest.mark.parametrize("level", [13, 16])
def test_levels_above_12_run_level_12(level):
    rows = _rows()
    bufs, lens = _stage([rows[0], rows[5], rows[-4], rows[-1]], N + 1024)
    b, n = torch.from_numpy(bufs), torch.from_numpy(lens)
    _assert_same(E.encode_blocks(b, n, N, level), E.encode_blocks(b, n, N, 12))
    _assert_same(ES.encode_blocks_stream(b, n, N, level),
                 ES.encode_blocks_stream(b, n, N, 12))
