"""Kernel D's HC (levels 3-9) and OPT (levels 10-12) arms: the plain
versions against the JAX package's `pallas_encode_stream` in interpret mode
on the CPU, on the rows of its own HC, OPT and dictionary tests: the same
rows, made from a seed, give the same compressed bytes, lengths and flags
(exact equality)."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lz4_tpu.ops import encode_pallas_stream as JES
from lz4_tpu_torch.ops import encode_stream as ES


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            pl, "pallas_call",
            functools.partial(pl.pallas_call, interpret=True),
        )
        JES.pallas_encode_stream.clear_cache()
        yield
        JES.pallas_encode_stream.clear_cache()


def _assert_same(ours, theirs):
    out, clens, errs = (np.asarray(t) for t in ours)
    jout, jclens, jerrs = (np.asarray(t) for t in theirs)
    assert not errs.any()
    assert np.array_equal(clens, jclens), (clens, jclens)
    assert np.array_equal(errs, jerrs)
    for b in range(out.shape[0]):
        assert np.array_equal(out[b, : clens[b]], jout[b, : clens[b]]), b


def _wordy(rng, nwords, minw, maxw, count, n):
    words = [rng.randbytes(rng.randint(minw, maxw)) for _ in range(nwords)]
    return b"".join(rng.choice(words) for _ in range(count))[:n]


@pytest.mark.parametrize("level,kb", [(3, 48), (10, 20)])
def test_one_row_matches_pallas(level, kb, interpret):
    """A 48 KB row at level 3 and a 20 KB row at level 10, no prefix."""
    rng = random.Random(level)
    bcap = kb * 1024
    data = _wordy(rng, 40, 2, 9, bcap // 4, bcap)
    bufs = np.zeros((1, bcap + 1024), np.uint8)
    bufs[0, : len(data)] = np.frombuffer(data, np.uint8)
    lens = np.asarray([len(data)], np.int32)
    theirs = JES.encode_blocks_pallas_stream(bufs, lens, bcap, level)
    ours = ES.encode_blocks_stream(torch.from_numpy(bufs), torch.from_numpy(lens), bcap, level)
    _assert_same(ours, theirs)


@pytest.mark.parametrize("level", [9, 12])
def test_dictionary_rows_match_pallas(level, interpret):
    """8 KB blocks with prefixes of 3,000, 65,536 and 0 bytes, and a
    12-byte block with a prefix (all literals, as in the TPU kernel)."""
    rng = random.Random(200)
    words = [rng.randbytes(rng.randint(3, 8)) for _ in range(30)]

    def wordy(n):
        return b" ".join(rng.choice(words) for _ in range(n * 2))[:n]

    cap, dw = 8192, 65536
    cases = [(wordy(dl), wordy(cap)) for dl in (3000, 65536, 0)]
    cases.append((wordy(500), wordy(12)))
    bufs = np.zeros((len(cases), cap), np.uint8)
    lens = np.zeros((len(cases),), np.int32)
    dicts = np.zeros((len(cases), dw), np.uint8)
    dls = np.zeros((len(cases),), np.int32)
    for k, (d, s) in enumerate(cases):
        bufs[k, : len(s)] = np.frombuffer(s, np.uint8)
        lens[k] = len(s)
        if d:
            dicts[k, dw - len(d):] = np.frombuffer(d, np.uint8)
        dls[k] = len(d)
    theirs = JES.encode_blocks_pallas_stream(
        bufs, lens, cap, level, dicts=dicts, dict_lens=dls
    )
    ours = ES.encode_blocks_stream(
        torch.from_numpy(bufs), torch.from_numpy(lens), cap, level,
        dicts=torch.from_numpy(dicts), dict_lens=torch.from_numpy(dls),
    )
    _assert_same(ours, theirs)
