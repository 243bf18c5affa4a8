"""Kernel E's plain versions (`lz4_tpu_torch.ops.xxh32`) against the JAX
package's `pallas_xxh32` in interpret mode and its native xxHash32: the
same hashes, bit for bit, on rows, on windows at every alignment of one
flat tensor and on batches of random lengths; and the wrappers' checks."""

import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lz4_tpu.ops import xxh32_pallas as XP
from lz4_tpu.xxh32 import xxh32 as native
from lz4_tpu_torch.ops import xxh32 as X

LENGTHS = [0, 1, 3, 4, 15, 16, 17, 31, 32, 100, 1024, 4097, 65536]


@pytest.fixture
def interpret(monkeypatch):
    """Pallas in interpret mode, as tests/test_xxh32_pallas.py runs it."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    XP.pallas_xxh32.clear_cache()
    yield
    XP.pallas_xxh32.clear_cache()


def _natives(bufs, lens):
    return [native(bufs[i, :n].tobytes()) for i, n in enumerate(lens)]


def test_rows_match_pallas_xxh32_and_native(interpret):
    """One row of each length, with noise past each length (it must not
    count); the wrapper on a CPU tensor runs the plain version and counts
    no launch."""
    rng = np.random.default_rng(0)
    bufs = rng.integers(0, 256, (len(LENGTHS), 65536), dtype=np.uint8)
    lens = np.asarray(LENGTHS, np.int32)
    want = XP.xxh32_blocks(bufs, lens).tolist()
    assert want == _natives(bufs, lens)
    before = X.xxh32_windows.launches
    got = X.xxh32_blocks_plain(torch.from_numpy(bufs), torch.from_numpy(lens))
    assert got.dtype == torch.int32 and X.as_uint32(got) == want
    assert torch.equal(X.xxh32_blocks(torch.from_numpy(bufs), lens), got)
    assert X.xxh32_windows.launches == before


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_length_batches_match_pallas_xxh32(seed, interpret):
    rng = np.random.default_rng(seed)
    nb, cap = 24, 4096
    bufs = rng.integers(0, 256, (nb, cap), dtype=np.uint8)
    lens = rng.integers(0, cap + 1, nb).astype(np.int32)
    lens[rng.integers(0, nb)] = cap  # one row the longest by far, or tied
    want = XP.xxh32_blocks(bufs, lens).tolist()
    assert X.as_uint32(X.xxh32_blocks_plain(torch.from_numpy(bufs), lens)) == want
    assert want == _natives(bufs, lens)


@pytest.mark.parametrize("n", LENGTHS + [300001])
def test_windows_at_every_alignment_match_native(n):
    """Windows of one flat tensor at starts 0-15 mod 16 and at random
    starts, overlapping each other."""
    rng = np.random.default_rng(n)
    flat = rng.integers(0, 256, 400000, dtype=np.uint8)
    starts = list(range(16)) + [int(a) for a in rng.integers(0, len(flat) - n, 4)]
    got = X.xxh32_windows_plain(torch.from_numpy(flat), starts, [n] * len(starts))
    assert X.as_uint32(got) == [native(flat[a:a + n].tobytes()) for a in starts]


def test_mixed_windows_match_native():
    """Windows of every length at once, in no order, one of them long: the
    numpy pass over all windows, then the longest alone in Python ints."""
    rng = np.random.default_rng(7)
    flat = rng.integers(0, 256, 300000, dtype=np.uint8)
    lens = [int(n) for n in rng.permutation(LENGTHS + [250000, 70000, 0])]
    starts = [int(rng.integers(0, len(flat) - n + 1)) for n in lens]
    got = X.xxh32_windows(torch.from_numpy(flat), starts, lens)
    assert X.as_uint32(got) == [native(flat[a:a + n].tobytes()) for a, n in zip(starts, lens)]
    assert X.xxh32_windows(torch.from_numpy(flat), [], []).shape == (0,)


U8 = torch.zeros((100,), dtype=torch.uint8)
ROWS = torch.zeros((2, 64), dtype=torch.uint8)
BAD_CALLS = {
    "window_past_the_end": (lambda f: f(U8, [90], [20]), "outside"),
    "negative_start": (lambda f: f(U8, [-1], [5]), "outside"),
    "negative_length": (lambda f: f(U8, [0], [-1]), ">= 0"),
    "not_uint8": (lambda f: f(U8.to(torch.int32), [0], [1]), "1-D uint8"),
    "not_1d": (lambda f: f(U8.view(10, 10), [0], [1]), "1-D uint8"),
    "ragged_args": (lambda f: f(U8, [0, 1], [1]), "one value per window"),
}
BAD_ROWS = {
    "length_above_cap": (lambda f: f(ROWS, [65, 0]), "CAP=64"),
    "negative_row_length": (lambda f: f(ROWS, [-1, 0]), "CAP=64"),
    "rows_not_uint8": (lambda f: f(ROWS.to(torch.int32), [1, 1]), "2-D uint8"),
    "rows_not_2d": (lambda f: f(U8, [1]), "2-D uint8"),
    "ragged_lens": (lambda f: f(ROWS, [1]), "one length per row"),
}


@pytest.mark.parametrize("plain", [False, True], ids=["wrapper", "plain"])
@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_window_validation_raises(case, plain):
    call, match = BAD_CALLS[case]
    with pytest.raises(ValueError, match=match):
        call(X.xxh32_windows_plain if plain else X.xxh32_windows)


@pytest.mark.parametrize("plain", [False, True], ids=["wrapper", "plain"])
@pytest.mark.parametrize("case", sorted(BAD_ROWS))
def test_row_validation_raises(case, plain):
    call, match = BAD_ROWS[case]
    with pytest.raises(ValueError, match=match):
        call(X.xxh32_blocks_plain if plain else X.xxh32_blocks)
