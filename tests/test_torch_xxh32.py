"""Kernel E's plain versions (`lz4_tpu_torch.ops.xxh32`) against the JAX
package's `pallas_xxh32` in interpret mode and its native xxHash32: the
same hashes, bit for bit, on rows, on windows at every alignment of one
flat tensor and on batches of random lengths; and the wrappers' checks."""

import functools
import importlib
import zlib

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


# XXH32 with its state in tensors: a tensor update keeps the accumulators
# and the bytes after the last whole stripe as tensors on the tensor's
# device (`ops.xxh32.stripes_update`; here its plain version); a bytes
# update or the digest reads them back.
SPLITS = [0, 1, 15, 16, 17, 4097, "random1", "random2", "random3"]
MIXES = ["tensors", "bytes_first", "alternating"]


def _pieces(split, total: int) -> list[int]:
    """Update sizes adding up to ``total``: ``split`` and 13 in turn (0:
    empty updates between 13-byte ones), or random sizes from a seed."""
    if isinstance(split, str):
        rng = np.random.default_rng(int(split[-1]))
        sizes = [int(n) for n in rng.integers(0, 5000, 64)]
    else:
        sizes = [split, 13]
    out, k = [], 0
    while sum(out) < total:
        out.append(min(sizes[k % len(sizes)], total - sum(out)))
        k += 1
    return out


@pytest.mark.parametrize("seed", [0, 0x9E3779B1], ids=["seed0", "seed_p1"])
@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("split", SPLITS)
def test_xxh32_stream_with_its_state_in_tensors_matches_the_jax_package(split, mix, seed):
    from lz4_tpu.xxh32 import XXH32 as JaxXXH32
    H = importlib.import_module("lz4_tpu_torch.xxh32")

    rng = np.random.default_rng(zlib.crc32(f"{split} {mix}".encode()))
    total = 20000 if isinstance(split, str) or split > 1 else 3000
    raw = rng.integers(0, 256, total, dtype=np.uint8)
    ours, theirs = H.XXH32(seed), JaxXXH32(seed)
    pos = 0
    host_before = H.host_stripes.launches
    for k, n in enumerate(_pieces(split, total)):
        piece = raw[pos:pos + n]
        as_bytes = (mix == "bytes_first" and k == 0) or (mix == "alternating" and k % 3 == 2)
        ours.update(piece.tobytes() if as_bytes else torch.from_numpy(piece.copy()))
        theirs.update(piece.tobytes())
        if not as_bytes:
            assert not isinstance(ours._acc, list) and ours._buf.numel() < 16
        pos += n
    assert ours.digest() == theirs.digest() == native(raw.tobytes(), seed)
    if mix == "tensors":
        assert H.host_stripes.launches == host_before  # no stripe ran on the host
    ours.update(raw[:21].tobytes())  # a bytes update after the digest's read
    theirs.update(raw[:21].tobytes())
    assert ours.digest() == theirs.digest()


def test_xxh32_tensor_state_follows_reset():
    from lz4_tpu.xxh32 import XXH32 as JaxXXH32
    H = importlib.import_module("lz4_tpu_torch.xxh32")

    raw = np.random.default_rng(5).integers(0, 256, 1000, dtype=np.uint8)
    h = H.XXH32(7)
    h.update(torch.from_numpy(raw))
    h.reset(11)
    assert isinstance(h._acc, list)
    h.update(torch.from_numpy(raw[:99]))
    want = JaxXXH32(11)
    want.update(raw[:99].tobytes())
    assert h.digest() == want.digest()


@pytest.mark.parametrize("tail_len", [0, 1, 9, 15])
@pytest.mark.parametrize("start", [0, 1, 7, 15])
def test_stripes_update_matches_the_plain_stripes(start, tail_len):
    """`stripes_update` on CPU tensors (its plain route) from random
    accumulators, after a carried tail, over a window at an odd start: the
    accumulators of the plain stripes over tail | window, and the bytes
    after its last whole stripe as the new tail."""
    rng = np.random.default_rng(start * 16 + tail_len)
    raw = rng.integers(0, 256, 5000, dtype=np.uint8)
    tail = rng.integers(0, 256, tail_len, dtype=np.uint8)
    accs = [int(x) for x in rng.integers(0, 1 << 32, 4, dtype=np.uint64)]
    n = 4097 - start
    state, carried = X.stripes_state(accs, tail.tobytes(), "cpu")
    state, carried = X.stripes_update(state, carried, torch.from_numpy(raw)[start:start + n])
    data = torch.from_numpy(np.concatenate([tail, raw[start:start + n]]))
    want = X.xxh32_stripes_plain(data, 0, data.numel(), accs)
    assert X.stripes_read(state, carried) == (
        X.as_uint32(want), data[data.numel() // 16 * 16:].numpy().tobytes())
    assert X.stripes_update.launches == 0


BAD_UPDATES = {
    "flat_2d": (lambda a, t, f: (a, t, f.reshape(2, -1)), "flat"),
    "flat_int32": (lambda a, t, f: (a, t, f.to(torch.int32)), "flat"),
    "three_accs": (lambda a, t, f: (a[:3], t, f), "four"),
    "accs_int64": (lambda a, t, f: (a.to(torch.int64), t, f), "four"),
    "tail_of_16": (lambda a, t, f: (a, f[:16], f), "fewer than 16"),
    "tail_int32": (lambda a, t, f: (a, t.to(torch.int32), f), "tail"),
}


@pytest.mark.parametrize("case", sorted(BAD_UPDATES))
def test_stripes_update_checks_its_arguments(case):
    bend, match = BAD_UPDATES[case]
    accs, tail = X.stripes_state(list(X._SEEDED), b"abc", "cpu")
    flat = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        X.stripes_update(*bend(accs, tail, flat))
