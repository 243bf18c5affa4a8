"""The archived TPU decoders' cases run through the port's kernel A.

`experiments/tests/test_pallas_decode.py` (v1), `test_pallas_decode5.py`
(v5) and `test_pallas_decode7.py` (v7, v9, v10) held their kernels to
`lz4_tpu.block.hostref` and `lz4_tpu.native`; here the same inputs, from the
same seeds (`random.Random(1234)`), go through `lz4_tpu_torch.ops.decode.
decode_blocks` (its plain version on the CPU) with the same assertions.
Where an archived test held its kernel to `pallas_decode6` (v7, v9, v10),
the port is held to `lz4_tpu.ops.decode_pallas6` in interpret mode on the
same rows.  The archived kernels themselves are not run."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lz4_tpu import native
from lz4_tpu.block import hostref
from lz4_tpu.ops import decode_pallas6 as D6
from lz4_tpu_torch.ops import decode as A
from lz4_tpu_torch.parallel.blocks import comp_capacity

pytestmark = pytest.mark.skipif(not native.available(), reason="native engine unavailable")

N = 4096


@pytest.fixture
def rng():
    return random.Random(1234)


@pytest.fixture(scope="module")
def interpret():
    """`pallas_decode6` in interpret mode for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        D6.pallas_decode6.clear_cache()
        yield
        D6.pallas_decode6.clear_cache()


def _rows(blobs, cap):
    comps = np.zeros((len(blobs), cap), np.uint8)
    clens = np.zeros((len(blobs),), np.int32)
    for i, c in enumerate(blobs):
        comps[i, :len(c)] = np.frombuffer(c, np.uint8)
        clens[i] = len(c)
    return comps, clens


def _port(comps, clens, out_cap=N, dicts=None, dict_lens=None):
    """Kernel A's plain route on the rows: numpy (out, lens, errs)."""
    got = A.decode_blocks(
        torch.from_numpy(comps), torch.from_numpy(clens), out_cap,
        None if dicts is None else torch.from_numpy(dicts),
        None if dict_lens is None else torch.from_numpy(dict_lens))
    return tuple(t.numpy() for t in got)


def _decode(blobs, out_cap=N, cap=None):
    return _port(*_rows(blobs, cap or comp_capacity(out_cap)), out_cap)


def _native_rows(cases, level=0):
    return _rows([native.encode(d, level) for d in cases], comp_capacity(N))


def _assert_decodes(cases, out, lens, errs):
    for i, d in enumerate(cases):
        assert errs[i] == 0, i
        assert lens[i] == len(d), i
        assert out[i, :lens[i]].tobytes() == d, i


# ---- test_pallas_decode.py (v1) -------------------------------------------

def test_v1_roundtrip_shapes(rng):
    cases = [
        b"hello world hello world hello!",
        bytes(2000),
        rng.randbytes(1500),
        (b"abcdefg" * 400)[:2800],
        b"a" * 4000,
        (b" ".join([b"lorem", b"ipsum", b"dolor"] * 300))[:4000],
        b"x",
        b"ab" * 1000,
    ]
    blobs = [hostref.encode_fast(d) for d in cases]
    _assert_decodes(cases, *_decode(blobs, 4096, 8192))


def test_v1_hc_streams():
    data = (b"the quick brown fox jumps over the lazy dog " * 60)[:2500]
    out, lens, errs = _decode([hostref.encode_hc(data, level=9)], 4096, 8192)
    assert errs[0] == 0 and out[0, :len(data)].tobytes() == data


@pytest.mark.parametrize("blob", [
    b"\x10a\x00\x00\x00",  # offset 0
    b"\xf0abc",  # a literal run cut short
    b"\x40abcd\xff\xff\x10a",  # an offset past the window
], ids=["offset_0", "truncated_literals", "offset_past_window"])
def test_v1_malformed_flags(blob):
    _, _, errs = _decode([blob], 4096, 8192)
    assert errs[0] != 0


# ---- test_pallas_decode5.py (v5) ------------------------------------------

def test_v5_roundtrip_shapes(rng):
    cases = [
        b"hello world hello world hello!" * 10,
        bytes(3000),
        rng.randbytes(1500),
        b"x",
        rng.randbytes(4000),
        bytes(range(256)) * 15,
        (b" ".join([b"lorem", b"ipsum", b"dolor"] * 300))[:4000],
    ]
    _assert_decodes(cases, *_port(*_native_rows(cases)))


def test_v5_small_period_matches():
    """Every offset below 18, each match far longer than its offset."""
    cases = [
        (bytes([65 + (k % p) for k in range(p)]) * 4000)[:3900] for p in range(1, 8)
    ] + [
        (bytes([65 + (k % p) for k in range(p)]) * 800)[:3900] for p in range(8, 18)
    ]
    _assert_decodes(cases, *_port(*_native_rows(cases)))


def test_v5_hc_and_opt_streams(rng):
    data = (
        b" ".join(rng.choice([b"aa", b"bbb", b"cccc"]) for _ in range(800))
        + rng.randbytes(500)
    )[:3500]
    for level in (9, 12):
        out, lens, errs = _port(*_native_rows([data], level))
        assert errs[0] == 0 and out[0, :lens[0]].tobytes() == data, level


def test_v5_malformed_inputs_flagged():
    bad = np.zeros((3, comp_capacity(N)), np.uint8)
    bad[0, 0] = 0xFF
    bad[0, 1:20] = 255  # a literal length's run of 255s
    bad[1, 0] = 0x04
    bad[1, 1] = ord("q")
    bad[1, 2] = 0xFF
    bad[1, 3] = 0xFF  # an offset far past the window
    bad[2, 0] = 0x1F  # a match length's run off the end
    bad[2, 1] = ord("z")
    bad[2, 2] = 0x01
    bad[2, 3] = 0x00
    bad[2, 4] = 255
    _, _, errs = _port(bad, np.asarray([20, 5, 5], np.int32))
    assert all(e != 0 for e in errs), errs.tolist()


def test_v5_dictionary_mode(rng):
    dict_bytes = rng.randbytes(300) * 4
    data = dict_bytes[-200:] + b"XYZ" + dict_bytes[-700:-300]
    c = native.encode(data, 0, dictionary=dict_bytes)
    comps, clens = _rows([c], comp_capacity(N))
    dicts = np.zeros((1, 65536), np.uint8)
    dw = dict_bytes[-65536:]
    dicts[0, 65536 - len(dw):] = np.frombuffer(dw, np.uint8)
    out, lens, errs = _port(comps, clens, N, dicts, np.asarray([len(dw)], np.int32))
    assert errs[0] == 0
    assert out[0, :lens[0]].tobytes() == data


def test_v5_cross_check_vs_oracle_fuzz(rng):
    cases = []
    for t in range(8):
        kind = t % 4
        if kind == 0:
            cases.append(rng.randbytes(rng.randint(1, 3000)))
        elif kind == 1:
            pat = rng.randbytes(rng.randint(1, 30))
            cases.append((pat * 4000)[:rng.randint(100, 3900)])
        elif kind == 2:
            cases.append(bytes(rng.randint(1, 3900)))
        else:
            words = [rng.randbytes(rng.randint(2, 9)) for _ in range(25)]
            cases.append(b"".join(rng.choice(words) for _ in range(500))[:3900])
    _assert_decodes(cases, *_port(*_native_rows(cases)))


# ---- test_pallas_decode7.py (v7, v9, v10) ---------------------------------

def _cases(rng):
    return [
        b"hello world hello world hello!" * 10,
        bytes(3000),
        rng.randbytes(1500),
        b"x",
        rng.randbytes(4000),
        bytes(range(256)) * 15,
        (b" ".join([b"lorem", b"ipsum", b"dolor"] * 300))[:4000],
        (b"ab" * 2000)[:3999],
        (b"abcdefg" * 600)[:4000],
        (b"abcdefgh" * 500)[:4000],
        b"",
    ]


BAD = bytes([0x00, 0x10, 0x00]) + bytes(20)  # an offset before the block's start


@pytest.mark.parametrize("count", [10, 7], ids=["pairs", "odd_batch"])
def test_v7_roundtrips(rng, count):
    cases = _cases(rng)[:count]
    _assert_decodes(cases, *_port(*_native_rows(cases)))


def test_v7_hc_and_opt_streams(rng):
    words = [rng.randbytes(rng.randint(3, 8)) for _ in range(30)]
    data = b" ".join(rng.choice(words) for _ in range(1500))[:N]
    for level in (9, 12):
        cases = [data, data[:N // 2]]
        _assert_decodes(cases, *_port(*_native_rows(cases, level)))


@pytest.mark.parametrize("level", [0, 9], ids=["v7", "v9"])
def test_v7_v9_malformed_block_beside_a_good_one(rng, level):
    """The corrupt row errs; its neighbour still decodes (v7: the
    alpha/beta/gamma row at level 0; v9: the HC row)."""
    if level == 0:
        good = (b" ".join([b"alpha", b"beta", b"gamma"] * 200))[:3000]
    else:
        words = [rng.randbytes(rng.randint(3, 8)) for _ in range(30)]
        good = b" ".join(rng.choice(words) for _ in range(1500))[:N]
    comps, clens = _rows([BAD, native.encode(good, level)], comp_capacity(N))
    out, lens, errs = _port(comps, clens)
    assert errs[0] != 0 and errs[1] == 0
    assert out[1, :lens[1]].tobytes() == good


@pytest.mark.parametrize("count", [8, 11], ids=["v7_mixed_batch", "v9_v10_odd_batch"])
def test_v7_v9_v10_match_pallas_decode6(rng, interpret, count):
    """Where the archived v7 (8 rows), v9 and v10 (11 rows, an odd batch)
    were held to v6, the port is held to v6: lengths, flags and bytes."""
    comps, clens = _native_rows(_cases(rng)[:count])
    out, lens, errs = _port(comps, clens)
    o6, l6, e6 = (np.asarray(x) for x in D6.decode_blocks_pallas6(comps, clens, N))
    assert (lens == l6).all() and (errs == e6).all()
    for i in range(count):
        assert out[i, :lens[i]].tobytes() == o6[i, :l6[i]].tobytes(), i


def test_v10_malformed_pair_matches_pallas_decode6(rng, interpret):
    good = _cases(rng)[6]
    comps, clens = _rows([BAD, native.encode(good, 0)], comp_capacity(N))
    out, lens, errs = _port(comps, clens)
    assert errs[0] != 0 and errs[1] == 0
    assert out[1, :lens[1]].tobytes() == good
    o6, l6, e6 = (np.asarray(x) for x in D6.decode_blocks_pallas6(comps, clens, N))
    assert (errs == e6).all() and (lens == l6).all()
