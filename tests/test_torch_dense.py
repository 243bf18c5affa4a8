"""The port's dense codecs against the JAX package's XLA kernels on the CPU:
X3 (`ops.chain.materialize_chain`), X2 (`ops.decode_dense`) and X1
(`ops.encode_dense`) take the same numpy bytes, made from a seed, and give
the same out bytes, lengths and error counts, at levels 0, 3, 9 and 12
(depths 1, 2, 16, 16), with dictionaries and on corrupt, cut and
zero-offset blocks; `block.decode` without a bound equals the JAX
package's device route, the three output caps included.  Rows are kept to
4,096 bytes and one 64 KB shape, so that JAX compiles few shapes."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from lz4_tpu.block import api as jblock
from lz4_tpu.block import hostref
from lz4_tpu.ops import chain as JC
from lz4_tpu.ops import decode_jax as JD
from lz4_tpu.ops import encode_jax as JE
from lz4_tpu.parallel import blocks as JB
from lz4_tpu_torch.block import LZ4Error
from lz4_tpu_torch.block import api as tblock
from lz4_tpu_torch.ops import chain as TC
from lz4_tpu_torch.ops import decode_dense as TD
from lz4_tpu_torch.ops import encode_dense as TE
from lz4_tpu_torch.parallel import blocks as TB

CORPUS = bench.make_corpus(1 << 19, 11)
BCAP = 4096
LEVELS = [0, 3, 9, 12]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The dense codecs are many small tensor ops: each runs on one thread,
    so that the test workers sharing the machine's cores do not stall on
    one another's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(seed: int):
    """Rows of the bench mix (one from each quarter: text, records, runs,
    noise) and short rows, staged as the batched encoders take them."""
    rng = np.random.default_rng(seed)
    quarter = len(CORPUS) // 4
    lens = [BCAP, 3001, BCAP, 2500, 0, 1, 13, 12]
    bufs = np.zeros((len(lens), BCAP + TE._PAD_TAIL), np.uint8)
    for i, n in enumerate(lens):
        at = (i % 4) * quarter + int(rng.integers(0, quarter - BCAP))
        bufs[i, :n] = np.frombuffer(CORPUS[at:at + n], np.uint8)
    return bufs, np.asarray(lens, np.int32)


def _same(theirs, ours):
    for t, o in zip(theirs, ours):
        assert np.array_equal(np.asarray(t), o.numpy())


def _jax_encode(bufs, lens, depth):
    return JB.batched_encode(jnp.asarray(bufs), jnp.asarray(lens), BCAP, depth)


def _jax_decode(comps, clens, out_cap):
    return JB.batched_decode(jnp.asarray(comps), jnp.asarray(clens), out_cap)


def _stage(streams, width):
    comps = np.zeros((len(streams), width), np.uint8)
    for i, c in enumerate(streams):
        comps[i, :len(c)] = np.frombuffer(c, np.uint8)
    return comps, np.asarray([len(c) for c in streams], np.int32)


@pytest.mark.parametrize("m,steps,jump", [(2, 1, 1), (37, 13, 3), (1000, 400, 9),
                                          (5000, 2000, 40), (4096, 4096, 1)])
def test_materialize_chain_matches(m, steps, jump):
    rng = np.random.default_rng(m + jump)
    rows = []
    for _ in range(3):
        nxt = np.minimum(np.arange(m) + rng.integers(1, jump + 1, m), m - 1)
        nxt[m - 1] = m - 1
        rows.append(nxt.astype(np.int32))
    ours = TC.materialize_chain(torch.from_numpy(np.stack(rows)), steps)
    for r, nxt in enumerate(rows):
        theirs = np.asarray(JC.materialize_chain(jnp.asarray(nxt), steps))
        assert np.array_equal(theirs, ours[r].numpy())


@pytest.mark.parametrize("level", LEVELS)
def test_batched_encode_and_decode_match(level):
    bufs, lens = _rows(level)
    depth = JE.level_to_depth(level)
    theirs = _jax_encode(bufs, lens, depth)
    ours = TB.batched_encode(torch.from_numpy(bufs), torch.from_numpy(lens), BCAP, depth)
    _same(theirs, ours)
    out, olens = ours
    streams = [out[i, :int(olens[i])].numpy().tobytes() for i in range(len(lens))]
    comps, clens = _stage(streams, TB.comp_capacity(BCAP))
    theirs = _jax_decode(comps, clens, BCAP)
    ours = TB.batched_decode(torch.from_numpy(comps), torch.from_numpy(clens), BCAP)
    _same(theirs, ours)
    assert not ours[2].any()
    for i, n in enumerate(lens):
        assert ours[0][i, :n].numpy().tobytes() == bufs[i, :n].tobytes()


def _corrupt_streams():
    """Flipped bits, cut streams, zero offsets, offsets past the output's
    start, runaway length extensions, noise and an empty row."""
    rng = random.Random(5)
    good = [hostref.encode_fast(CORPUS[a:a + 3000]) for a in (0, 140000, 270000, 400000)]
    out = []
    for i in range(24):
        c = bytearray(good[i % 4])
        for _ in range(rng.randrange(1, 4)):
            c[rng.randrange(len(c))] ^= 1 << rng.randrange(8)
        out.append(bytes(c))
    out += [g[:rng.randrange(1, len(g))] for g in good]
    out += [
        b"\x10a\x00\x00\x00",  # a zero offset
        b"\x10a\x05\x00\x00",  # an offset past the output's start
        b"\xff" * 40,  # a runaway literal length
        b"\x0f\x00\x00" + b"\xff" * 30,  # a runaway match length
        b"\x40abcd\x02\x00" + b"\x00" * 3,  # no last literals
        b"",
    ]
    out += [rng.randbytes(rng.randrange(1, 400)) for _ in range(8)]
    return out


def test_corrupt_rows_give_the_same_errors():
    comps, clens = _stage(_corrupt_streams(), TB.comp_capacity(BCAP))
    theirs = _jax_decode(comps, clens, BCAP)
    ours = TB.batched_decode(torch.from_numpy(comps), torch.from_numpy(clens), BCAP)
    _same(theirs, ours)
    errs = ours[2].numpy()
    assert (errs != 0).sum() >= 20 and len(set(errs.tolist())) > 5


@pytest.mark.parametrize("level", [0, 3, 12])
@pytest.mark.parametrize("dict_len", [3000, 70000])
def test_dictionaries_match(level, dict_len):
    at = 200000
    src, d = CORPUS[at:at + 4000], CORPUS[at - dict_len:at]
    comp = TE.encode_block_bytes(src, level, d, device="cpu")
    assert comp == JE.encode_block_bytes(src, level, d)
    assert TD.decode_block_bytes(comp, len(src), d, device="cpu") == src
    assert JD.decode_block_bytes(comp, len(src), d) == src
    # the window reached through the dictionary, then past it
    dcap, dlen = 65536, min(dict_len, 65536)
    comps, clens = _stage([comp, comp, comp[:-7]], 8192)
    dicts = np.zeros((3, dcap), np.uint8)
    dicts[:, dcap - dlen:] = np.frombuffer(d[-dlen:], np.uint8)
    dlens = np.asarray([dlen, 100, dlen], np.int32)
    ours = TD.decode_block_fixed(torch.from_numpy(comps), torch.from_numpy(clens),
                                 torch.from_numpy(dicts), torch.from_numpy(dlens), 4096)
    for r in range(3):
        theirs = JD.decode_block_fixed(
            jnp.asarray(comps[r]), jnp.int32(clens[r]), jnp.asarray(dicts[r]),
            jnp.int32(dlens[r]), 4096)
        _same(theirs, [t[r] for t in ours])
    assert ours[2][0] == 0 and ours[2][1] > 0 and ours[2][2] > 0


def _needs_cap(k: int) -> bytes:
    """A block that decodes only at its k-th unbounded output cap (of 4, 32
    and 255 times its length)."""
    rng = random.Random(k)
    noise = rng.randbytes(1900)
    raw = noise + bytes((0, 30000, 300000)[k])
    return raw


@pytest.mark.parametrize("k", [0, 1, 2])
def test_unbounded_decode_tries_each_cap(k):
    raw = _needs_cap(k)
    comp = hostref.encode_fast(raw)
    caps = sorted({JD._bucket(max(64, len(comp) * f)) for f in (4, 32, 255)})
    assert len(caps) == 3 and (k == 0 or caps[k - 1] < len(raw) <= caps[k])
    assert TD.decode_block_bytes(comp, device="cpu") == raw
    assert tblock.decode(comp, device="cpu") == jblock.decode(comp, backend="tpu") == raw


def test_unbounded_decode_errors_match():
    comp = hostref.encode_fast(CORPUS[:3000])
    for bad in (comp[:-9], b"\x10a\x00\x00\x00", b"", b"\xff" * 40):
        with pytest.raises(ValueError) as theirs:
            jblock.decode(bad, backend="tpu")
        with pytest.raises(LZ4Error) as ours:
            tblock.decode(bad, device="cpu")
        assert str(ours.value) == str(theirs.value)
    d = CORPUS[:5000]
    comp = JE.encode_block_bytes(CORPUS[5000:9000], 0, d)
    assert tblock.decode(comp, dictionary=d, device="cpu") == \
        jblock.decode(comp, dictionary=d, backend="tpu")


def test_64k_rows_match():
    n = 65536
    bufs = np.zeros((2, n + TE._PAD_TAIL), np.uint8)
    bufs[0, :n] = np.frombuffer(CORPUS[:n], np.uint8)
    bufs[1, :n - 5] = np.frombuffer(CORPUS[300000:300000 + n - 5], np.uint8)
    lens = np.asarray([n, n - 5], np.int32)
    theirs = JB.batched_encode(jnp.asarray(bufs), jnp.asarray(lens), n, 1)
    ours = TB.batched_encode(torch.from_numpy(bufs), torch.from_numpy(lens), n, 1)
    _same(theirs, ours)
    streams = [ours[0][i, :int(ours[1][i])].numpy().tobytes() for i in range(2)]
    comps, clens = _stage(streams, TB.comp_capacity(n))
    theirs = _jax_decode(comps, clens, n)
    ours = TB.decode_chunked(comps, clens, n, device="cpu")
    _same(theirs, ours)
    assert ours[0][1, :n - 5].numpy().tobytes() == CORPUS[300000:300000 + n - 5]


def test_row_groups_match_one_group(monkeypatch):
    bufs, lens = _rows(3)
    whole = TB.encode_chunked(bufs, lens, BCAP, 2, device="cpu")
    monkeypatch.setattr(TB, "DENSE_GROUP_BYTES", 1)  # one row a group
    launches = TE.encode_block_fixed.launches
    _same([t.numpy() for t in whole], TB.encode_chunked(bufs, lens, BCAP, 2, device="cpu"))
    assert TE.encode_block_fixed.launches == launches + len(lens)
