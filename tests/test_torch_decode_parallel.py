"""Kernel A's parallel parse, plain: every position parsed speculatively,
the sequences the orbit of position 0 (`decode.rows_passes` on the CPU),
held to the serial plain decoder (`_decode_row`) and to the JAX package's
`pallas_decode6` (interpret mode on the CPU): the same rows, made from a
seed, give the same sequence tables, lengths, error flags and bytes."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import liblz4
from lz4_tpu.ops import decode_pallas6 as D6
from lz4_tpu_torch.ops import decode as D
from lz4_tpu_torch.ops import decode_stream as DS
from lz4_tpu_torch.parallel.blocks import comp_capacity
from test_cross_backend_fuzz import _random_structured

import bench


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode, kept for the whole module so that each
    kernel shape traces once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
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


def _parallel(comps, clens, out_cap, dicts=None, dlens=None):
    t = [None if x is None else torch.from_numpy(x) for x in (comps, clens, dicts, dlens)]
    return D.rows_passes(t[0], t[1], out_cap, t[2], t[3])


def _assert_serial(p, comps, clens, out_cap, dicts=None, dlens=None):
    """The composed passes equal the serial plain decoder in every output."""
    t = [None if x is None else torch.from_numpy(x) for x in (comps, clens, dicts, dlens)]
    want = D.decode_blocks_plain(t[0], t[1], out_cap, t[2], t[3])
    for got, w in zip((p.out, p.lens, p.errs), want):
        assert torch.equal(got, w)


def _assert_pallas(p, theirs):
    """Lengths and flags exactly; bytes where a row decodes cleanly."""
    jo, jlens, jerrs = (np.asarray(t) for t in theirs)
    assert np.array_equal(p.lens.numpy(), jlens)
    assert np.array_equal(p.errs.numpy(), jerrs)
    for b in np.nonzero(jerrs == 0)[0]:
        assert np.array_equal(p.out[b, : jlens[b]].numpy(), jo[b, : jlens[b]]), b


def _corrupt(good: bytes):
    """Kernel A's corrupt kinds, from one valid row."""
    flipped = bytearray(good)
    flipped[0] ^= 0x80
    return {
        "flipped_token": bytes(flipped),
        "cut_row": good[: len(good) // 2],
        "offset_past_output_start": bytes([0x40]) + b"abcd" + (100).to_bytes(2, "little") + b"\x00",
        "trailing_bytes": good + b"xyz",
        "literal_run_ends_at_clen": b"\xf0" + b"\xff" * 20,
        "match_run_ends_at_clen": bytes([0x1F, 0x61, 1, 0]) + b"\xff" * 10,
        "match_before_any_output": bytes([0x00, 0x01, 0x00]),
        "empty": b"",
    }


def _rows_4k(rng):
    datas = [_random_structured(rng, rng.choice([100, 2000, 4000])) for _ in range(6)]
    datas += [(bytes([65 + (k % p) for k in range(p)]) * 4000)[:3900] for p in (1, 2, 7)]
    datas += [b"E" * 19 + rng.randbytes(1), rng.randbytes(4000), b"x"]
    streams = [liblz4.compress_block(d) for d in datas]
    streams += [liblz4.compress_block(d, level=9) for d in datas[:3]]
    return streams


@pytest.mark.parametrize("out_cap", [4096, 1000, 100])
def test_parallel_plain_matches_serial_and_pallas_4k(out_cap, interpret):
    streams = _rows_4k(random.Random(11)) + list(_corrupt(liblz4.compress_block(b"ab" * 900)).values())
    comps, clens = _stage(streams, comp_capacity(4096))
    p = _parallel(comps, clens, out_cap)
    _assert_serial(p, comps, clens, out_cap)
    _assert_pallas(p, D6.decode_blocks_pallas6(comps, clens, out_cap))


@pytest.mark.parametrize("kind", sorted(_corrupt(b"\x00").keys()))
def test_each_corrupt_kind_fails_as_the_serial_decoder_does(kind, interpret):
    n = 65536
    good = liblz4.compress_block(bench.make_corpus(n, seed=4))
    comps, clens = _stage([_corrupt(good)[kind], good], comp_capacity(n))
    p = _parallel(comps, clens, n)
    _assert_serial(p, comps, clens, n)
    _assert_pallas(p, D6.decode_blocks_pallas6(comps, clens, n))
    assert int(p.errs[1]) == 0 and int(p.lens[1]) == n
    if kind != "trailing_bytes":  # trailing bytes may parse as sequences
        assert int(p.errs[0]) == 1


def test_parallel_plain_matches_pallas_64k(interpret):
    n = 65536
    corpus = bench.make_corpus(16 * n, seed=3)
    datas = [corpus[k * n : (k + 1) * n] for k in (1, 6, 10, 15)]
    comps, clens = _stage([liblz4.compress_block(d) for d in datas], comp_capacity(n))
    p = _parallel(comps, clens, n)
    _assert_serial(p, comps, clens, n)
    _assert_pallas(p, D6.decode_blocks_pallas6(comps, clens, n))
    for i, d in enumerate(datas):
        assert p.out[i, : int(p.lens[i])].numpy().tobytes() == d


def test_parallel_plain_with_dictionaries(interpret):
    rng = random.Random(21)
    n = 4096
    streams, dicts_l = [], []
    for k in range(8):
        dct = _random_structured(rng, [0, 100, 4000, 65536, 70000][k % 5])
        start = rng.randrange(max(1, len(dct)))
        data = (dct[start : start + 1500] + _random_structured(rng, 1500))[:n]
        streams.append(liblz4.compress_block_with_dict(data, dct))
        dicts_l.append(dct[-65536:])
    streams.append(bytes([0x00, 0x05, 0x00]))  # reaches before a 4-byte dict
    dicts_l.append(b"wxyz")
    comps, clens = _stage(streams, comp_capacity(n))
    dicts = np.zeros((len(streams), 65536), np.uint8)
    dlens = np.zeros((len(streams),), np.int32)
    for i, d in enumerate(dicts_l):
        if d:
            dicts[i, 65536 - len(d):] = np.frombuffer(d, np.uint8)
        dlens[i] = len(d)
    p = _parallel(comps, clens, n, dicts, dlens)
    _assert_serial(p, comps, clens, n, dicts, dlens)
    _assert_pallas(p, D6.decode_blocks_pallas6(comps, clens, n, dicts, dlens))
    assert p.errs.tolist() == [0] * 8 + [1]


def test_sequence_table_is_the_serial_walk():
    """Each clean row's table (the orbit of position 0) holds the
    sequences the serial walk finds, in order, with their output
    positions; the per-segment hops enter each segment where the orbit
    does."""
    n = 65536
    corpus = bench.make_corpus(4 * n, seed=8)
    streams = [liblz4.compress_block(corpus[k * n : (k + 1) * n]) for k in range(4)]
    comps, clens = _stage(streams, comp_capacity(n))
    p = _parallel(comps, clens, n)
    lay = p.layout
    for b, c in enumerate(streams):
        rows = []
        DS._parse_block(c, len(c), n, rows)
        want = np.asarray(rows, np.int32).reshape(-1, 5)
        s0 = int(lay.sbase[b])
        assert int(p.nseq[b]) == want.shape[0]
        assert np.array_equal(p.seqs[s0 : s0 + want.shape[0]].numpy(), want)
        # segment entries are positions of the orbit inside their segment
        g0 = int(lay.gbase[b])
        entries = p.entry[g0 : g0 + (len(c) + D.SEG) // D.SEG].tolist()
        assert entries[0] == 0
        assert all(e < 0 or e // D.SEG == k for k, e in enumerate(entries))


def test_literal_runs_longer_than_a_segment_skip_segments():
    """A row of incompressible bytes is one literal run: its orbit skips
    every segment after the first (entry -1) and still decodes."""
    rng = random.Random(5)
    data = rng.randbytes(20000)
    streams = [liblz4.compress_block(data), liblz4.compress_block(data + b"z" * 500)]
    comps, clens = _stage(streams, comp_capacity(21000))
    p = _parallel(comps, clens, 21000)
    _assert_serial(p, comps, clens, 21000)
    g0 = int(p.layout.gbase[0])
    assert p.entry[g0 : g0 + 5].tolist() == [0, -1, -1, -1, -1]
    assert p.out[0, :20000].numpy().tobytes() == data


@pytest.mark.parametrize("span", [1, 2, 40])
def test_spans_are_the_first_orbit_position_past_the_segment(span):
    """Pass 2 by its definition: from every position, follow the
    speculative successors until a position at or past the segment's end;
    the count and the bytes along the way."""
    c = liblz4.compress_block(bench.make_corpus(9000, seed=span))
    comps, clens = _stage([c], comp_capacity(9000))
    nn = D.rows_nn_plain(torch.from_numpy(comps), torch.from_numpy(clens))
    exits, counts, sums = D.rows_spans_plain(torch.from_numpy(comps), torch.from_numpy(clens), nn)
    row = D._row_bytes(comps, 0, len(c))
    kind, _, ll, _, ml, nxt = D._speculate(row, len(c), nn.numpy().astype(np.int64))
    for q in range(0, len(c) + 1, span):
        end = min((q // D.SEG + 1) * D.SEG, len(c) + 1)
        e, k, total = q, 0, 0
        while e < end:
            k += 1
            total += 0 if kind[e] == 2 else int(ll[e] + ml[e])
            e = int(nxt[e])
        assert (int(exits[q]), int(counts[q]), int(sums[q])) == (e, k, min(total, D.END))


def test_nn_is_the_next_byte_that_is_not_255():
    c = bytes([0xF0, 255, 255, 3]) + b"a" * 48 + bytes([255] * 40) + b"\x00"
    comps, clens = _stage([c, b""], 200)
    nn = D.rows_nn_plain(torch.from_numpy(comps), torch.from_numpy(clens)).tolist()
    want = [q if q == len(c) or c[q] != 255 else next(
        (p for p in range(q, len(c)) if c[p] != 255), len(c)) for q in range(len(c) + 1)]
    assert nn == want + [0]


def test_both_routes_run_the_plain_version_on_the_cpu():
    """Both routes (the ones `decode_blocks` picks between by out_cap on the
    card) run the serial plain version for CPU tensors and count no
    launch."""
    c = liblz4.compress_block(bench.make_corpus(5000, seed=1))
    comps, clens = _stage([c, c[:100]], comp_capacity(5000))
    t = torch.from_numpy(comps), torch.from_numpy(clens)
    counts = D.decode_blocks.launches, dict(D.kernel_launches)
    want = D.decode_blocks_plain(*t, 5000)
    for route in (None, "rows", "warp"):
        got, launched = D._decode(route, *t, 5000)
        assert not launched
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for g, w in zip(D.decode_blocks(*t, 5000), want):
        assert torch.equal(g, w)
    assert counts == (D.decode_blocks.launches, D.kernel_launches)


@pytest.mark.parametrize("budget", [1, 200_000, 1 << 31])
def test_row_groups_keep_each_group_under_the_budget(budget, monkeypatch):
    """`row_groups` cuts the rows into consecutive ranges whose scratch
    (`SCRATCH_BYTES` per part of `rows_layout`) fits the budget, a row
    larger than it alone in its group, and covers every row once."""
    monkeypatch.setattr(D, "GROUP_SCRATCH_BYTES", budget)
    rng = np.random.default_rng(budget)
    clens = torch.from_numpy(rng.integers(-3, 9000, 40).astype(np.int32))
    out_cap = 1 << 20
    need = sum(w * x for w, x in zip(D.SCRATCH_BYTES, D._row_parts(clens, out_cap)))
    groups = D.row_groups(clens, out_cap)
    assert groups[0][0] == 0 and groups[-1][1] == 40
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    for g0, g1 in groups:
        size = int(need[g0:g1].sum())
        assert size <= budget or g1 - g0 == 1
        if g1 < 40:  # the next row would not have fitted
            assert size + int(need[g1]) > budget
    if budget >= int(need.sum()):
        assert groups == [(0, 40)]
    # the layout of one group is a layout of its own rows
    lay = D.rows_layout(clens, out_cap)
    assert lay.positions * 16 + lay.segments * 12 + lay.rows * 20 + lay.slots * 4 == int(
        need.sum())


def test_jump_plain_is_the_fixed_point_of_one_hop():
    """`jump_plain` (the resolve pass of both parallel decoders): every
    entry ends on a prefix position or on one that points to itself, as a
    hop-by-hop walk does."""
    rng = np.random.default_rng(5)
    prefix, n = 16, 300
    ptr = np.arange(prefix, prefix + n)
    pick = rng.random(n) < 0.7
    # each entry points back (into the prefix too), never to itself or on
    ptr[pick] = [rng.integers(0, prefix + i) for i in np.flatnonzero(pick)]
    got = D.jump_plain(torch.from_numpy(ptr), prefix).tolist()
    for i in range(n):
        v = int(ptr[i])
        while v >= prefix and ptr[v - prefix] != v:
            v = int(ptr[v - prefix])
        assert got[i] == v
