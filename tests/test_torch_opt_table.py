"""Level 12 as three passes (`lz4_tpu_torch/ops/encode_opt.py`): the plain
versions of `opt_chain`, `opt_matches` and `opt_parse` composed give
exactly the bytes of the serial plain parse (`encode_hc.encode_opt`), of
the JAX package's `pallas_encode5` in interpret mode and of its host
route; the table pass alone equals a `ChainFinder` walked in position
order.  Rows are kept small: the plain match pass is a Python search at
every position."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bench
import chip_smoke
from lz4_tpu import frame as jframe
from lz4_tpu.block import api as jblock
from lz4_tpu.ops import encode_pallas5 as E5
from lz4_tpu_torch import block as tblock
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.ops import encode_opt as EO
from lz4_tpu_torch.ops import encode_stream as ES
from lz4_tpu_torch.ops.encode_hc import ChainFinder, _hash
from lz4_tpu_torch.ops.common import read32
from test_pallas_encode5 import _cases

CORPUS = bench.make_corpus(1 << 20, seed=11)
N = 4096


def _flat(rows):
    """Rows as windows of one flat tensor without prefixes."""
    base = torch.frombuffer(bytearray(b"".join(rows) or b"\0"), dtype=torch.uint8)
    lens = [len(r) for r in rows]
    starts = np.cumsum([0] + lens[:-1]).tolist()
    return base, starts, [0] * len(rows), lens


def _bytes(res):
    out, clens, errs = res
    assert not errs.any()
    return [out[i, :int(clens[i])].numpy().tobytes() for i in range(clens.numel())]


def _hold(base, starts, src_offs, lens, bcap):
    """The plain passes composed against the serial plain parse."""
    ours = EO.encode_windows_opt_passes(base, starts, src_offs, lens, bcap, 12)
    theirs = ES.encode_windows_plain(base, starts, src_offs, lens, bcap, 12)
    assert _bytes(ours) == _bytes(theirs)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    return ours


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


def test_passes_match_pallas(interpret):
    """The 4 KB rows of the HC/OPT tests (`tests/test_torch_hc.py`), through
    `pallas_encode5` at level 12 in interpret mode."""
    rng = random.Random(1234)
    rows = _cases(rng) + [
        (b"abcabcabcabd" * 300)[:3500],
        rng.randbytes(64) * 60,
        b"".join(rng.choice([b"the ", b"quick ", b"brown ", b"fox "])
                 for _ in range(800))[:3500],
        b"", b"q" * 12, b"abcdefghijklm",
    ]
    bufs = np.zeros((len(rows), N + 1024), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, d in enumerate(rows):
        bufs[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    jout, jclens, jerrs = (np.asarray(t) for t in E5.encode_blocks_pallas5(bufs, lens, N, 12))
    flat = torch.from_numpy(bufs).reshape(-1)
    starts = [i * bufs.shape[1] for i in range(len(rows))]
    out, clens, errs = EO.encode_windows_opt_passes(flat, starts, [0] * len(rows), lens.tolist(), N)
    assert np.array_equal(clens.numpy(), jclens) and np.array_equal(errs.numpy(), jerrs)
    for i in range(len(rows)):
        assert np.array_equal(out[i, :clens[i]].numpy(), jout[i, :jclens[i]]), i


@pytest.fixture
def passes_on_the_cpu_route(monkeypatch):
    """The CPU route of `encode_stream.encode_windows` at level 12 through
    the three plain passes instead of the serial plain parse; yields the
    number of batches it took."""
    serial = ES.encode_windows_plain
    taken = []

    def route(base, st, so, ln, bcap, level=0, *args):
        if level >= 12:
            taken.append(len(ln))
            return EO.encode_windows_opt_passes(base, st, so, ln, bcap, level)
        return serial(base, st, so, ln, bcap, level, *args)

    monkeypatch.setattr(ES, "encode_windows_plain", route)
    return taken


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("size", [100, 70000])
def test_frames_equal_the_jax_host_route(size, chain, passes_on_the_cpu_route):
    data = CORPUS[300000:300000 + size]
    kw = dict(compression_level=12, chain_blocks=chain, content_checksum=True)
    ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    assert passes_on_the_cpu_route
    assert ours == jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
    assert tframe.decompress(ours, device="cpu") == data


@pytest.mark.parametrize("dict_len", [100, 70000])
def test_block_encode_with_a_dictionary_equals_the_jax_host_route(
        dict_len, passes_on_the_cpu_route):
    at = 600000
    d, s = CORPUS[at - dict_len:at], CORPUS[at:at + 20000]
    ours = tblock.encode(s, level=12, dictionary=d, device="cpu")
    assert passes_on_the_cpu_route
    assert ours == jblock.encode(s, level=12, dictionary=d, backend="host")
    assert tblock.decode(ours, len(s), dictionary=d, device="cpu") == s


def _case(name):
    """(base, starts, src_offs, lens, bcap) of one case."""
    mix = chip_smoke.make_corpus(1 << 20, 3)
    if name == "12_and_13_bytes":
        return (*_flat([mix[:12], mix[100:113], b"", b"x"]), 13)
    if name == "65548_bytes":  # runs, then noise
        return (*_flat([mix[760000:825548]]), 65548)
    if name == "chained_128KB_window":
        # the block at 4 MiB / 4 into the records, with its 64 KB prefix
        a = 327680
        base = torch.frombuffer(bytearray(mix), dtype=torch.uint8)
        return base, [a - 65536], [65536], [131072], 65536
    if name == "100000_bytes":  # noise: positions past the ring's 65,536
        return (*_flat([mix[800000:900000]]), 100000)
    if name == "one_byte":
        return (*_flat([b"\x61" * 6000]), 6000)
    if name == "three_byte_pattern":
        return (*_flat([(b"abc" * 1000)[:2500] + mix[:500]]), 3000)
    if name == "bench_mix":
        return (*_flat([mix[k * 262144:k * 262144 + 16384] for k in range(4)]), 16384)
    raise KeyError(name)


CASES = ["12_and_13_bytes", "65548_bytes", "chained_128KB_window",
         "100000_bytes", "one_byte", "three_byte_pattern", "bench_mix"]


@pytest.mark.parametrize("name", CASES)
def test_passes_equal_the_serial_parse(name):
    _hold(*_case(name))


@pytest.mark.parametrize("budget", [0, 16, 1 << 40])
def test_any_budget_gives_the_same_bytes(budget):
    """A search the match pass gives up is made in full by the parse: from
    every search that takes a chain step given up (budget 0) to none, in
    one round."""
    base, st, so, ln, bcap = _case("bench_mix")
    prev = EO.opt_chain(base, st, ln)
    matches = EO.opt_matches(base, st, so, ln, prev, budget=budget, first_budget=budget)
    given_up = int((matches[:, 0] < 0).sum())
    if budget == 0:
        assert given_up > 40000 and not bool((matches[:, 0] > 0).any())
    if budget == 1 << 40:
        assert given_up == 0
    got = EO.opt_parse(base, st, so, ln, prev, matches, bcap)
    assert _bytes(got) == _bytes(ES.encode_windows_plain(base, st, so, ln, bcap, 12))


def _walked(s: bytes, src_off: int):
    """`ChainFinder` over the ring, walked in position order: every
    position's (length, offset) as the serial level 12 parse would see it."""
    n = len(s)
    finder = ChainFinder(s, n - 5, 16384)
    finder.insert_upto(src_off)
    want = [(0, 0)] * n
    for p in range(src_off, n - 12 + 1):
        ml, _, mp = finder.wider_match(p, p, 3, True, True)
        if ml > 3 and mp >= 0:
            want[p] = (ml, p - mp)
    return want


@pytest.mark.parametrize("name", ["chained_128KB_window", "bench_mix", "three_byte_pattern"])
def test_table_pass_equals_a_chain_finder_in_position_order(name):
    base, st, so, ln, _ = _case(name)
    if name == "chained_128KB_window":  # the first 20 KB of the block
        ln = [65536 + 20000]
    prev = EO.opt_chain(base, st, ln)
    full = EO.opt_matches(base, st, so, ln, prev, budget=1 << 40, first_budget=1 << 40)
    budgeted = EO.opt_matches(base, st, so, ln, prev)
    toff, _ = EO.table_offsets(ln)
    for a, off, n, at in zip(st, so, ln, toff.tolist()):
        want = _walked(base[a:a + n].numpy().tobytes(), off)
        assert full[at:at + n].tolist() == [list(w) for w in want]
        for got, w in zip(budgeted[at:at + n].tolist(), want):
            assert got == list(w) or (got[0] < 0 and got[1] == 0)


def test_chain_table_is_the_ring_before_each_insert():
    """prev[p] is what the ring's head holds for p's hash just before p is
    inserted (HC_EMPTY for none and for the last 3 positions)."""
    s = CORPUS[123456:123456 + 20000] + b"\x61" * 300
    base = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    prev = EO.opt_chain(base, [0], [len(s)]).tolist()
    ring = ChainFinder(s, len(s) - 5, 16)
    for p in range(len(s) - 3):
        h = ring.head[_hash(read32(s, p))]
        assert prev[p] == (h if h >= 0 else EO.HC_EMPTY), p
        ring.insert_upto(p + 1)
    assert prev[-3:] == [EO.HC_EMPTY] * 3


class _AheadFinder(EO.TableFinder):
    """A `TableFinder` whose head read at p is the last position of p's
    hash below p + 64, as a ring that inserted 64 positions ahead holds."""

    def insert_upto(self, pos: int):
        h = _hash(read32(self.s, pos))
        q = pos
        for r in range(pos + 1, min(pos + 64, len(self.prev))):
            if self.prev[r] >= 0 and _hash(read32(self.s, r)) == h:
                q = r
        self.head[h] = q if q > pos else self.prev[pos]


def test_the_skip_loop_walks_a_head_ahead_back_to_the_search():
    """The search's skip loop (`while cand >= pos`), which never fires over
    the tables, steps a head entry past p back along the full-length
    tables to p's own chain: the same result as the exact head."""
    s = (b"abcdabcd" * 40 + CORPUS[200000:204000]) * 2
    base = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    prev = EO.opt_chain(base, [0], [len(s)]).tolist()
    exact = EO.TableFinder(s, len(s) - 5, 16384, prev)
    ahead = _AheadFinder(s, len(s) - 5, 16384, prev)
    skipped = 0
    for p in range(0, len(s) - 12):
        ahead.insert_upto(p)
        skipped += ahead.head[_hash(read32(s, p))] >= p
        assert ahead.wider_match(p, p, 3, True, True) == exact.wider_match(p, p, 3, True, True)
    assert skipped > 100


def test_rows_in_groups_give_the_same_bytes(monkeypatch):
    """Rows over `GROUP_TABLE_BYTES` run as several groups, one launch of
    each pass per group, with the bytes of one group."""
    base, st, so, ln, bcap = _case("bench_mix")
    whole = EO.encode_windows_opt_passes(base, st, so, ln, bcap)
    monkeypatch.setattr(EO, "GROUP_TABLE_BYTES", 2 * 16384 * EO.TABLE_BYTES)
    assert EO.row_groups(ln) == [(0, 2), (2, 4)]
    for a, b in zip(EO.encode_windows_opt_passes(base, st, so, ln, bcap), whole):
        assert torch.equal(a, b)
    assert EO.row_groups([10 ** 7, 5, 5]) == [(0, 1), (1, 3)]


def test_cpu_tensors_count_no_launch_and_tables_are_checked():
    base, st, so, ln, bcap = _case("12_and_13_bytes")
    counts = [f.launches for f in (EO.opt_chain, EO.opt_matches, EO.opt_parse)]
    prev = EO.opt_chain(base, st, ln)
    matches = EO.opt_matches(base, st, so, ln, prev)
    EO.opt_parse(base, st, so, ln, prev, matches, bcap)
    assert [f.launches for f in (EO.opt_chain, EO.opt_matches, EO.opt_parse)] == counts
    with pytest.raises(ValueError, match="prev must be int32"):
        EO.opt_matches(base, st, so, ln, prev[1:])
    with pytest.raises(ValueError, match="matches must be int32"):
        EO.opt_parse(base, st, so, ln, prev, matches.to(torch.int64), bcap)
    with pytest.raises(ValueError, match="outside base_u8"):
        EO.opt_chain(base, [0], [base.numel() + 1])
    with pytest.raises(ValueError, match="not an OPT level"):
        EO.encode_windows_opt_passes(base, st, so, ln, bcap, 9)


@pytest.mark.parametrize("retry_longest", [64, 1 << 20])
def test_a_short_search_given_up_starts_again_with_the_large_budget(retry_longest):
    """A search given up at the first budget with no match longer than
    ``retry_longest`` (records) is made again with the large budget, not
    one that had measured a long repeat (a 3-byte pattern) unless the
    limit admits it; every other entry is the first budget's."""
    mix = chip_smoke.make_corpus(1 << 20, 3)
    base, st, so, ln = _flat([(b"abc" * 1000)[:2500], mix[300000:304000]])
    prev = EO.opt_chain(base, st, ln)
    one = EO.opt_matches(base, st, so, ln, prev, budget=256, first_budget=256)
    big = EO.opt_matches(base, st, so, ln, prev, budget=4096, first_budget=4096)
    two = EO.opt_matches(base, st, so, ln, prev, budget=4096, first_budget=256,
                         retry_longest=retry_longest)
    given_up = one[:, 0] < 0
    again = given_up & (-1 - one[:, 0] <= retry_longest)
    assert torch.equal(two[again], big[again])
    assert torch.equal(two[~again], one[~again])
    assert int(again[2500:].sum()) == int(given_up[2500:].sum()) > 0
    assert bool((given_up & ~again).any()) == (retry_longest == 64)
    got = EO.opt_parse(base, st, so, ln, prev, two, 4000)
    assert _bytes(got) == _bytes(ES.encode_windows_plain(base, st, so, ln, 4000, 12))
