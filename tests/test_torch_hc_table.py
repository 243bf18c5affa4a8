"""The HC arm (levels 3-9) as passes
(`lz4_tpu_torch/ops/encode_hc_passes.py`): the plain versions of the chain,
deltas and parse passes composed, and the parse by segments' model
(`hc_parse_segments_plain`), give exactly the bytes of the serial plain
parse (`encode_hc.encode_hc`), of the JAX package's `pallas_encode5` and
`pallas_encode_stream` in interpret mode and of its host route; every
search the parse makes on the spot equals a `ChainFinder` search with the
same key over the ring; long repeats give the serial bytes with no budget;
and the frontier property the parse rests on holds on every case."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bench
import chip_smoke
from lz4_tpu import frame as jframe
from lz4_tpu.ops import encode_pallas5 as E5
from lz4_tpu.ops import encode_pallas_stream as JES
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.ops import encode_hc as EH
from lz4_tpu_torch.ops import encode_hc_passes as HP
from lz4_tpu_torch.ops import encode_opt as EO
from lz4_tpu_torch.ops import encode_stream as ES
from test_pallas_encode5 import _cases

CORPUS = bench.make_corpus(1 << 20, seed=11)
N = 4096


def _flat(rows, prefixes=None):
    """Rows as windows of one flat tensor, each after its prefix."""
    prefixes = prefixes or [b""] * len(rows)
    base, starts, src_offs, lens = bytearray(), [], [], []
    for p, r in zip(prefixes, rows):
        starts.append(len(base))
        src_offs.append(len(p))
        lens.append(len(p) + len(r))
        base += p + r
    return torch.frombuffer(base or bytearray(1), dtype=torch.uint8), starts, src_offs, lens


def _bytes(res):
    out, clens, errs = res
    assert not errs.any()
    return [out[i, :int(clens[i])].numpy().tobytes() for i in range(clens.numel())]


# the model's segments on the CPU tests' small rows: many segments a row
SEGMENT, OVERLAP = 1024, 256


def _passes(base, st, so, ln, bcap, level, counts=None):
    """The plain passes one by one: the chain, the deltas, then the parse
    (`hc_parse_plain`'s (out, clens, errs), its per-row counts into
    ``counts``) and its model by segments (`hc_parse_segments_plain` at
    `SEGMENT`, `OVERLAP`); returns both outputs and (prev, deltas)."""
    depth = EH.level_arm(level)[1]
    prev = EO.opt_chain(base, st, ln)
    deltas = HP.hc_deltas(prev, ln)
    got = HP.hc_parse_plain(base, st, so, ln, prev, deltas, bcap, depth, counts)
    model = HP.hc_parse_segments_plain(base, st, so, ln, prev, deltas, bcap, depth, SEGMENT,
                                       OVERLAP)
    return got, model, (prev, deltas)


def _hold(base, st, so, ln, bcap, level):
    """The plain passes composed, and the parse by segments' model, against
    the serial plain parse."""
    ours = HP.encode_windows_hc_passes(base, st, so, ln, bcap, level)
    theirs = ES.encode_windows_plain(base, st, so, ln, bcap, level)
    assert _bytes(ours) == _bytes(theirs)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    _, model, _ = _passes(base, st, so, ln, bcap, level)
    for a, b in zip(model, theirs):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        E5.pallas_encode5.clear_cache()
        JES.pallas_encode_stream.clear_cache()
        yield
        E5.pallas_encode5.clear_cache()
        JES.pallas_encode_stream.clear_cache()


def _pallas_rows():
    """Rows of the JAX package's HC tests, 4 KB of the text and records
    quarters of the bench mix and the head of the wordy regression row."""
    rng = random.Random(1234)
    cases = _cases(rng)
    return [cases[k] for k in (0, 3, 5, 9)] + [
        CORPUS[q * 262144 + 5000:q * 262144 + 9096] for q in range(2)
    ] + [chip_smoke.wordy_row()[:N], b"", b"q" * 12, b"abcdefghijklm"]


@pytest.mark.parametrize("level", [3, 6, 9])
def test_passes_match_pallas(level, interpret):
    rows = _pallas_rows()
    bufs = np.zeros((len(rows), N + 1024), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, d in enumerate(rows):
        bufs[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    jout, jclens, jerrs = (np.asarray(t) for t in E5.encode_blocks_pallas5(bufs, lens, N, level))
    flat = torch.from_numpy(bufs).reshape(-1)
    starts = [i * bufs.shape[1] for i in range(len(rows))]
    out, clens, errs = HP.encode_windows_hc_passes(flat, starts, [0] * len(rows),
                                                   lens.tolist(), N, level)
    assert np.array_equal(clens.numpy(), jclens) and np.array_equal(errs.numpy(), jerrs)
    for i in range(len(rows)):
        assert np.array_equal(out[i, :clens[i]].numpy(), jout[i, :jclens[i]]), i
    theirs = ES.encode_windows_plain(flat, starts, [0] * len(rows), lens.tolist(), N, level)
    assert _bytes((out, clens, errs)) == _bytes(theirs)
    _, model, _ = _passes(flat, starts, [0] * len(rows), lens.tolist(), N, level)
    assert _bytes(model) == _bytes(theirs)


def test_chained_windows_match_pallas_stream(interpret):
    """4 KB blocks of the mix at level 9, one after the 4 KB before it (as
    a chained frame's window), one after 3,000 bytes and one with none,
    through `pallas_encode_stream` with the prefixes as its dictionaries."""
    level, cap, dw = 9, 4096, 4096
    ats = [100000, 330000, 600000]
    dls = [dw, 3000, 0]
    blocks = [CORPUS[a:a + cap] for a in ats]
    prefixes = [CORPUS[a - dl:a] for a, dl in zip(ats, dls)]
    bufs = np.zeros((len(ats), cap), np.uint8)
    dicts = np.zeros((len(ats), dw), np.uint8)
    for k, (b, p) in enumerate(zip(blocks, prefixes)):
        bufs[k] = np.frombuffer(b, np.uint8)
        if p:
            dicts[k, dw - len(p):] = np.frombuffer(p, np.uint8)
    lens = np.full((len(ats),), cap, np.int32)
    jout, jclens, _ = (np.asarray(t) for t in JES.encode_blocks_pallas_stream(
        bufs, lens, cap, level, dicts=dicts, dict_lens=np.asarray(dls, np.int32)))
    got = HP.encode_windows_hc_passes(*_flat(blocks, prefixes), cap, level)
    want = [jout[k, :jclens[k]].tobytes() for k in range(len(ats))]
    assert _bytes(got) == want
    _, model, _ = _passes(*_flat(blocks, prefixes), cap, level)
    assert _bytes(model) == want


def _case(name):
    """(base, starts, src_offs, lens, bcap) of one case."""
    mix = chip_smoke.make_corpus(1 << 20, 3)
    if name == "12_and_13_bytes":
        return (*_flat([mix[:12], mix[100:113], b"", b"x"]), 13)
    if name == "chained_window":  # 6 KB of records after its 64 KB window
        return (*_flat([mix[327680:333824]], [mix[262144:327680]]), 6144)
    if name == "past_the_ring":  # noise: positions past the ring's 65,536
        return (*_flat([mix[800000:870000]]), 70000)
    if name == "one_byte":
        return (*_flat([b"\x61" * 3000]), 3000)
    if name == "three_byte_pattern":
        return (*_flat([(b"abc" * 1000)[:2500] + mix[:500]]), 3000)
    if name == "bench_mix":
        return (*_flat([mix[k * 262144:k * 262144 + 4096] for k in range(4)]), 4096)
    raise KeyError(name)


CASES = ["12_and_13_bytes", "chained_window", "past_the_ring", "one_byte",
         "three_byte_pattern", "bench_mix"]


@pytest.mark.parametrize("level", [4, 9])
@pytest.mark.parametrize("name", CASES)
def test_passes_equal_the_serial_parse(name, level):
    _hold(*_case(name), level)


class _LoggedFinder(HP.FrontierFinder):
    """`FrontierFinder` that logs each search: its key, the frontier it was
    made at and its answer."""

    log = []

    def wider_match(self, ip, ilow, longest, pattern_analysis, chain_swap=False):
        got = super().wider_match(ip, ilow, longest, pattern_analysis, chain_swap)
        self.log.append((ip, ilow, longest, self.frontier, got))
        return got


def test_every_search_equals_a_chain_finder_search(monkeypatch):
    """Each search the parse makes on the spot is what a `ChainFinder`
    over the ring answers with the same key and exactly the positions
    below the search inserted (the searches in the parse's order)."""
    monkeypatch.setattr(HP, "FrontierFinder", _LoggedFinder)
    checked = 0
    for name in ("bench_mix", "chained_window"):
        base, st, so, ln, bcap = _case(name)
        st, so, ln = st[:1], so[:1], ln[:1]
        prev = EO.opt_chain(base, st, ln)
        _LoggedFinder.log = []
        HP.hc_parse_plain(base, st, so, ln, prev, HP.hc_deltas(prev, ln), bcap, 256)
        s = base[st[0]:st[0] + ln[0]].numpy().tobytes()
        finder = EH.ChainFinder(s, ln[0] - 5, 256)
        finder.insert_upto(so[0])
        for ip, ilow, longest, frontier, got in _LoggedFinder.log:
            assert frontier == ip  # the frontier property: no search behind another
            finder.insert_upto(ip)
            assert finder.next_to_insert == ip
            assert finder.wider_match(ip, ilow, longest, True) == got, (ip, ilow, longest)
            checked += 1
    assert checked > 500


@pytest.mark.parametrize("level", [4, 9])
@pytest.mark.parametrize("name", ["one_byte", "three_byte_pattern"])
def test_long_repeats_give_the_serial_bytes_with_no_budget(name, level):
    """In a long repeat the parse measures the repeat once, at the first
    search that reaches it, and never searches inside the match it takes:
    no budget, few searches, the serial parse's bytes, also by segments
    that start inside the repeat."""
    base, st, so, ln, bcap = _case(name)
    counts = []
    got, model, _ = _passes(base, st, so, ln, bcap, level, counts=counts)
    want = _bytes(ES.encode_windows_plain(base, st, so, ln, bcap, level))
    assert _bytes(got) == _bytes(model) == want
    assert 0 < counts[0]["searches"] * 10 < int(ln[0]) - int(so[0])


@pytest.mark.parametrize("segment", [16, 100, 4096])
def test_any_segment_length_gives_the_same_bytes(segment):
    """The model by segments at any segment length (overlaps of a quarter
    of it) gives the serial parse's bytes on the mix; the shortest
    segments walk again where their overlap is too short to meet."""
    base, st, so, ln, bcap = _case("bench_mix")
    counts = []
    got = HP.hc_parse_segments_plain(base, st, so, ln, EO.opt_chain(base, st, ln),
                                     HP.hc_deltas(EO.opt_chain(base, st, ln), ln), bcap, 256,
                                     segment, segment // 4, counts=counts)
    assert _bytes(got) == _bytes(ES.encode_windows_plain(base, st, so, ln, bcap, 9))
    assert all(c["segments"] == -(-(4096 - 11) // segment) for c in counts)


def test_the_parse_reads_its_steps_from_the_deltas():
    """The parse's chain steps are the deltas it is given: with
    `hc_deltas`' it gives the serial bytes, plain and by segments; with
    each step one longer (a step past a match candidate) other bytes."""
    base, st, so, ln, bcap = _case("bench_mix")
    prev = EO.opt_chain(base, st, ln)
    deltas = HP.hc_deltas(prev, ln)
    want = _bytes(ES.encode_windows_plain(base, st, so, ln, bcap, 9))
    assert _bytes(HP.hc_parse(base, st, so, ln, prev, deltas, bcap)) == want
    moved = deltas + (deltas > 0).to(torch.int16)
    assert _bytes(HP.hc_parse(base, st, so, ln, prev, moved, bcap)) != want
    assert _bytes(HP.hc_parse_segments_plain(base, st, so, ln, prev, moved, bcap, 256, SEGMENT,
                                             OVERLAP)) != want


def test_frontier_finder_answers_as_the_ring():
    """Where the ring holds positions past the search (a search behind the
    frontier, which the parse makes on the spot), `FrontierFinder` gives
    the ring's answers, the deltas of positions 65,536 apart aliased; the
    table's own answers differ there."""
    s = CORPUS[0:40000] + b"ab" * 20000 + CORPUS[500000:600000]
    base = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    prev = EO.opt_chain(base, [0], [len(s)]).tolist()
    rng = random.Random(5)
    cases = []
    for k in range(150):
        f = rng.randrange(1000, len(s) - 20)
        cases.append((f, f - rng.randrange(1, min(f, 70000 if k % 2 else 300))))
    ring = EH.ChainFinder(s, len(s) - 5, 256)
    frontier = HP.FrontierFinder(s, len(s) - 5, 256, prev, 0)
    table = EO.TableFinder(s, len(s) - 5, 256, prev)
    differ = 0
    for f, pos in sorted(cases):
        ring.insert_upto(f)
        frontier.frontier = f
        for ilow, longest, pa in ((pos, 3, True), (max(0, pos - 5), 6, False)):
            want = ring.wider_match(pos, ilow, longest, pa)
            assert frontier.wider_match(pos, ilow, longest, pa) == want
            differ += table.wider_match(pos, ilow, longest, pa) != want
    assert differ > 10


class _FrontierRing(EH.ChainFinder):
    """The ring, asserting that no search is made with a position at or
    above it already inserted."""

    def wider_match(self, ip, ilow, longest, pattern_analysis, chain_swap=False):
        assert self.next_to_insert <= ip, (self.next_to_insert, ip)
        return super().wider_match(ip, ilow, longest, pattern_analysis, chain_swap)


@pytest.mark.parametrize("level", [3, 9])
def test_the_serial_parse_never_searches_behind_its_frontier(level, monkeypatch):
    """The frontier property on every case of this file: the serial parse
    makes each search with exactly the positions below it inserted, so the
    ring never aliases at search time (`test_every_search_equals_a_chain_
    finder_search` asserts the same of the passes' parse)."""
    monkeypatch.setattr(EH, "ChainFinder", _FrontierRing)
    rows = [(r, 0) for r in _pallas_rows()] + [(CORPUS[84000:104096], 16000)]
    for name in CASES:
        base, st, so, ln, _ = _case(name)
        rows += [(base[a:a + n].numpy().tobytes(), off) for a, off, n in zip(st, so, ln)]
    for r, off in rows:
        EH.encode_hc(r, off, EH.level_arm(level)[1])


def test_rows_in_groups_give_the_same_bytes(monkeypatch):
    """Rows over `encode_opt.GROUP_TABLE_BYTES` run as several groups of
    the OPT passes' rule (`encode_opt.row_groups`), one launch of each pass
    per group, with the bytes of one group."""
    base, st, so, ln, bcap = _case("bench_mix")
    whole = HP.encode_windows_hc_passes(base, st, so, ln, bcap, 6)
    monkeypatch.setattr(EO, "GROUP_TABLE_BYTES", 2 * 4096 * EO.TABLE_BYTES)
    assert EO.row_groups(ln) == [(0, 2), (2, 4)]
    for a, b in zip(HP.encode_windows_hc_passes(base, st, so, ln, bcap, 6), whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["bench_mix", "chained_window", "past_the_ring"])
def test_deltas_are_the_chain_steps(name):
    """`hc_deltas` holds each window position's chain step min(p - prev[p],
    0xFFFF) as the bits of a u16, laid out as prev: 0xFFFF where a chain
    ends (no earlier position of its hash) or steps 64 K or more back."""
    base, st, _, ln, _ = _case(name)
    prev = EO.opt_chain(base, st, ln)
    got = (HP.hc_deltas(prev, ln).to(torch.int64) & 0xFFFF).tolist()
    at = 0
    for n in ln:
        for p in range(n):
            assert got[at + p] == min(p - int(prev[at + p]), 0xFFFF)
        at += n
    assert 0xFFFF in got


def test_cpu_tensors_count_no_launch_and_tables_are_checked():
    base, st, so, ln, bcap = _case("12_and_13_bytes")
    passes = (EO.opt_chain, HP.hc_deltas, HP.hc_parse)
    counts = [f.launches for f in passes]
    prev = EO.opt_chain(base, st, ln)
    deltas = HP.hc_deltas(prev, ln)
    assert deltas.shape == prev.shape and deltas.dtype == torch.int16
    HP.hc_parse(base, st, so, ln, prev, deltas, bcap)
    assert [f.launches for f in passes] == counts
    with pytest.raises(ValueError, match="prev must be int32"):
        HP.hc_deltas(prev[1:], ln)
    with pytest.raises(ValueError, match="deltas must be int16"):
        HP.hc_parse(base, st, so, ln, prev, deltas[1:], bcap)
    with pytest.raises(ValueError, match="deltas must be int16"):
        HP.hc_parse(base, st, so, ln, prev, prev, bcap)
    with pytest.raises(ValueError, match="not an HC level"):
        HP.encode_windows_hc_passes(base, st, so, ln, bcap, 10)


@pytest.fixture
def passes_on_the_cpu_route(monkeypatch):
    """The CPU route of `encode_stream.encode_windows` at levels 3-9 through
    the plain passes instead of the serial plain parse; yields the
    number of batches it took."""
    serial = ES.encode_windows_plain
    taken = []

    def route(base, st, so, ln, bcap, level=0, *args):
        if EH.level_arm(level)[0] == "hc":
            taken.append(len(ln))
            return HP.encode_windows_hc_passes(base, st, so, ln, bcap, level)
        return serial(base, st, so, ln, bcap, level, *args)

    monkeypatch.setattr(ES, "encode_windows_plain", route)
    return taken


@pytest.mark.parametrize("chain", [False, True])
def test_frames_equal_the_jax_host_route(chain, passes_on_the_cpu_route):
    data = CORPUS[300000:308000] + CORPUS[700000:702000]
    kw = dict(compression_level=9, chain_blocks=chain, content_checksum=True,
              block_size=65536)
    ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    assert passes_on_the_cpu_route
    assert ours == jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
    assert tframe.decompress(ours, device="cpu") == data
