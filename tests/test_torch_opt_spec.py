"""Levels 10-11 as three passes (`lz4_tpu_torch/ops/encode_opt.py`): the
chain and match passes of level 12 at the level's depth, then the parse by
rounds (`opt_parse_spec`), whose plain version makes a round's searches
one lane after another and asserts in every round that the committed
lanes are the serial parse's searches.  Composed, the plain passes give
exactly the bytes of the serial plain parse (`encode_hc.encode_opt`), of
the JAX package's `pallas_encode5` in interpret mode and of its host
route.  The fact the rounds rest on, that a search for a match longer than
1, 2 or 3 bytes walks the chain as the min-length-3 search does, is held
at every position of small rows.  Rows are kept small: the plain match
pass is a Python search at every position."""

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
from lz4_tpu_torch.ops.encode_hc import level_arm
from test_pallas_encode5 import _cases

CORPUS = bench.make_corpus(1 << 20, seed=11)
MIX = chip_smoke.make_corpus(1 << 20, 3)
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


def _passes(base, st, so, ln, bcap, level, lanes=32, budget=EO.MATCH_BUDGET,
            first_budget=EO.FIRST_BUDGET, counts=None):
    """The three plain passes at ``level`` with ``lanes`` searches a round."""
    _, depth, sufficient, _ = level_arm(level)
    prev = EO.opt_chain(base, st, ln)
    matches = EO.opt_matches(base, st, so, ln, prev, depth, budget, first_budget)
    return EO.opt_parse_spec_plain(base, st, so, ln, prev, matches, bcap, depth,
                                   sufficient, lanes, counts), matches


KINDS = ("text", "records", "runs", "noise", "one_byte", "three_byte_pattern")


def _kind(name: str, n: int) -> bytes:
    """``n`` bytes of one kind: a quarter of the bench mix, or a repeat."""
    if name == "one_byte":
        return b"\x61" * n
    if name == "three_byte_pattern":
        return (b"abc" * n)[:n]
    q = KINDS.index(name) * (len(MIX) // 4) + 5000
    return MIX[q:q + n]


@pytest.mark.parametrize("name", KINDS)
def test_a_search_longer_than_1_2_or_3_walks_as_the_min_length_3_search(name):
    """Fact 1: at every position, the search for a match longer than m = 1,
    2 or 3 takes the same chain steps as the one for m = 3 and finds the
    same match (or none), at level 11's depth (the repeat of a 3-byte
    pattern is cut shorter: each step there measures the rest of the row)."""
    s = _kind(name, {"three_byte_pattern": 400, "one_byte": 1500}.get(name, 4096))
    base = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    prev = EO.opt_chain(base, [0], [len(s)]).tolist()
    finder = EO.TableFinder(s, len(s) - 5, 512, prev)

    def find(p, m):
        steps = finder.steps
        ml, _, mp = finder.wider_match(p, p, m, True, True)
        return ((ml, p - mp) if ml > m and mp >= 0 else (0, 0)), finder.steps - steps

    found = 0
    for p in range(len(s) - 12 + 1):
        want = find(p, 3)
        found += want[0][0] > 0
        for m in (1, 2):
            assert find(p, m) == want, (p, m)
    assert found > (0 if name == "noise" else 100) or len(s) < 1000


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


@pytest.mark.parametrize("level", [10, 11])
def test_passes_match_pallas(level, interpret):
    """The 4 KB rows of `test_torch_opt_table.py::test_passes_match_pallas`
    through `pallas_encode5` at levels 10 and 11 in interpret mode."""
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
    jout, jclens, jerrs = (np.asarray(t) for t in
                           E5.encode_blocks_pallas5(bufs, lens, N, level))
    flat = torch.from_numpy(bufs).reshape(-1)
    starts = [i * bufs.shape[1] for i in range(len(rows))]
    before = EO.opt_parse_spec.launches
    out, clens, errs = EO.encode_windows_opt_passes(flat, starts, [0] * len(rows),
                                                    lens.tolist(), N, level)
    assert EO.opt_parse_spec.launches == before  # the plain versions
    assert np.array_equal(clens.numpy(), jclens) and np.array_equal(errs.numpy(), jerrs)
    for i in range(len(rows)):
        assert np.array_equal(out[i, :clens[i]].numpy(), jout[i, :jclens[i]]), i


def _mix_rows():
    """A 12 KB cut of each quarter of the mix, where levels 10 and 11
    differ, a long run of one byte and a 3-byte pattern."""
    return [MIX[q * 262144 + 9000:q * 262144 + 21288] for q in range(4)] + [
        b"\x61" * 5000, (b"abc" * 1000)[:2500] + MIX[:500]]


@pytest.mark.parametrize("level", [10, 11])
@pytest.mark.parametrize("lanes", [1, 2, 32])
def test_rounds_of_any_width_equal_the_serial_parse(lanes, level):
    """The plain passes with 1, 2 or 32 lanes a round against the serial
    plain parse; a tiny match budget leaves most min-length-3 entries given
    up, which the parse searches on the spot."""
    rows = _mix_rows()
    base, st, so, ln = _flat(rows)
    bcap = max(ln)
    counts = []
    got, matches = _passes(base, st, so, ln, bcap, level, lanes, budget=24,
                           first_budget=24, counts=counts)
    assert _bytes(got) == _bytes(ES.encode_windows_plain(base, st, so, ln, bcap, level))
    assert int((matches[:, 0] < 0).sum()) > 10000
    assert all(c["windows"] > 0 for c in counts)
    assert all(c["searches"] >= c["search_rounds"] > 0 for c in counts[:4])
    # the step count takes only the lanes a round commits; with one lane a
    # round commits every lane it searched
    assert all(c["steps"] <= c["speculative_steps"] for c in counts)
    if lanes == 1:
        assert all(c["steps"] == c["speculative_steps"] for c in counts)


def test_levels_10_and_11_differ_on_the_mix():
    """The mix rows of `test_rounds_of_any_width_equal_the_serial_parse`
    give different bytes at levels 10 and 11 (depth 96 against 512,
    sufficient length 64 against 128), so both levels' holds mean
    something."""
    base, st, so, ln = _flat(_mix_rows()[:4])
    ten = _bytes(ES.encode_windows_plain(base, st, so, ln, max(ln), 10))
    eleven = _bytes(ES.encode_windows_plain(base, st, so, ln, max(ln), 11))
    assert ten != eleven


@pytest.mark.parametrize("level", [10, 11])
def test_chained_windows_equal_the_serial_parse(level):
    """Chained windows (blocks with their 64 KB prefixes, the first 8 KB of
    each block) and a right-aligned dictionary row."""
    base = torch.frombuffer(bytearray(MIX), dtype=torch.uint8)
    st0, offs, wl = chip_smoke.chained_windows(len(MIX), 65536)
    pick = [1, 7]
    st, so = st0[pick].tolist(), offs[pick].tolist()
    ln = [off + 8192 for off in so]
    bcap = 8192
    got, _ = _passes(base, st, so, ln, bcap, level)
    assert _bytes(got) == _bytes(ES.encode_windows_plain(base, st, so, ln, bcap, level))
    at = 600000
    d, s = CORPUS[at - 3000:at], CORPUS[at:at + 6000]
    ours = tblock.encode(s, level=level, dictionary=d, device="cpu")
    bufs = torch.frombuffer(bytearray(s), dtype=torch.uint8).reshape(1, -1)
    dicts = torch.frombuffer(bytearray(d), dtype=torch.uint8).reshape(1, -1)
    flat, dst, dso, dln, _ = ES._stage(bufs, [len(s)], len(s), dicts, [len(d)], "dense")
    got, _ = _passes(flat, dst, dso, dln, len(s), level)
    assert _bytes(got) == [ours]
    assert ours == jblock.encode(s, level=level, dictionary=d, backend="host")


@pytest.fixture
def passes_on_the_cpu_route(monkeypatch):
    """The CPU route of `encode_stream.encode_windows` at levels 10-11
    through the three plain passes instead of the serial plain parse;
    yields the number of batches it took."""
    serial = ES.encode_windows_plain
    taken = []

    def route(base, st, so, ln, bcap, level=0, *args):
        if level_arm(level)[0] == "opt" and not level_arm(level)[3]:
            taken.append(len(ln))
            return EO.encode_windows_opt_passes(base, st, so, ln, bcap, level)
        return serial(base, st, so, ln, bcap, level, *args)

    monkeypatch.setattr(ES, "encode_windows_plain", route)
    return taken


@pytest.mark.parametrize("level", [10, 11])
@pytest.mark.parametrize("chain", [False, True])
def test_frames_equal_the_jax_host_route(level, chain, passes_on_the_cpu_route):
    data = CORPUS[300000:300000 + 70000]
    kw = dict(compression_level=level, chain_blocks=chain, content_checksum=True)
    ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    assert passes_on_the_cpu_route
    assert ours == jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
    assert tframe.decompress(ours, device="cpu") == data


def test_the_passes_refuse_what_they_do_not_run():
    """The OPT passes take levels 10 and up only, the parse by rounds at
    least one lane, and its tables as `opt_parse` does."""
    base, st, so, ln = _flat([MIX[:3000], MIX[5000:5013]])
    for level in (0, 2, 3, 9):
        with pytest.raises(ValueError, match="not an OPT level"):
            EO.encode_windows_opt_passes(base, st, so, ln, 3000, level)
    prev = EO.opt_chain(base, st, ln)
    matches = EO.opt_matches(base, st, so, ln, prev, 96)
    with pytest.raises(ValueError, match="lanes"):
        EO.opt_parse_spec_plain(base, st, so, ln, prev, matches, 3000, lanes=0)
    with pytest.raises(ValueError, match="matches must be int32"):
        EO.opt_parse_spec(base, st, so, ln, prev, matches[1:], 3000)
    with pytest.raises(ValueError, match="block lengths"):
        EO.opt_parse_spec(base, st, so, ln, prev, matches, 2999)
    before = EO.opt_parse_spec.launches
    got = EO.opt_parse_spec(base, st, so, ln, prev, matches, 3000)
    assert EO.opt_parse_spec.launches == before
    assert _bytes(got) == _bytes(ES.encode_windows_plain(base, st, so, ln, 3000, 10))
