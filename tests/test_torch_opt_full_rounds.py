"""Level 12's parse by rounds (`encode_opt.opt_parse_rounds_row` with
``full``, the plain model of the warp kernel `opt_parse`): ``lanes`` table
entries read a round, their matches committed in order against the live
price table, its price-table steps spread over the lanes (`opt_add_warp`,
`opt_seed_warp`).  Its bytes equal the serial parse's
(`encode_hc.opt_parse_row(..., full=True)`, through `opt_parse_plain` and
the ring's `encode_windows_plain`) and those of the JAX package's
`pallas_encode5` at level 12 in interpret mode.  Also the lane split
against the serial steps on random price tables, and the plain match
pass's span and work tally.  Every comparison is exact (tolerance 0): the
results are bytes.  Rows are kept to a few KB: the plain match pass is a
Python search at every position."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from lz4_tpu.ops import encode_pallas5 as E5
from lz4_tpu_torch.ops import encode_hc as EH
from lz4_tpu_torch.ops import encode_opt as EO
from lz4_tpu_torch.ops import encode_stream as ES
from test_pallas_encode5 import _cases

MIX = chip_smoke.make_corpus(1 << 20, 3)
N = 4096
KINDS = ("text", "records", "runs", "noise", "one_byte", "three_byte_pattern")


def _kind(name: str, n: int = 3000) -> bytes:
    """``n`` bytes of one kind: a quarter of the bench mix, or a repeat
    (the six kinds of `tests/test_torch_opt_spec.py`)."""
    if name == "one_byte":
        return b"\x61" * n
    if name == "three_byte_pattern":
        return (b"abc" * n)[:n]
    q = KINDS.index(name) * (len(MIX) // 4) + 5000
    return MIX[q:q + n]


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


def _rounds(base, st, so, ln, bcap, lanes=32, budget=EO.MATCH_BUDGET,
            first_budget=EO.FIRST_BUDGET):
    """The plain passes at level 12, the parse by rounds with ``lanes``
    lanes; returns (its output, the serial parse's over the same tables,
    the per-row tallies, the match table)."""
    prev = EO.opt_chain(base, st, ln)
    matches = EO.opt_matches(base, st, so, ln, prev, budget=budget, first_budget=first_budget)
    counts = []
    got = EO.opt_parse_rounds_plain(base, st, so, ln, prev, matches, bcap, 16384, 4095, True,
                                    lanes, counts)
    serial = EO.opt_parse_plain(base, st, so, ln, prev, matches, bcap)
    return got, serial, counts, matches


def _hold(base, st, so, ln, bcap, lanes=32, **budgets):
    got, serial, counts, matches = _rounds(base, st, so, ln, bcap, lanes, **budgets)
    assert _bytes(got) == _bytes(serial)
    assert _bytes(got) == _bytes(ES.encode_windows_plain(base, st, so, ln, bcap, 12))
    for c in counts:
        assert c["steps"] <= c["speculative_steps"]
        assert c["table_steps"] * lanes >= c["priced"]
    if lanes == 1:
        assert all(c["steps"] == c["speculative_steps"] for c in counts)
        assert all(c["table_steps"] == c["priced"] for c in counts)
    return counts, matches


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("lanes", [1, 2, 32])
def test_rounds_equal_the_serial_parse(lanes, name):
    """Each kind of row at 1, 2 and 32 lanes a round."""
    s = _kind(name)
    counts, _ = _hold(*_flat([s]), len(s), lanes)
    assert counts[0]["windows"] > 0 and counts[0]["rounds"] > 0


@pytest.mark.parametrize("lanes", [1, 32])
def test_a_long_repeat_past_sufficient(lanes):
    """Matches longer than `sufficient` (4,095 at level 12: taken outright)
    and just under it (priced over thousands of lengths)."""
    rows = [b"\x61" * 9000, (b"abc" * 4000)[:4090] + MIX[:600],
            MIX[200000:201000] + b"\x62" * 4096 + MIX[:300]]
    _hold(*_flat(rows), 9000, lanes)


@pytest.mark.parametrize("lanes", [2, 32])
def test_a_tiny_budget_leaves_searches_to_the_lanes(lanes):
    """With a match budget of 24 most table entries are given up, so the
    rounds' lanes make those searches on the spot, side by side."""
    rows = [_kind(k, 2500) for k in KINDS]
    counts, matches = _hold(*_flat(rows), 2500, lanes, budget=24, first_budget=24)
    assert int((matches[:, 0] < 0).sum()) > 5000
    assert sum(c["searches"] for c in counts) > 100
    assert sum(c["search_rounds"] for c in counts) > 10


def test_chained_windows_and_a_dictionary():
    """Chained windows (8 KB blocks behind their 64 KB prefixes) and a
    block behind a 3,000-byte dictionary, as windows of one tensor."""
    base = torch.frombuffer(bytearray(MIX), dtype=torch.uint8)
    st0, offs, _ = chip_smoke.chained_windows(len(MIX), 65536)
    pick = [1, 7]
    st, so = st0[pick].tolist(), offs[pick].tolist()
    ln = [off + 8192 for off in so]
    counts, _ = _hold(base, st, so, ln, 8192)
    assert all(c["windows"] > 0 for c in counts)
    at = 600000
    st, so, ln = [at - 3000], [3000], [3000 + 6000]
    _hold(base, st, so, ln, 6000)


def test_rounds_match_pallas_at_level_12(interpret):
    """4 KB rows of the HC/OPT tests through `pallas_encode5` at level 12
    in interpret mode and through the plain passes with the parse by
    rounds."""
    rng = random.Random(4321)
    rows = _cases(rng)[:6] + [(b"abcabcabcabd" * 300)[:3500], rng.randbytes(64) * 60,
                              b"", b"q" * 12, b"abcdefghijklm"]
    bufs = np.zeros((len(rows), N + 1024), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, d in enumerate(rows):
        bufs[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    jout, jclens, jerrs = (np.asarray(t) for t in E5.encode_blocks_pallas5(bufs, lens, N, 12))
    flat = torch.from_numpy(bufs).reshape(-1)
    starts = [i * bufs.shape[1] for i in range(len(rows))]
    got, _, _, _ = _rounds(flat, starts, [0] * len(rows), lens.tolist(), N)
    out, clens, errs = got
    assert np.array_equal(clens.numpy(), jclens) and np.array_equal(errs.numpy(), jerrs)
    for i in range(len(rows)):
        assert np.array_equal(out[i, :clens[i]].numpy(), jout[i, :jclens[i]]), i


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        E5.pallas_encode5.clear_cache()
        yield
        E5.pallas_encode5.clear_cache()


def _random_table(rng, size):
    """A price table of random cells: price, offset, length (1: literals)
    and literal length."""
    o = []
    for _ in range(size):
        mlen = 1 if rng.random() < 0.5 else rng.randint(4, 300)
        o.append([rng.randint(0, 6000), rng.randint(0, 65535), mlen, rng.randint(0, 300)])
    return o


@pytest.mark.parametrize("seed", range(5))
def test_lane_split_steps_equal_the_serial_steps(seed):
    """`opt_add_warp` and `opt_seed_warp` (every write made from the table
    as it stood before the step, the trailing literals after) equal the
    serial `opt_add` and `opt_seed` on random price tables, with lengths
    up to level 12's 4,095; their step counts are ceil((length - 3) /
    lanes)."""
    rng = random.Random(seed)
    size = EH.OPT_NUM + EH.TRAILING
    for _ in range(60):
        o = _random_table(rng, size)
        cur = rng.randint(1, 3000)
        new_len = rng.choice([4, 5, 18, 19, 35, 36, rng.randint(4, size - cur - 4),
                              min(4095, size - cur - 4)])
        new_len = min(new_len, size - cur - 4)
        last = rng.randint(cur + 1, min(size - 4, cur + new_len + 40))
        want, got = [c[:] for c in o], [c[:] for c in o]
        lanes = rng.choice([1, 2, 32])
        last_want = EH.opt_add(want, cur, new_len, 777, last)
        last_got, steps = EO.opt_add_warp(got, cur, new_len, 777, last, lanes)
        assert (last_got, got) == (last_want, want)
        assert steps == -(-(new_len - 3) // lanes)
        first_len = rng.randint(4, 4095)
        llen = rng.randint(0, 70000)
        want, got = [c[:] for c in o], [c[:] for c in o]
        EH.opt_seed(want, llen, first_len, 55)
        assert EO.opt_seed_warp(got, llen, first_len, 55, lanes) == -(-(first_len - 3) // lanes)
        assert got == want


def test_match_pass_span_and_work_tally():
    """`opt_matches_plain` on a span of positions gives the whole table's
    entries there and zeros elsewhere; its tally counts the searches, the
    given-up entries, work within the two budgets, and dependent steps
    (a word compare a step over a long repeat)."""
    rows = [_kind("text", 3000), _kind("one_byte", 2000)]
    base, st, so, ln = _flat(rows)
    prev = EO.opt_chain(base, st, ln)
    whole = EO.opt_matches(base, st, so, ln, prev)
    counts = []
    part = EO.opt_matches_plain(base, st, so, ln, prev, counts=counts, span=(500, 1500))
    toff, _ = EO.table_offsets(ln)
    for r, n in enumerate(ln):
        t = int(toff[r])
        assert torch.equal(part[t + 500:t + 1500], whole[t + 500:t + 1500])
        assert not part[t:t + 500].any() and not part[t + 1500:t + n].any()
        assert counts[r]["searches"] == 1000
        assert counts[r]["given_up"] == int((whole[t + 500:t + 1500, 0] < 0).sum())
        assert 0 < counts[r]["most_work"] <= EO.FIRST_BUDGET + EO.MATCH_BUDGET + 2
        assert counts[r]["most_steps"] > 0
        assert counts[r]["work"] >= counts[r]["steps"]
    assert counts[1]["given_up"] == 1000 and counts[1]["retries"] == 0  # a long repeat
    # the repeat's measures compare a word a step: a quarter of the bytes and a few steps more
    assert counts[1]["most_steps"] <= counts[1]["most_work"] // 3


def _kernel_measures(s, a, b, limit, p, end, pattern, floor):
    """`csrc/lz4_encode_body.cuh` run_length and `csrc/lz4_hc_body.cuh`
    count_pattern / count_back_pattern written out with their loop
    iterations counted: ((run, iterations) of each)."""
    def w(q):
        return int.from_bytes(s[q:q + 4], "little")

    b0, it = b, 0
    while b + 4 <= limit:
        it += 1
        x = w(a) ^ w(b)
        if x:
            run = b - b0 + ((x & -x).bit_length() - 1) // 8
            break
        a, b = a + 4, b + 4
    else:
        while b < limit:
            it += 1
            if s[a] != s[b]:
                break
            a, b = a + 1, b + 1
        run = b - b0
    out = [(run, it)]
    q, it, pat = p, 0, pattern
    while q + 4 <= end:
        it += 1
        if w(q) != pat:
            break
        q += 4
    while q < end:
        it += 1
        if s[q] != pat & 0xFF:
            break
        q, pat = q + 1, (pat >> 8) | ((pat & 0xFF) << 24)
    out.append((q - p, it))
    q, it, pat = p, 0, pattern
    while q - 4 >= floor:
        it += 1
        if w(q - 4) != pat:
            break
        q -= 4
    while q > floor:
        it += 1
        if s[q - 1] != pat >> 24:
            break
        q, pat = q - 1, ((pat << 8) & 0xFFFFFFFF) | (pat >> 24)
    out.append((p - q, it))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_measure_steps_count_the_kernels_loop_iterations(seed):
    """`encode_hc.measure_steps`, the match pass's dependent steps of one
    measure, equals the kernels' loop iterations on runs of every length
    and room, word-aligned or not (exact)."""
    rng = random.Random(seed)
    for _ in range(400):
        unit = bytes(rng.choice(b"ab") for _ in range(rng.choice((1, 2, 4))))
        s = bytearray((unit * 160)[:160])
        for _ in range(rng.randrange(3)):
            s[rng.randrange(len(s))] = ord("c")
        s = bytes(s)
        room = rng.randrange(-2, 70)
        a = rng.randrange(0, 40)
        b = a + len(unit) * rng.randrange(1, 4)
        p = rng.randrange(8, 150)
        pattern = int.from_bytes((unit * 4)[:4], "little")
        (run, it), (fwd, fit), (back, bit) = _kernel_measures(
            s, a, b, min(b + room, len(s) - 4), p, min(p + room, len(s) - 4), pattern,
            max(0, p - room))
        assert run == EH.run_length(s, a, b, min(b + room, len(s) - 4))
        assert fwd == EH._count_pattern(s, p, min(p + room, len(s) - 4), pattern)
        assert back == EH._count_back_pattern(s, p, pattern, max(0, p - room))
        assert EH.measure_steps(run, min(b + room, len(s) - 4) - b, True) == it
        assert EH.measure_steps(fwd, min(p + room, len(s) - 4) - p) == fit
        assert EH.measure_steps(back, p - max(0, p - room)) == bit
