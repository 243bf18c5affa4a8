"""The chain pass by segments (`encode_opt.opt_chain_segments_plain`, the
model of `csrc/encode_opt.cu`'s `opt_chain_walk` and `opt_chain_join`):
each row cut into segments walked alone, a position first of its hash in
its segment joined to the nearest earlier segment that holds the hash.
Held to the plain chain (`opt_chain_plain`, a stable sort per row) and to
the JAX package's own chain, `lz4_tpu.block.hostref._ChainFinder` walked
in position order, at segment sizes from 32 positions to 65,536, on rows
whose repeats and lengths sit at the segment boundaries."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from lz4_tpu.block import hostref
from lz4_tpu_torch.ops import encode_hc_passes as HP
from lz4_tpu_torch.ops import encode_opt as EO

SEGMENTS = sorted({32, 4096, 16384, EO.CHAIN_SEGMENT, 65536})
CORPUS = chip_smoke.make_corpus(1 << 20, 15)
ROW = 70000  # past the first segment boundary at every size but 65,536's second


def _noise(n, seed=1):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _straddled(n):
    """Noise with one 40-byte snippet copied across every multiple of 32
    positions (so across every segment boundary of every size): each copy
    starts 20 bytes before the boundary."""
    row = bytearray(_noise(n, 2))
    snippet = _noise(40, 3)
    for b in range(32, n - 20, 32):
        row[b - 20:b + 20] = snippet
    return bytes(row)


def _mix_rows():
    """40 KB from each quarter of the bench mix: text, records, runs, noise."""
    q = len(CORPUS) // 4
    return [CORPUS[k * q + 1000:k * q + 41000] for k in range(4)]


ROWS = {
    "bench_mix": _mix_rows,
    "zeros": lambda: [b"\x00" * ROW],
    "noise": lambda: [_noise(ROW)],
    "straddled": lambda: [_straddled(140000)],
    "short": lambda: [CORPUS[100:100 + n] for n in range(8)],
    "chained_window": lambda: [CORPUS[200000:200000 + 65536 + 65536]],
}


def _batch(rows, lead=3):
    """The rows back to back in one tensor, the first ``lead`` bytes
    before them (rows start at odd offsets)."""
    blob = b"\x07" * lead + b"".join(rows)
    starts = (lead + np.cumsum([0] + [len(r) for r in rows[:-1]])).tolist()
    return torch.frombuffer(bytearray(blob or b"\0"), dtype=torch.uint8), starts, \
        [len(r) for r in rows]


def _boundary_rows(segment):
    """Rows whose n - 3 lies just before, at and just after the end of the
    first segment, and at the end of the second."""
    return [CORPUS[300000:300000 + n] for n in (segment + 2, segment + 3, segment + 4,
                                                2 * segment + 3)]


@functools.lru_cache(maxsize=None)
def _finder_chain(row: bytes) -> list:
    """prev of every position by the JAX package's `_ChainFinder`: the head
    of p's hash just before p is inserted (-1 read as HC_EMPTY), HC_EMPTY
    for the positions it never inserts."""
    f = hostref._ChainFinder(row, len(row) - 5, 16)
    out = []
    for p in range(len(row)):
        if p < f.max_insert:
            h = f.head[hostref._hash5_hc(hostref._read4(row, p))]
            out.append(h if h >= 0 else EO.HC_EMPTY)
            f.insert_upto(p + 1)
        else:
            out.append(EO.HC_EMPTY)
    return out


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("name", sorted(ROWS) + ["boundaries"])
def test_segments_equal_the_plain_chain(name, segment):
    rows = _boundary_rows(segment) if name == "boundaries" else ROWS[name]()
    base, st, ln = _batch(rows)
    got = EO.opt_chain_segments_plain(base, st, ln, segment)
    assert torch.equal(got, EO.opt_chain_plain(base, st, ln))


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("name", sorted(ROWS) + ["boundaries"])
def test_segments_equal_the_jax_chain_finder(name, segment):
    rows = _boundary_rows(segment) if name == "boundaries" else ROWS[name]()
    base, st, ln = _batch(rows)
    got = EO.opt_chain_segments_plain(base, st, ln, segment).tolist()
    at = 0
    for row in rows:
        assert got[at:at + len(row)] == _finder_chain(row)
        at += len(row)


@pytest.mark.parametrize("segment", SEGMENTS)
def test_segment_counts(segment):
    """The model's tally: the longest segment's 32-position steps plus the
    segment count, and the positions the join writes (first of their hash
    in their segment, the hash in an earlier segment), counted again
    here."""
    rows = ROWS["bench_mix"]() + ROWS["zeros"]() + ROWS["short"]()
    base, st, ln = _batch(rows)
    counts = []
    EO.opt_chain_segments_plain(base, st, ln, segment, counts)
    assert len(counts) == len(rows)
    for row, c in zip(rows, counts):
        n = len(row)
        assert (c["walk_steps"], c["segments"]) == EO.chain_steps(n, segment)
        assert c["segments"] == -(-n // segment)
        assert c["walk_steps"] == -(-min(n, segment) // 32)
        assert c["steps"] == c["walk_steps"] + c["segments"]
        hashes = [hostref._hash5_hc(hostref._read4(row, p)) for p in range(max(0, n - 3))]
        held = [set(hashes[k * segment:(k + 1) * segment]) for k in range(c["segments"])]
        seen, joined = set(), 0
        for k in range(c["segments"]):
            joined += len(held[k] & seen)
            seen |= held[k]
        assert c["joined"] == joined
    zeros = counts[len(ROWS["bench_mix"]())]
    assert zeros["joined"] == max(0, zeros["segments"] - 1)  # one hash, once a segment


@pytest.mark.parametrize("segment", [0, 16, 48, 1 << 17])
def test_segments_refuse_other_sizes(segment):
    base, st, ln = _batch([CORPUS[:100]])
    with pytest.raises(ValueError):
        EO.opt_chain_segments_plain(base, st, ln, segment)


def test_chain_segment_is_the_sources():
    """`CHAIN_SEGMENT` restates the kernel's default kChainSegment, a power
    of two of at most 32,768 (its u16 head entries keep 0xFFFF for none)."""
    src = (Path(EO.__file__).with_name("csrc") / "encode_opt.cu").read_text()
    assert int(re.search(r"#define LZ4T_CHAIN_SEGMENT (\d+)", src).group(1)) == EO.CHAIN_SEGMENT
    assert EO.CHAIN_SEGMENT & (EO.CHAIN_SEGMENT - 1) == 0 and 32 <= EO.CHAIN_SEGMENT <= 32768
    assert EO.CHAIN_HASHES == 1 << 15


@pytest.mark.parametrize("lens", [[], [0], [5, 16384, 16385, 40000, 0, 4 << 20],
                                  [65536] * 3, [131072, 4 << 20, (4 << 20) + 65536]])
def test_chain_tables_and_scratch(lens):
    """Each segment of a row of more than one has a pair of tables (its
    hashes' last and first positions), 2 bytes a hash each: 8 bytes a
    position on rows of whole segments, as the 64 KB, 128 KB and 4 MiB
    rows are, no more than the match table the scratch is freed for."""
    segoff, tables = EO.chain_tables(lens)
    want = [k if k > 1 else 0 for k in (-(-n // EO.CHAIN_SEGMENT) for n in lens)]
    assert tables == sum(want)
    assert segoff.tolist() == np.cumsum([0] + want[:-1]).tolist()[:len(lens)]
    for n, t in zip(lens, want):
        assert EO.chain_scratch_bytes(n) == t * 4 * EO.CHAIN_HASHES
        if n % EO.CHAIN_SEGMENT == 0:
            assert 4 * n + EO.chain_scratch_bytes(n) <= EO.TABLE_BYTES * n
    # the HC passes group their rows by the same rule, which counts it
    assert HP.row_groups is EO.row_groups


def test_row_groups_count_the_chain_scratch(monkeypatch):
    """A group's budget holds the larger of a row's tables and prev beside
    the chain pass's scratch: at a segment of 32 positions the scratch
    (4,096 bytes a position) sets it."""
    monkeypatch.setattr(EO, "CHAIN_SEGMENT", 32)
    monkeypatch.setattr(EO, "GROUP_TABLE_BYTES", 10 * (4 * 4096 + 128 * 131072))
    assert EO.row_groups([4096] * 25) == [(0, 10), (10, 20), (20, 25)]


def test_opt_chain_on_the_cpu_is_the_plain_chain():
    base, st, ln = _batch(ROWS["bench_mix"]() + ROWS["short"](), lead=1)
    assert torch.equal(EO.opt_chain(base, st, ln), EO.opt_chain_plain(base, st, ln))
