"""The level 3-11 parses by segments (`lz4_tpu_torch/ops/parse_segments.py`,
the model of `csrc/parse_segments.cuh`): each row's parse cut into
segments walked at once from guessed states, each linked to the walk
before where their states meet, the others walked again.  The two models,
`encode_hc_passes.hc_parse_segments_plain` (levels 3-9) and
`encode_opt.opt_parse_segments_plain` (levels 10-11), give the bytes of the
serial plain parses (`encode_hc.encode_hc`, `encode_opt`, whose loops are
`hc_parse_row` and `opt_parse_row`) and of the JAX package's host route,
block by block and in whole frames, at segments of 1-4 KB on rows of
1-16 KB: text, records, runs, noise, random bytes (no match: every walk
after the first starts with a wrong anchor and emits nothing), a chained
window after its prefix,
rows shorter than one segment, segment boundaries inside a long repeat
and inside a match longer than `sufficient`, and overlaps too short to
meet (walked again, in rounds and in the serial tail).  Every link is made
where the join rule holds: an OPT state where ip == anchor, an HC state
whose frontier is at its ip.  The HC walks make every search on the
spot over prev and the deltas, none measuring past its stop but from an
exact start; both models' tables are made once a row and kept.  Four MiB
of zeros are parsed by segments of 1 and 2 MiB."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from lz4_tpu import frame as jframe
from lz4_tpu.block import api as jblock
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.ops import encode_hc as EH
from lz4_tpu_torch.ops import encode_hc_passes as HP
from lz4_tpu_torch.ops import encode_opt as EO
from lz4_tpu_torch.ops import encode_stream as ES
from lz4_tpu_torch.ops import parse_segments as PS

MIX = chip_smoke.make_corpus(1 << 20, 3)
Q = len(MIX) // 4


def _quarter(k: int, n: int, at: int = 5000) -> bytes:
    return MIX[k * Q + at:k * Q + at + n]


def _repeat_row() -> bytes:
    """Text, then 3,000 zeros across the first 2,048-position boundary,
    then text."""
    return _quarter(0, 1000) + bytes(3000) + _quarter(0, 2000, 9000)


def _long_match_row() -> bytes:
    """Text whose bytes [1,900, 2,500) repeat [200, 800) of it: a 600-byte
    match (longer than level 10's and 11's `sufficient`) across the first
    2,048-position boundary."""
    t = _quarter(0, 8000)
    return t[:1800] + _quarter(3, 100) + t[200:800] + t[3000:5500]


def _planted() -> bytes:
    """Random bytes with a 24-byte repeat every ~2,300 positions: free
    walks (no window) next to walks that open one."""
    row = bytearray(np.random.default_rng(6).integers(0, 256, 12000, dtype=np.uint8))
    for at in range(2500, 12000 - 24, 2300):
        row[at:at + 24] = row[at - 1900:at - 1876]
    return bytes(row)


ROWS = {  # name: (prefix, block)
    "text": (b"", _quarter(0, 16384)),
    "records": (b"", _quarter(1, 12288)),
    "runs": (b"", _quarter(2, 16384)),
    "noise": (b"", _quarter(3, 16384)),
    "random": (b"", bytes(np.random.default_rng(5).integers(0, 256, 9000, dtype=np.uint8))),
    "random_with_matches": (b"", _planted()),
    "chained": (_quarter(0, 4096, 40000), _quarter(0, 12288, 44096)),
    "repeat": (b"", _repeat_row()),
    "long_match": (b"", _long_match_row()),
    "shorter_than_a_segment": (b"", _quarter(1, 1500)),
    "13_bytes": (b"", _quarter(0, 13)),
    "12_bytes": (b"", _quarter(0, 12)),
}
# (segment, overlap) of the cases; the last is too short to meet
SIZES = [(1024, 256), (4096, 1024), (2048, 4)]


def _window(name):
    prefix, block = ROWS[name]
    base = torch.frombuffer(bytearray(prefix + block or b"\0"), dtype=torch.uint8)
    return base, [0], [len(prefix)], [len(prefix) + len(block)]


def _bytes(res) -> bytes:
    out, clens, errs = res
    assert not errs.any()
    return out[0, :int(clens[0])].numpy().tobytes()


@functools.lru_cache(maxsize=None)
def _hc_tables(name: str, level: int):
    base, st, so, ln = _window(name)
    prev = EO.opt_chain(base, st, ln)
    return prev, HP.hc_deltas(prev, ln)


@functools.lru_cache(maxsize=None)
def _opt_tables(name: str, level: int):
    base, st, so, ln = _window(name)
    prev = EO.opt_chain(base, st, ln)
    return prev, EO.opt_matches(base, st, so, ln, prev, EH.level_arm(level)[1])


def _hc_model(name, level, segment, overlap, max_rounds=EO.SEGMENT_ROUNDS):
    base, st, so, ln = _window(name)
    prev, deltas = _hc_tables(name, level)
    counts = []
    got = HP.hc_parse_segments_plain(base, st, so, ln, prev, deltas, max(ln[0] - so[0], 1),
                                     EH.level_arm(level)[1], segment, overlap, max_rounds,
                                     counts)
    return _bytes(got), counts[0]


def _opt_model(name, level, segment, overlap, max_rounds=EO.SEGMENT_ROUNDS):
    base, st, so, ln = _window(name)
    prev, matches = _opt_tables(name, level)
    _, depth, sufficient, _ = EH.level_arm(level)
    counts = []
    got = EO.opt_parse_segments_plain(base, st, so, ln, prev, matches, max(ln[0] - so[0], 1),
                                      depth, sufficient, segment, overlap, max_rounds, counts)
    return _bytes(got), counts[0]


@functools.lru_cache(maxsize=None)
def _serial(name: str, level: int) -> bytes:
    prefix, block = ROWS[name]
    return bytes(EH.encode_row(prefix + block, len(prefix), level))


@functools.lru_cache(maxsize=None)
def _host(name: str, level: int) -> bytes:
    prefix, block = ROWS[name]
    return jblock.encode(block, level=level, dictionary=prefix, backend="host")


def _tally_holds(c: dict, max_rounds: int):
    """The tallies count the schedule: every walk in a round or the tail,
    a round only where some segment was walked, the walks after each
    segment's first as rewalks, and one link a kept segment."""
    assert c["rounds"] == len(c["walks_per_round"]) <= max_rounds
    assert all(w > 0 for w in c["walks_per_round"])
    assert sum(c["walks"]) == sum(c["walks_per_round"]) + c["tail_walks"]
    assert c["rewalks"] == sum(c["walks"]) - sum(1 for w in c["walks"] if w)
    assert c["links"] + c["covered"] == c["segments"]
    assert len(c["linked_states"]) + c["start_links"] == max(c["links"] - 1, 0)
    if c["segments"] and max_rounds:
        assert c["walks_per_round"][0] == c["segments"]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}_{s[1]}")
@pytest.mark.parametrize("name", sorted(ROWS))
def test_hc_segments_equal_the_serial_parse_and_the_jax_host(name, size):
    got, c = _hc_model(name, 9, *size)
    assert got == _serial(name, 9) == _host(name, 9)
    _tally_holds(c, EO.SEGMENT_ROUNDS)
    for ip, key, _, _ in c["linked_states"]:
        assert key == ip  # the frontier at ip where a link is made


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}_{s[1]}")
@pytest.mark.parametrize("name", sorted(ROWS))
@pytest.mark.parametrize("level", [10, 11])
def test_opt_segments_equal_the_serial_parse_and_the_jax_host(level, name, size):
    got, c = _opt_model(name, level, *size)
    assert got == _serial(name, level) == _host(name, level)
    _tally_holds(c, EO.SEGMENT_ROUNDS)
    for ip, key, _, anchor in c["linked_states"]:
        assert anchor == ip and key == 0  # a state (ip, anchor) where a sequence ends


@pytest.mark.parametrize("model", ["hc", "opt"])
def test_an_overlap_too_short_walks_again(model):
    """At 4 positions of overlap most links fail: those segments are walked
    again from their predecessors' ends in later rounds (one round: in the
    serial tail), with the same bytes."""
    run = _hc_model if model == "hc" else _opt_model
    level = 9 if model == "hc" else 10
    want = _serial("text", level)
    many, c = run("text", level, 2048, 4)
    assert many == want and c["rewalks"] > 0 and c["rounds"] >= 2
    one, c1 = run("text", level, 2048, 4, max_rounds=1)
    assert one == want and c1["rounds"] == 1 and c1["tail_walks"] == c1["rewalks"] > 0
    _tally_holds(c, EO.SEGMENT_ROUNDS)
    _tally_holds(c1, 1)
    wide, c2 = run("text", level, 2048, 1024)
    assert wide == want and c2["rewalks"] == 0 and c2["rounds"] == 1


@pytest.mark.parametrize("level", [10, 11])
def test_a_walk_with_no_window_links_at_its_start(level):
    """On bytes with no match an OPT walk opens no window, so it reads no
    anchor: after one round of walks from the ends before, each links at
    its start with the anchor replaced, and no segment is left to the
    tail (without that rule one segment would settle a round)."""
    got, c = _opt_model("random", level, 1024, 256, max_rounds=2)
    assert got == _serial("random", level)
    assert c["rounds"] == 2 and c["tail_walks"] == 0
    assert c["free_links"] == c["segments"] - 2 > 0
    _tally_holds(c, 2)
    # walks that open a window among free ones link at a start that is
    # their predecessor's effective end, not its end (whose anchor a free
    # walk only guessed): the schedule ends, with the serial bytes
    for rounds in (0, 1, 2, 8):
        got, c = _opt_model("random_with_matches", level, 1024, 256, max_rounds=rounds)
        assert got == _serial("random_with_matches", level)
        _tally_holds(c, rounds)


@pytest.mark.parametrize("model", ["hc", "opt"])
def test_no_round_is_the_serial_schedule(model):
    """With no round, the tail walks every segment one after another, each
    from its predecessor's end: the serial parse, cut where it links."""
    run = _hc_model if model == "hc" else _opt_model
    level = 9 if model == "hc" else 11
    got, c = run("records", level, 1024, 256, max_rounds=0)
    assert got == _serial("records", level)
    assert c["rounds"] == 0 and c["tail_walks"] == c["segments"] == sum(c["walks"])
    assert c["rewalks"] == 0
    _tally_holds(c, 0)


def test_steps_are_the_rounds_and_the_tail():
    """The schedule's dependent steps: each round's slowest walk and merge
    plus a step a segment, so one round of many segments takes fewer than
    the serial schedule's walks one after another."""
    _, c = _opt_model("text", 10, 2048, 512)
    _, serial = _opt_model("text", 10, 2048, 512, max_rounds=0)
    assert c["rounds"] == 1 and c["steps"] >= max(c["walk_steps"])
    assert serial["steps"] >= sum(serial["walk_steps"]) > 3 * c["steps"]


@pytest.mark.parametrize("level", [9, 10, 11])
def test_frames_of_the_models_equal_the_jax_host_route(level, monkeypatch):
    """Whole frames with the parse by segments on the CPU route (1,024
    positions a segment) and a content checksum: the JAX host route's
    bytes."""
    data = _quarter(0, 9000, 70000) + _quarter(1, 3000, 70000)
    serial = ES.encode_windows_plain

    def route(base, st, so, ln, bcap, lv=0, *args):
        arm, depth, sufficient, _ = EH.level_arm(lv)
        prev = EO.opt_chain(base, st, ln)
        if arm == "hc":
            return HP.hc_parse_segments_plain(base, st, so, ln, prev, HP.hc_deltas(prev, ln),
                                              bcap, depth, 1024, 256)
        matches = EO.opt_matches(base, st, so, ln, prev, depth)
        return EO.opt_parse_segments_plain(base, st, so, ln, prev, matches, bcap, depth,
                                           sufficient, 1024, 256)

    monkeypatch.setattr(ES, "encode_windows_plain", route)
    kw = dict(compression_level=level, content_checksum=True)
    ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    monkeypatch.setattr(ES, "encode_windows_plain", serial)
    assert ours == jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
    assert tframe.decompress(ours, device="cpu") == data


@pytest.mark.parametrize("segment", [1 << 20, 1 << 21])
def test_hc_segments_over_4_mib_of_zeros(segment):
    """Four MiB of zeros at level 9 by segments of ``segment``: every
    walk's measures stop a segment past its stop, so where that cap lies
    inside the row, the first walk ends in the first round where the
    repeat's match begins, and in the second the second segment's walk,
    from the first's end (an exact start), measures the match in full and
    covers the row; else the first walk covers it in the first round.  The
    serial parse's bytes."""
    n = 4 << 20
    base = torch.zeros(n, dtype=torch.uint8)
    prev = EO.opt_chain(base, [0], [n])
    counts = []
    got = HP.hc_parse_segments_plain(base, [0], [0], [n], prev, HP.hc_deltas(prev, [n]), n,
                                     256, segment, 256, counts=counts)
    assert _bytes(got) == bytes(EH.encode_row(bytes(n), 0, 9))
    c = counts[0]
    capped = 2 * segment + 256 < n - 5  # the first walk's cap inside the row
    assert c["rounds"] == 1 + capped and c["start_links"] == capped
    assert c["covered"] == c["segments"] - 1 - capped == n // segment - 1 - capped
    assert c["tail_walks"] == 0
    _tally_holds(c, EO.SEGMENT_ROUNDS)


def test_segments_and_capacities_are_the_sources():
    """`HC_SEGMENT`, `HC_OVERLAP`, `OPT_SEGMENT` and `OPT_OVERLAP` restate
    the kernels' constants; the models' capacities are the kernels'."""
    csrc = Path(EO.__file__).with_name("csrc")
    src = (csrc / "parse_segments.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kHcSegment"), const("kHcOverlap")) == (HP.HC_SEGMENT, HP.HC_OVERLAP)
    assert (const("kOptSegment"), const("kOptOverlap")) == (EO.OPT_SEGMENT, EO.OPT_OVERLAP)
    opt = (csrc / "encode_opt.cu").read_text()
    hc = (csrc / "encode_hc_passes.cu").read_text()
    assert "return overlap / 4 + 2;" in opt and "return overlap + 2;" in hc
    assert "return (segment + overlap + kOptNum) / 4 + 2;" in opt
    assert "return (segment + overlap) / 4 + 258;" in hc
    assert EO.opt_segment_caps(16384, 2048) == (514, 514, (16384 + 2048 + 4096) // 4 + 2)
    assert HP.hc_segment_caps(512, 128) == (130, 130, (512 + 128) // 4 + 258)


@pytest.mark.parametrize("segment", [1024, 16384])
def test_segment_rows(segment):
    """A launch's segments: ceil((n - 12 - src_off + 1) / segment) a row, at
    least one (a block of 12 bytes or fewer has no parse position)."""
    so, ln = [0, 0, 100, 65536, 7], [70000, 12, 20000, 65536 + 4096, 19]
    segoff, seg_row = EO.segment_rows(so, ln, segment)
    want = [max(1, PS.segment_count(o, n, segment)) for o, n in zip(so, ln)]
    assert segoff.tolist() == [sum(want[:r]) for r in range(len(ln) + 1)]
    assert seg_row.tolist() == [r for r, k in enumerate(want) for _ in range(k)]
    assert PS.segment_count(0, 12, segment) == 0 and PS.segment_count(0, 13, segment) == 1
    assert PS.segment_count(0, 11 + segment, segment) == 1
    assert PS.segment_count(0, 12 + segment, segment) == 2


def test_the_cpu_route_is_the_plain_parse_and_launches_nothing():
    """On the CPU the wrappers run the plain parses, whatever the segment
    arguments, and count no launch; they refuse sizes the kernels cannot
    take."""
    base, st, so, ln = _window("text")
    prev, deltas = _hc_tables("text", 9)
    _, matches = _opt_tables("text", 10)
    launches = HP.hc_parse.launches, EO.opt_parse_spec.launches
    n = ln[0]
    assert _bytes(HP.hc_parse(base, st, so, ln, prev, deltas, n, 256, 1024, 8, 2)) == \
        _serial("text", 9)
    assert _bytes(EO.opt_parse_spec(base, st, so, ln, prev, matches, n, 96, 64, 1024, 8, 2)) == \
        _serial("text", 10)
    assert (HP.hc_parse.launches, EO.opt_parse_spec.launches) == launches
    with pytest.raises(ValueError):
        EO.opt_parse_spec(base, st, so, ln, prev, matches, n, 96, 64, 8)
    with pytest.raises(ValueError):
        HP.hc_parse(base, st, so, ln, prev, deltas, n, 256, 1024, -1)
