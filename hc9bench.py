#!/usr/bin/env python3
"""The measurements behind the HC passes (levels 3-9): on one card at
level 9, searches kept per episode, the parse by kind of data, and the
parse with every search made on the spot against the serial HC arm; with
``--host``, where the plain parses spend their search time.

    python3 hc9bench.py [--seed 1] [--opt]
    python3 hc9bench.py --host [--seed 0] [--rows 4] [--opt]

Payloads as kernel D's windows: 16 MiB of the bench mix
(`chip_smoke.make_corpus`, the seed chip_smoke.py's level 9 paths use) as
256 independent 64 KB rows and as 256 chained windows, and 64 MiB (seed 0,
chip_smoke.py's `lz4 -9` payload) as 16 independent rows of 4 MiB.  For
each number of slots (`encode_hc_passes.hc_episodes`; 8, 10 and 12 on the 4
MiB rows) each pass's time (CUDA events between the passes, after a warm-up
call on the 64 KB rows) and the output, equal to the serial HC arm's
(timed too); the parse pass's time on each quarter of the rows (the mix's
four kinds of data); and the parse with one slot and a budget of 0 (every
search given up to the parse, which makes it on the spot over the tables)
beside the serial arm on the same rows, which makes the same searches over
its ring (on the 4 MiB rows: their first MiB each, as rows of their
own).  Prints one JSON line per payload, then the card's name and power
limit.  Needs a CUDA card.

``--opt`` on the card: the level 10 and 11 passes (`encode_opt`: chain,
match pass at the level's depth, the parse by rounds) on the 16 MiB mix as
256 independent 64 KB rows and as 256 chained windows (level 11: the
independent rows), each pass's time (CUDA events between the passes,
after a warm-up call), the output equal to the serial OPT arm's (timed
too), and the parse pass's time on each quarter of the rows.  One JSON
line per level and payload, then the card's name and power limit.

``--host`` needs no card: one 64 KB row from each quarter of
`chip_smoke.make_corpus(4 MiB, seed)` (text, records, runs, noise), parsed
by the plain versions (`lz4_tpu_torch.ops.encode_hc`), each search timed on
the host clock.  Level 9 (`encode_hc.hc_parse_row`): the share of the
search time and the count of searches by the search's index in its
episode (0 the first search, 1 the one after it, ...), which sets how many
searches an episode table keeps (`encode_hc_passes.SLOTS`).  Levels 10 and
11 (`encode_hc.opt_parse_row`): the share of the search time in searches
whose minimum length is above 3, which a table of every position's
min-length-3 search (level 12's `encode_opt`) cannot answer.  One JSON line
per level; the shares are of the plain parse's time on the host, not of
any device time.

``--host --opt`` counts, on the same rows at levels 10 and 11, what the
level 10-11 passes do: from the serial plain parse, its searches, those
with a minimum length of 3 or less (which the match pass's table answers),
those above 3, those that find a match, their chain steps, the chain steps
the chain swap's scans read and the bytes the pattern runs measure (each
a dependent read on the card), and the share of its search time above 3;
from the plain passes (`encode_opt.opt_chain_plain`, `opt_matches_plain`
at the level's depth with level 12's work budgets, then
`opt_parse_spec_plain` at 32 lanes, its bytes held to the serial parse's),
the match pass's given-up entries and the parse's counts: its rounds
(every window end a barrier), those in which a lane searched on the spot,
its table reads, the searches it makes on the spot (the lanes past a
round's first match included), its dependent steps (a round's longest
walk among the lanes it commits, at least one, and one per window-start
read), the count that sets the pass's step bound, and the same with every
lane of a round counted (`speculative_steps`).  One JSON
line per level.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SLOTS = (1, 2, 4, 8, 10, 12)
BIG_SLOTS = (8, 10, 12)


def _windows(cs, data: bytes, block: int, chained: bool):
    import torch

    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    if chained:
        return (payload, *cs.chained_windows(len(data), block))
    nb = len(data) // block
    return (payload, torch.arange(nb, dtype=torch.int64) * block,
            torch.zeros(nb, dtype=torch.int32), torch.full((nb,), block, dtype=torch.int32))


def _passes_ms(base, st, so, ln, block, **kw):
    """Each pass's time (CUDA events between them) and the output."""
    import torch
    from lz4_tpu_torch.ops import encode_hc_passes as hp
    from lz4_tpu_torch.ops import encode_opt

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    prev = encode_opt.opt_chain(base, st, ln)
    ev[1].record()
    tables = hp.hc_episodes(base, st, so, ln, prev, 256, **kw)
    ev[2].record()
    got = hp.hc_parse(base, st, so, ln, prev, tables, block, 256)
    ev[3].record()
    torch.cuda.synchronize()
    names = ("opt_chain", "hc_episodes", "hc_parse")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}, got


def _on_the_spot(cs, base, st, so, ln, block: int) -> dict:
    """The passes with every search made on the spot by the parse, and the
    serial arm, on the same rows."""
    from lz4_tpu_torch.ops import encode_stream

    def serial():
        return encode_stream.encode_windows_hc_serial(base, st, so, ln, block, 9)

    ms, got = _passes_ms(base, st, so, ln, block, slots=1, budget=0, first_budget=0)
    cs._require(cs._max_abs_err(got, serial()) == 0,
                "every search on the spot: the passes' output != the serial arm's")
    return {"passes_ms": ms, "serial_ms": cs._cuda_ms(serial, 1)}


def _report(cs, base, st, so, ln, block: int, dev) -> dict:
    import torch
    from lz4_tpu_torch.ops import encode_stream

    base = base.to(dev)
    big = block > 1 << 16
    serial = encode_stream.encode_windows_hc_serial(base, st, so, ln, block, 9)
    out = {"serial_ms": cs._cuda_ms(lambda: encode_stream.encode_windows_hc_serial(
        base, st, so, ln, block, 9), 1), "slots": {}}
    for k in BIG_SLOTS if big else SLOTS:
        if not big:
            _passes_ms(base, st, so, ln, block, slots=k)  # warm
        ms, got = _passes_ms(base, st, so, ln, block, slots=k)
        cs._require(cs._max_abs_err(got, serial) == 0,
                    f"{k} slots: the passes' output != the serial arm's")
        out["slots"][k] = ms
    cut = min(block, 1 << 20)
    out["every_search_on_the_spot"] = {"row_bytes": cut, **_on_the_spot(
        cs, base, st, so, torch.minimum(ln, so + cut), cut)}
    nb = st.numel()
    out["parse_ms_by_quarter"] = []
    for q in range(4):
        rows = slice(q * nb // 4, (q + 1) * nb // 4)
        ms, _ = _passes_ms(base, st[rows], so[rows], ln[rows], block)
        out["parse_ms_by_quarter"].append(ms["hc_parse"])
    out["compressed_bytes"] = int(serial[1].sum())
    torch.cuda.synchronize()
    return out


def _opt_report(cs, base, st, so, ln, block: int, level: int, dev) -> dict:
    """``--opt``: the level 10-11 passes against the serial OPT arm."""
    import torch
    from lz4_tpu_torch.ops import encode_stream

    base = base.to(dev)

    def serial():
        return encode_stream.encode_windows_opt_serial(base, st, so, ln, block, level)

    want = serial()
    cs.opt_pass_ms(base, st, so, ln, block, level, iters=1)  # warm
    ms, got = cs.opt_pass_ms(base, st, so, ln, block, level, iters=1)
    cs._require(cs._max_abs_err(got, want) == 0,
                f"level {level}: the passes' output != the serial OPT arm's")
    nb = st.numel()
    quarters = []
    for q in range(4):
        rows = slice(q * nb // 4, (q + 1) * nb // 4)
        quarters.append(cs.opt_pass_ms(base, st[rows], so[rows], ln[rows], block, level,
                                       iters=1)[0]["opt_parse_spec"])
    torch.cuda.synchronize()
    return {"level": level, "pass_ms": ms, "passes_ms": sum(ms.values()),
            "serial_ms": cs._cuda_ms(serial, 1), "parse_ms_by_quarter": quarters,
            "compressed_bytes": int(want[1].sum())}


def _hc_by_index(s: bytes) -> dict:
    """The plain level 9 parse of ``s``: each search index's count and
    host seconds."""
    from lz4_tpu_torch.constants import LAST_LITERALS
    from lz4_tpu_torch.ops import encode_hc

    finder = encode_hc.ChainFinder(s, len(s) - LAST_LITERALS, 256)
    seconds, counts = {}, {}
    index = [0]

    def search(ip, ilow, longest):
        t0 = time.perf_counter()
        got = finder.wider_match(ip, ilow, longest, True)
        j = index[0]
        index[0] += 1
        seconds[j] = seconds.get(j, 0.0) + time.perf_counter() - t0
        counts[j] = counts.get(j, 0) + 1
        return got

    def episode_search(ip):
        index[0] = 0
        return search

    encode_hc.hc_parse_row(s, 0, episode_search)
    total = sum(seconds.values())
    return {str(j): {"searches": counts[j], "seconds": seconds[j],
                     "time_share": seconds[j] / total} for j in sorted(seconds)}


def _opt_by_min_length(s: bytes, level: int) -> dict:
    """The plain level 10-11 parse of ``s``: the searches and host seconds
    at minimum length 3 and above it."""
    from lz4_tpu_torch.constants import LAST_LITERALS
    from lz4_tpu_torch.ops import encode_hc

    _, searches, sufficient, full = encode_hc.level_arm(level)
    finder = encode_hc.ChainFinder(s, len(s) - LAST_LITERALS, searches)
    seconds = {"min_3": 0.0, "above_3": 0.0}
    counts = dict.fromkeys(seconds, 0)

    def find(p, min_len):
        t0 = time.perf_counter()
        ln, _, mp = finder.wider_match(p, p, min_len, True, True)
        kind = "min_3" if min_len <= 3 else "above_3"
        seconds[kind] += time.perf_counter() - t0
        counts[kind] += 1
        return (ln, p - mp) if ln > min_len and mp >= 0 else (0, 0)

    encode_hc.opt_parse_row(s, 0, find, sufficient, full)
    total = sum(seconds.values())
    return {"searches": counts, "seconds": seconds,
            "time_share_above_3": seconds["above_3"] / total}


def _opt_rounds(s: bytes, level: int) -> dict:
    """The serial plain level 10-11 parse's searches and the plain passes'
    counts (``--opt``)."""
    import torch
    from lz4_tpu_torch.constants import LAST_LITERALS
    from lz4_tpu_torch.ops import encode_hc, encode_opt

    _, searches, sufficient, full = encode_hc.level_arm(level)
    finder = encode_hc.ChainFinder(s, len(s) - LAST_LITERALS, searches)
    serial = {"searches": 0, "min_3": 0, "above_3": 0, "found": 0}
    seconds = {"min_3": 0.0, "above_3": 0.0}

    def find(p, min_len):
        t0 = time.perf_counter()
        ln, _, mp = finder.wider_match(p, p, min_len, True, True)
        kind = "min_3" if min_len <= 3 else "above_3"
        seconds[kind] += time.perf_counter() - t0
        got = (ln, p - mp) if ln > min_len and mp >= 0 else (0, 0)
        serial["searches"] += 1
        serial[kind] += 1
        serial["found"] += got[0] != 0
        return got

    want = encode_hc.opt_parse_row(s, 0, find, sufficient, full)
    serial.update(steps=finder.steps, swap_reads=finder.swap_reads,
                  pattern_bytes=finder.pattern_bytes)
    base = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    row = (base, [0], [0], [len(s)])
    prev = encode_opt.opt_chain_plain(base, [0], [len(s)])
    matches = encode_opt.opt_matches_plain(*row, prev, searches)
    counts = []
    out, clens, _ = encode_opt.opt_parse_spec_plain(*row, prev, matches, len(s), searches,
                                                    sufficient, 32, counts)
    assert out[0, :int(clens[0])].numpy().tobytes() == bytes(want), (
        "the parse by rounds != the serial parse")
    return {"serial": serial, "search_seconds": seconds,
            "time_share_above_3": seconds["above_3"] / sum(seconds.values()),
            "given_up": int((matches[:, 0] < 0).sum()), "rounds": counts[0]}


def opt_split(rows, kinds) -> None:
    """``--host --opt``: one JSON line each for levels 10 and 11."""
    for level in (10, 11):
        by_row = {kinds[q]: _opt_rounds(s, level) for q, s in enumerate(rows)}
        above = sum(r["search_seconds"]["above_3"] for r in by_row.values())
        total = sum(sum(r["search_seconds"].values()) for r in by_row.values())
        print(json.dumps({"level": level, "time_share_above_3": above / total,
                          "most_steps": max(r["rounds"]["steps"] for r in by_row.values()),
                          "most_speculative_steps": max(r["rounds"]["speculative_steps"]
                                                        for r in by_row.values()),
                          "by_row": by_row}), flush=True)


def search_split(seed: int, nrows: int, opt: bool = False) -> None:
    """``--host``: one JSON line for level 9 and one each for 10 and 11
    (``opt``: `opt_split`'s lines instead)."""
    import chip_smoke

    data = chip_smoke.make_corpus(4 << 20, seed)
    quarter = len(data) // 4
    rows = [data[q * quarter + 12345:q * quarter + 12345 + 65536] for q in range(nrows)]
    kinds = ("text", "records", "runs", "noise")
    if opt:
        opt_split(rows, kinds)
        return
    by_row = {kinds[q]: _hc_by_index(s) for q, s in enumerate(rows)}
    total = sum(v["seconds"] for r in by_row.values() for v in r.values())
    kept = {}  # the share of all rows' search time in the first k searches
    for k in (1, 2, 4, 8, 12, 16):
        kept[k] = sum(v["seconds"] for r in by_row.values() for j, v in r.items()
                      if int(j) < k) / total
    print(json.dumps({"level": 9, "share_in_first_k_searches": kept,
                      "by_search_index": by_row}), flush=True)
    for level in (10, 11):
        by_row = {kinds[q]: _opt_by_min_length(s, level) for q, s in enumerate(rows)}
        above = sum(r["seconds"]["above_3"] for r in by_row.values())
        total = sum(sum(r["seconds"].values()) for r in by_row.values())
        print(json.dumps({"level": level, "time_share_above_3": above / total,
                          "by_min_length": by_row}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=None,
                    help="the corpus seed (default 1 on the card, 0 with --host)")
    ap.add_argument("--host", action="store_true",
                    help="the plain parses' search split on the host (no card)")
    ap.add_argument("--rows", type=int, default=4,
                    help="--host: quarters of the corpus to parse, in order")
    ap.add_argument("--opt", action="store_true",
                    help="the level 10-11 passes (--host: their rounds and searches)")
    args = ap.parse_args(argv)
    if args.host:
        search_split(0 if args.seed is None else args.seed, args.rows, args.opt)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("hc9bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    mix = cs.make_corpus(16 << 20, 1 if args.seed is None else args.seed)
    if args.opt:
        for level, name, chained in ((10, "mix_independent", False),
                                     (10, "mix_chained", True),
                                     (11, "mix_independent", False)):
            print(json.dumps({"payload": name, **_opt_report(
                cs, *_windows(cs, mix, 1 << 16, chained), 1 << 16, level, dev)}), flush=True)
        print(cs.card_line())
        return 0
    for name, data, block, chained in (
        ("mix_independent", mix, 1 << 16, False), ("mix_chained", mix, 1 << 16, True),
        ("lz4_9_rows", cs.make_corpus(64 << 20, 0), 4 << 20, False),
    ):
        report = {"payload": name,
                  **_report(cs, *_windows(cs, data, block, chained), block, dev)}
        print(json.dumps(report), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
