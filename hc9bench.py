#!/usr/bin/env python3
"""The measurements behind the HC passes (levels 3-9): on one card at
level 9, searches kept per episode, the parse by kind of data, and the
parse with every search made on the spot against the serial HC arm; with
``--host``, where the plain parses spend their search time.

    python3 hc9bench.py [--seed 1] [--opt]
    python3 hc9bench.py --host [--seed 0] [--rows 4] [--opt]
    python3 hc9bench.py --parent DIR [--iters 2] [--memory FULL]

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

``--parent DIR`` on the card: the parses of this tree (the parse by
segments, `encode_hc_passes.hc_parse` and `encode_opt.opt_parse_spec`)
against those of the tree DIR (an unpacked commit whose parses are the
one-thread and one-warp row kernels, e.g. `git archive HEAD~1 | tar -x -C
build/parent`), built from its `csrc` with the port's flags, in turns
(parent, this tree, this tree, parent), each a launch of its C entry point
on the same tables already on the card (this tree's chain, episode and
match passes, which the two trees share) timed with CUDA events
(`--iters` launches a turn; one at level 11 on the 4 MiB rows, where the
parent's parse takes ~35 s): levels 9, 10 and 11 on the 64 MiB of 16
rows of 4 MiB (`lz4 -9`/`-10`/`-11`, seed 0), on the 16 MiB of 256
rows of 64 KB (seed 1) and on 64 MiB of random bytes as 16 rows of 4 MiB
(incompressible input: no match, every OPT walk free of its anchor).  Each output equal to the serial arm's
(`encode_stream.encode_windows_hc_serial`, `encode_windows_opt_serial`,
timed once).  This tree's launch counts (`encode_opt.segment_stats`: its
rounds, walks a round, serial tail walks) beside.  One JSON line per
payload and level, then the card's name and power limit.

``--parent DIR --memory FULL`` also reads, for the whole tree FULL (an
unpacked commit, e.g. the parent) and this one, each in a process of its
own with that tree's `chip_smoke.py`, the device memory one compress of
the 64 MiB payload allocates at its peak at `lz4 -9`, `-10` and `-11`
(`chip_smoke._compress_peak`; the parent's `lz4 -11` compress takes ~40
s).  One JSON line per tree.

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
import subprocess
import sys
import time
from pathlib import Path

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


def _parse_launcher(lib_path, level: int, rows, tables, bcap: int, dev, parent: bool):
    """A function that enqueues one level 3-11 parse of a built library on
    the rows (their tables already on the card: prev and `hc_episodes`' or
    `opt_matches`' output), and the (out, clens, errs) it fills: the
    parent's row kernel, or this tree's parse by segments."""
    import ctypes

    import torch
    from lz4_tpu_torch.ops import encode_hc_passes as hp
    from lz4_tpu_torch.ops import encode_opt
    from lz4_tpu_torch.ops.encode import _outputs
    from lz4_tpu_torch.ops.encode_hc import level_arm

    arm, depth, sufficient, _ = level_arm(level)
    base_d, st, so, ln = rows
    prev, table = tables
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    toff, _ = encode_opt.table_offsets(ln)
    soff, _ = hp.slot_offsets(so, ln)
    nb = len(ln)
    out, clens, errs = _outputs(nb, bcap, dev)
    held = [t.to(dev) for t in (st, so, ln, toff, soff)]
    head = [base_d.data_ptr(), *(t.data_ptr() for t in held[:4])]
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = (out.data_ptr(), out.shape[1], out.shape[1], depth)
    if arm == "hc":
        first, more, deltas = table
        fn = lib.lz4t_hc_parse
        args = [*head, held[4].data_ptr(), prev.data_ptr(), first.data_ptr(), more.data_ptr(),
                deltas.data_ptr(), 2 + more.shape[1], *outs, clens.data_ptr(),
                errs.data_ptr(), nb]
        kinds = [p] * 10 + [i, p, ll, i, i, p, p, i]
    else:
        fn = lib.lz4t_opt_parse_spec
        args = [*head, prev.data_ptr(), table.data_ptr(), *outs, sufficient, clens.data_ptr(),
                errs.data_ptr(), nb]
        kinds = [p] * 8 + [ll, i, i, i, p, p, i]
    if not parent:
        segment, overlap = (hp.HC_SEGMENT, hp.HC_OVERLAP) if arm == "hc" else (
            encode_opt.OPT_SEGMENT, encode_opt.OPT_OVERLAP)
        segoff, seg_row = encode_opt.segment_rows(so, ln, segment)
        size = ctypes.c_longlong()
        scratch_of = getattr(lib, f"lz4t_{arm}_seg_scratch")
        scratch_of.argtypes = [ll, i, i, i, p]
        scratch_of(seg_row.numel(), nb, segment, overlap, ctypes.addressof(size))
        stats = torch.empty(encode_opt.SEGMENT_ROUNDS + 4, dtype=torch.int32, device=dev)
        held += [segoff.to(dev), seg_row.to(dev),
                 torch.empty(size.value, dtype=torch.uint8, device=dev), stats]
        args += [held[5].data_ptr(), held[6].data_ptr(), seg_row.numel(), segment, overlap,
                 encode_opt.SEGMENT_ROUNDS, held[7].data_ptr(), stats.data_ptr()]
        kinds += [p, p, i, i, i, i, p, p]
    fn.argtypes = kinds + [p]
    fn.restype = ctypes.c_int

    def run(held=held):  # the arguments' tensors live as long as the launcher
        rc = fn(*args, stream)
        if rc:
            raise RuntimeError(f"{lib_path.name}: CUDA error {rc}")

    return run, (out, clens, errs), (held[-1] if not parent else None)


def parent_turns(cs, parent, iters: int, dev) -> None:
    """``--parent``: one JSON line per payload and level."""
    import numpy as np
    import torch
    from chainbench import _build
    from lz4_tpu_torch.ops import encode_hc_passes as hp
    from lz4_tpu_torch.ops import encode_opt, encode_stream
    from lz4_tpu_torch.ops.build import _library, build
    from lz4_tpu_torch.ops.encode_hc import level_arm

    build("encode_hc_passes", "encode_opt")
    libs = {("new", m): _library(m) for m in ("encode_hc_passes", "encode_opt")}
    built = _build({f"hc9_parent_{m}": (parent / "lz4_tpu_torch" / "ops" / "csrc" / f"{m}.cu", [])
                    for m in ("encode_hc_passes", "encode_opt")})
    libs.update({("parent", m): built[f"hc9_parent_{m}"]
                 for m in ("encode_hc_passes", "encode_opt")})
    noise = np.random.default_rng(2).integers(0, 256, 64 << 20, dtype=np.uint8).tobytes()
    payloads = (("rows_4MiB", cs.make_corpus(64 << 20, 0), 4 << 20),
                ("rows_64KB", cs.make_corpus(16 << 20, 1), 1 << 16),
                ("random_4MiB", noise, 4 << 20))
    for name, data, block in payloads:
        rows = _windows(cs, data, block, False)
        base_d = rows[0].to(dev)
        rows = (base_d, *rows[1:])
        for level in (9, 10, 11):
            arm, depth, _, _ = level_arm(level)
            prev = encode_opt.opt_chain(rows[0], rows[1], rows[3])
            table = (hp.hc_episodes(*rows, prev, depth) if arm == "hc"
                     else encode_opt.opt_matches(*rows, prev, depth))
            module = "encode_hc_passes" if arm == "hc" else "encode_opt"
            runs = {tree: _parse_launcher(libs[(tree, module)], level, rows, (prev, table),
                                          block, dev, tree == "parent")
                    for tree in ("parent", "new")}
            n = 1 if level == 11 and block > 1 << 16 else iters
            times = {"parent": [], "new": []}
            for tree in ("parent", "new", "new", "parent"):
                times[tree].append(cs._cuda_ms(runs[tree][0], n))
            t0 = time.perf_counter()
            serial = (encode_stream.encode_windows_hc_serial if arm == "hc"
                      else encode_stream.encode_windows_opt_serial)(*rows, block, level)
            torch.cuda.synchronize()
            serial_s = time.perf_counter() - t0
            for tree, (_, got, _) in runs.items():
                cs._require(cs._max_abs_err(got, serial) == 0,
                            f"{name} level {level}: the {tree} parse != the serial arm")
            stats = encode_opt.segment_stats(runs["new"][2], encode_opt.SEGMENT_ROUNDS)
            print(json.dumps({
                "payload": name, "rows": len(rows[3]), "level": level, "iters": n,
                "ms": times, "parent_over_new": min(times["parent"]) / min(times["new"]),
                "equal_to_serial": True, "serial_s": serial_s,
                "schedule": {k: stats[k] for k in ("walks_per_round", "rounds", "tail_walks",
                                                   "links", "overflow")}}), flush=True)
            del prev, table, runs


def memory_of(tree: Path) -> dict:
    """In this process, from ``tree``'s own `chip_smoke.py` and package:
    one compress's device-memory peak at `lz4 -9`, `-10` and `-11` over
    chip_smoke.py's 64 MiB payload (seed 0)."""
    import os

    import torch

    os.chdir(tree)
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules if m == "chip_smoke" or m.startswith("lz4_tpu_torch")]:
        del sys.modules[name]
    import chip_smoke as tree_cs

    dev = torch.device("cuda", 0)
    data = tree_cs.make_corpus(64 << 20, 0)
    peaks = {f"lz4_{level}": tree_cs._compress_peak(data, tree_cs._cli_hc(level), dev)[1]
             for level in (9, 10, 11)}
    return {"tree": str(tree), "compress_peak_bytes": peaks,
            "peak_per_payload_byte": {k: v / len(data) for k, v in peaks.items()}}


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
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked tree whose parses to time against this tree's")
    ap.add_argument("--iters", type=int, default=2, help="--parent: launches a turn")
    ap.add_argument("--memory", type=Path, default=None,
                    help="--parent: a whole tree whose compress peaks to read beside this one's")
    ap.add_argument("--memory-of", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.host:
        search_split(0 if args.seed is None else args.seed, args.rows, args.opt)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("hc9bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if args.memory_of is not None:
        print(json.dumps(memory_of(args.memory_of.resolve())))
        return 0
    dev = torch.device("cuda", 0)
    if args.parent is not None:
        parent_turns(cs, args.parent.resolve(), args.iters, dev)
        here = Path(__file__).resolve().parent
        for tree in ([args.memory.resolve(), here] if args.memory is not None else []):
            out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--memory-of",
                                  str(tree)], capture_output=True, text=True)
            cs._require(out.returncode == 0, f"memory of {tree}:\n{out.stderr[-2000:]}")
            print(out.stdout.strip().splitlines()[-1], flush=True)
        print(cs.card_line())
        return 0
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
