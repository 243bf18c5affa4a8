#!/usr/bin/env python3
"""The measurements behind the HC passes (levels 3-9): on one card at
level 9, the passes and the parse by segments at several segment lengths,
by kind of data, against the serial HC arm; with ``--parent``,
against the parent tree's passes; with ``--host``, where the plain parses
spend their search time and what the parse searches against a pass that
searched every position.

    python3 hc9bench.py [--seed 1] [--opt]
    python3 hc9bench.py --host [--seed 0] [--rows 4] [--opt]
    python3 hc9bench.py --parent DIR [--iters 2] [--levels 9,10,11] [--memory FULL]

Payloads as kernel D's windows: 16 MiB of the bench mix
(`chip_smoke.make_corpus`, the seed chip_smoke.py's level 9 paths use) as
256 independent 64 KB rows and as 256 chained windows, 64 MiB (seed 0,
chip_smoke.py's `lz4 -9` payload) as 16 independent rows of 4 MiB, and 64
MiB of random bytes as 16 rows of 4 MiB.  For each: the serial HC arm's
time and output; each pass's time (`chip_smoke.hc_pass_ms`: CUDA events
between the chain pass, `hc_deltas` and `hc_parse`, after a warm-up call)
and output, equal to the serial arm's; the parse alone (CUDA events over
`--iters` calls) at each (segment, overlap) of `SEGMENTS`, its output equal
to the serial arm's and its schedule (`encode_opt.segment_stats`: rounds,
walks a round, serial tail walks) beside; the device time of each of the
parse's kernels at the built segment (torch.profiler); the parse of the
rows in groups of 1, 4, 16 and 64 rows, a launch a group one after
another (whether a group whose tables fit the L2 cache walks faster);
and the parse's time on each quarter of the rows (the mix's four kinds of
data).  Prints one JSON line per payload, then the card's name and power
limit.  Needs a CUDA card.

``--opt`` on the card: the level 10 and 11 passes (`encode_opt`: chain,
match pass at the level's depth, the parse by rounds) on the 16 MiB mix as
256 independent 64 KB rows and as 256 chained windows (level 11: the
independent rows), each pass's time (CUDA events between the passes,
after a warm-up call), the output equal to the serial OPT arm's (timed
too), and the parse pass's time on each quarter of the rows.  One JSON
line per level and payload, then the card's name and power limit.

``--parent DIR`` on the card: this tree's passes after the chain pass
against those of the tree DIR (an unpacked commit, e.g. `git archive
HEAD~1 lz4_tpu_torch/ops/csrc | tar -x -C build/parent`), built from its
`csrc` with the port's flags, in turns (parent, this tree, this tree,
parent), each a launch of the trees' C entry points on the same chain
pass output already on the card, timed with CUDA events (`--iters`
launches a turn; one at level 11 on the 4 MiB rows).  Level 9: the
parent's episode pass and parse (`lz4t_hc_episodes`, `lz4t_hc_parse` over
its episode tables, its own segment and overlap), or this tree's deltas
and parse (`lz4t_hc_deltas`, `lz4t_hc_parse`).  Levels 10 and 11: each
tree's parse by segments (`lz4t_opt_parse_spec`) on this tree's match
pass output.  On the 64 MiB of 16 rows of 4 MiB (`lz4 -9`/`-10`/`-11`,
seed 0), the 16 MiB of 256 rows of 64 KB (seed 1) and 64 MiB of random
bytes as 16 rows of 4 MiB (incompressible input: no match, every walk free
of its anchor).  Each output equal to the serial arm's
(`encode_stream.encode_windows_hc_serial`, `encode_windows_opt_serial`,
timed once).  This tree's launch counts (`encode_opt.segment_stats`)
beside.  One JSON line per payload and level, then the card's name and
power limit.

``--parent DIR --memory FULL`` also reads, for the whole tree FULL (an
unpacked commit, e.g. the parent) and this one, each in a process of its
own with that tree's `chip_smoke.py`, the device memory one compress of
the 64 MiB payload allocates at its peak at `lz4 -9`, `-10` and `-11`
(`chip_smoke._compress_peak`).  One JSON line per tree.

``--host`` needs no card: one 64 KB row from each quarter of
`chip_smoke.make_corpus(4 MiB, seed)` (text, records, runs, noise), parsed
by the plain versions (`lz4_tpu_torch.ops.encode_hc`), each search timed on
the host clock.  Level 9 (`encode_hc.hc_parse_row`): the share of the
search time and the count of searches by the search's index in its
episode (0 the first search, 1 the one after it, ...).  Then, on the first
16 KB of each row, the searches and chain steps the level 9 parse makes
(`encode_hc_passes.hc_parse_plain`, every search on the spot, as the walks
make them) against those of a pass that runs the episode at every block
position (the design the parse by segments replaced: the first `SLOTS`
searches of each episode over the chain table, each under level 12's work
budgets, `encode_opt.FIRST_BUDGET`, `MATCH_BUDGET`, `RETRY_LONGEST`, the
episode stopped at a search given up).  Levels 10 and 11
(`encode_hc.opt_parse_row`): the share of the search time in searches
whose minimum length is above 3, which a table of every position's
min-length-3 search (level 12's `encode_opt`) cannot answer.  One JSON line
per level (level 9: two); the shares are of the plain parse's time on the
host, not of any device time.

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

# the parse's (segment, overlap) pairs timed on each payload
SEGMENTS = ((256, 64), (256, 128), (512, 128), (512, 256), (1024, 256), (4096, 256))
SLOTS = 10  # --host: the searches a position's episode kept in the pass the parse replaced


def _windows(cs, data: bytes, block: int, chained: bool):
    import torch

    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    if chained:
        return (payload, *cs.chained_windows(len(data), block))
    nb = len(data) // block
    return (payload, torch.arange(nb, dtype=torch.int64) * block,
            torch.zeros(nb, dtype=torch.int32), torch.full((nb,), block, dtype=torch.int32))


PARSE_KERNELS = ("hc_seg_walks", "seg_links", "seg_check", "hc_seg_tail", "seg_sizes",
                 "seg_offsets", "seg_write")


def _kernel_ms(fn) -> dict:
    """The device time of one call of ``fn`` by kernel of the parse
    (torch.profiler, after a warm-up call), ms; {} where it recorded no
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        for k in PARSE_KERNELS:
            if k in e.key:
                out[k] = out.get(k, 0.0) + us / 1e3
    return out


def _report(cs, base, st, so, ln, block: int, dev, iters: int) -> dict:
    import torch
    from lz4_tpu_torch.ops import encode_hc_passes as hp
    from lz4_tpu_torch.ops import encode_opt, encode_stream

    base = base.to(dev)

    def serial():
        return encode_stream.encode_windows_hc_serial(base, st, so, ln, block, 9)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = serial()
    torch.cuda.synchronize()
    out = {"serial_ms": (time.perf_counter() - t0) * 1e3}
    cs.hc_pass_ms(base, st, so, ln, block, iters=1)  # warm
    ms, got = cs.hc_pass_ms(base, st, so, ln, block, iters=1)
    cs._require(cs._max_abs_err(got, want) == 0, "the passes' output != the serial arm's")
    out["pass_ms"] = ms
    prev = encode_opt.opt_chain(base, st, ln)
    deltas = hp.hc_deltas(prev, ln)
    toff, _ = encode_opt.table_offsets(ln)
    out["segments"] = []
    for segment, overlap in SEGMENTS:
        def parse(segment=segment, overlap=overlap):
            return hp.hc_parse(base, st, so, ln, prev, deltas, block, 256, segment=segment,
                               overlap=overlap)

        cs._require(cs._max_abs_err(parse(), want) == 0,
                    f"segment {segment}: the parse's output != the serial arm's")
        stats = encode_opt.segment_stats(hp.hc_parse.stats, encode_opt.SEGMENT_ROUNDS)
        ms = cs._cuda_ms(parse, iters)
        cs._require(cs._max_abs_err(parse(), want) == 0,
                    f"segment {segment}, timed: the parse's output != the serial arm's")
        out["segments"].append({"segment": segment, "overlap": overlap, "ms": ms,
                                "schedule": {k: stats[k] for k in (
                                    "walks_per_round", "rounds", "tail_walks", "overflow")}})
    out["parse_kernel_device_ms"] = _kernel_ms(
        lambda: hp.hc_parse(base, st, so, ln, prev, deltas, block, 256))
    nb = st.numel()
    out["parse_ms_in_row_groups"] = {}  # the rows parsed a group at a time, one launch after another
    for rows in sorted({1, 4, 16, 64, nb} & set(range(1, nb + 1))):
        def groups(rows=rows):
            for g in range(0, nb, rows):
                sl = slice(g, g + rows)
                at = slice(int(toff[g]), int(toff[g] + ln[sl].sum()))
                hp.hc_parse(base, st[sl], so[sl], ln[sl], prev[at], deltas[at], block, 256)

        out["parse_ms_in_row_groups"][rows] = cs._cuda_ms(groups, 1)
    out["parse_ms_by_quarter"] = []
    for q in range(4):
        rows = slice(q * nb // 4, (q + 1) * nb // 4)
        ms, _ = cs.hc_pass_ms(base, st[rows], so[rows], ln[rows], block, iters=1)
        out["parse_ms_by_quarter"].append(ms["hc_parse"])
    out["compressed_bytes"] = int(want[1].sum())
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


def _c(lib_path):
    import ctypes

    return ctypes.CDLL(str(lib_path))


def _segment_plan(lib, arm: str, so, ln, segment: int, overlap: int, dev):
    """A parse by segments' segments, scratch and stats on the card, and
    their C arguments (segoff, seg_row, nseg, segment, overlap, rounds,
    scratch, stats)."""
    import ctypes

    import torch
    from lz4_tpu_torch.ops import encode_opt

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    segoff, seg_row = encode_opt.segment_rows(so, ln, segment)
    size = ctypes.c_longlong()
    scratch_of = getattr(lib, f"lz4t_{arm}_seg_scratch")
    scratch_of.argtypes = [ll, i, i, i, p]
    scratch_of(seg_row.numel(), len(ln), segment, overlap, ctypes.addressof(size))
    stats = torch.empty(encode_opt.SEGMENT_ROUNDS + 4, dtype=torch.int32, device=dev)
    held = [segoff.to(dev), seg_row.to(dev), torch.empty(size.value, dtype=torch.uint8,
                                                         device=dev), stats]
    args = [held[0].data_ptr(), held[1].data_ptr(), seg_row.numel(), segment, overlap,
            encode_opt.SEGMENT_ROUNDS, held[2].data_ptr(), stats.data_ptr()]
    return held, args, [p, p, i, i, i, i, p, p]


def _hc_launcher(lib_path, rows, prev, bcap: int, dev, parent: bool = False):
    """A function that enqueues one level 9 HC run of a built library after
    the chain pass (``prev`` already on the card), the (out, clens, errs)
    it fills and its stats: this tree's `lz4t_hc_deltas` and parse over
    them, or (``parent``) the parent's episode pass into its tables
    (`lz4t_hc_episodes`, `SLOTS` searches a position under level 12's
    budgets) and its parse over them; each at its own built segment."""
    import ctypes

    import torch
    from lz4_tpu_torch.ops import encode_opt
    from lz4_tpu_torch.ops.encode import _outputs

    base_d, st, so, ln = rows
    lib = _c(lib_path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    toff, total = encode_opt.table_offsets(ln)
    nb = len(ln)
    out, clens, errs = _outputs(nb, bcap, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    st = torch.as_tensor(st, dtype=torch.int64)
    so, ln = (torch.as_tensor(t, dtype=torch.int32) for t in (so, ln))
    st_d, so_d, ln_d, toff_d = (t.to(dev) for t in (st, so, ln, toff))
    head = [base_d.data_ptr(), st_d.data_ptr(), so_d.data_ptr(), ln_d.data_ptr(),
            toff_d.data_ptr()]
    outs = [out.data_ptr(), out.shape[1], out.shape[1], 256, clens.data_ptr(), errs.data_ptr(),
            nb]
    out_kinds = [p, ll, i, i, p, p, i]
    for fn in (lib.lz4t_hc_segment, lib.lz4t_hc_overlap):
        fn.restype = ctypes.c_int
    plan, plan_args, plan_kinds = _segment_plan(lib, "hc", so, ln, lib.lz4t_hc_segment(),
                                                lib.lz4t_hc_overlap(), dev)
    deltas = torch.empty(total, dtype=torch.int16, device=dev)
    held = [st_d, so_d, ln_d, toff_d, deltas, *plan]
    max_len = int(torch.as_tensor(ln).max())
    if parent:
        blk = torch.as_tensor(ln, dtype=torch.int64) - torch.as_tensor(so, dtype=torch.int64)
        soff = (torch.cumsum(blk, 0) - blk).to(dev)
        first = torch.empty((int(blk.sum()), 4), dtype=torch.int32, device=dev)
        more = torch.empty((int(blk.sum()), SLOTS - 2, 6), dtype=torch.int32, device=dev)
        held += [soff, first, more]
        tables = [soff.data_ptr(), prev.data_ptr(), first.data_ptr(), more.data_ptr(),
                  deltas.data_ptr()]
        lib.lz4t_hc_episodes.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.lz4t_hc_parse.argtypes = [p] * 10 + [i] + out_kinds[:3] + [i, p, p, i] \
            + plan_kinds + [p]
        episodes = [*head, *tables, SLOTS, 256, encode_opt.FIRST_BUDGET, encode_opt.MATCH_BUDGET,
                    encode_opt.RETRY_LONGEST, nb, max_len, stream]
        parse = [*head, *tables, SLOTS, *outs[:3], *outs[3:], *plan_args, stream]
        calls = ((lib.lz4t_hc_episodes, episodes), (lib.lz4t_hc_parse, parse))
    else:
        lib.lz4t_hc_deltas.argtypes = [p, p, p, p, i, i, p]
        lib.lz4t_hc_parse.argtypes = [p] * 7 + out_kinds + plan_kinds + [p]
        calls = ((lib.lz4t_hc_deltas, [ln_d.data_ptr(), toff_d.data_ptr(), prev.data_ptr(),
                                       deltas.data_ptr(), nb, max_len, stream]),
                 (lib.lz4t_hc_parse, [*head, prev.data_ptr(), deltas.data_ptr(), *outs,
                                      *plan_args, stream]))
    for fn, _ in calls:
        fn.restype = ctypes.c_int

    def run(held=held):  # the arguments' tensors live as long as the launcher
        for fn, args in calls:
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{lib_path.name}: CUDA error {rc}")

    return run, (out, clens, errs), plan[-1]


def _opt_launcher(lib_path, level: int, rows, prev, matches, bcap: int, dev):
    """A function that enqueues one level 10-11 parse by segments
    (`lz4t_opt_parse_spec`) of a built library on the rows (prev and the
    match table already on the card), the (out, clens, errs) it fills and
    its stats."""
    import ctypes

    import torch
    from lz4_tpu_torch.ops import encode_opt
    from lz4_tpu_torch.ops.encode import _outputs
    from lz4_tpu_torch.ops.encode_hc import level_arm

    _, depth, sufficient, _ = level_arm(level)
    base_d, st, so, ln = rows
    lib = _c(lib_path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    toff, _ = encode_opt.table_offsets(ln)
    nb = len(ln)
    out, clens, errs = _outputs(nb, bcap, dev)
    held = [torch.as_tensor(t, dtype=d).to(dev) for t, d in (
        (st, torch.int64), (so, torch.int32), (ln, torch.int32), (toff, torch.int64))]
    plan, plan_args, plan_kinds = _segment_plan(lib, "opt", so, ln, encode_opt.OPT_SEGMENT,
                                                encode_opt.OPT_OVERLAP, dev)
    held += plan
    fn = lib.lz4t_opt_parse_spec
    fn.argtypes = [p] * 8 + [ll, i, i, i, p, p, i] + plan_kinds + [p]
    fn.restype = ctypes.c_int
    args = [base_d.data_ptr(), *(t.data_ptr() for t in held[:4]), prev.data_ptr(),
            matches.data_ptr(), out.data_ptr(), out.shape[1], out.shape[1], depth, sufficient,
            clens.data_ptr(), errs.data_ptr(), nb, *plan_args,
            torch.cuda.current_stream(dev).cuda_stream]

    def run(held=held):
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{lib_path.name}: CUDA error {rc}")

    return run, (out, clens, errs), plan[-1]


def parent_turns(cs, parent, iters: int, levels, dev) -> None:
    """``--parent``: one JSON line per payload and level."""
    import numpy as np
    import torch
    from chainbench import _build
    from lz4_tpu_torch.ops import encode_opt, encode_stream
    from lz4_tpu_torch.ops.build import _library, build

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
        prev = encode_opt.opt_chain(rows[0], rows[1], rows[3])
        for level in levels:
            if level == 9:
                runs = {tree: _hc_launcher(libs[(tree, "encode_hc_passes")], rows, prev, block,
                                           dev, tree == "parent")
                        for tree in ("parent", "new")}
                serial_of = encode_stream.encode_windows_hc_serial
            else:
                depth = 96 if level == 10 else 512
                matches = encode_opt.opt_matches(*rows, prev, depth)
                runs = {tree: _opt_launcher(libs[(tree, "encode_opt")], level, rows, prev,
                                            matches, block, dev)
                        for tree in ("parent", "new")}
                serial_of = encode_stream.encode_windows_opt_serial
            n = 1 if level == 11 and block > 1 << 16 else iters
            times = {"parent": [], "new": []}
            for tree in ("parent", "new", "new", "parent"):
                times[tree].append(cs._cuda_ms(runs[tree][0], n))
            t0 = time.perf_counter()
            serial = serial_of(*rows, block, level)
            torch.cuda.synchronize()
            serial_s = time.perf_counter() - t0
            for tree, (_, got, _) in runs.items():
                cs._require(cs._max_abs_err(got, serial) == 0,
                            f"{name} level {level}: the {tree} passes != the serial arm")
            stats = encode_opt.segment_stats(runs["new"][2], encode_opt.SEGMENT_ROUNDS)
            print(json.dumps({
                "payload": name, "rows": len(rows[3]), "level": level, "iters": n,
                "ms": times, "parent_over_new": min(times["parent"]) / min(times["new"]),
                "equal_to_serial": True, "serial_s": serial_s,
                "schedule": {k: stats[k] for k in ("walks_per_round", "rounds", "tail_walks",
                                                   "links", "overflow")}}), flush=True)
            del runs
        del prev


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


class _GaveUp(Exception):
    """A search of the per-position pass gave up, or passed its slots: its
    episode stops there."""


def _pass_counts(s: bytes) -> dict:
    """The searches and chain steps of a pass that runs the episode at
    every block position of ``s`` at level 9 over the chain table, its
    first `SLOTS` searches each under level 12's work budgets (a search
    with no match longer than `RETRY_LONGEST` made again with the large
    budget), the episode stopped at a search given up."""
    import torch
    from lz4_tpu_torch.constants import LAST_LITERALS, MF_LIMIT
    from lz4_tpu_torch.ops import encode_hc, encode_opt

    base = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    prev = encode_opt.opt_chain_plain(base, [0], [len(s)]).tolist()
    finder = encode_opt.TableFinder(s, len(s) - LAST_LITERALS, 256, prev)
    searches = made = 0

    def search(ip, ilow, longest):
        nonlocal made
        if made == SLOTS:
            raise _GaveUp
        made += 1
        finder.budget = encode_opt.FIRST_BUDGET
        got = finder.wider_match(ip, ilow, longest, True)
        if got[0] < 0 and -1 - got[0] <= encode_opt.RETRY_LONGEST:
            finder.budget = encode_opt.MATCH_BUDGET
            got = finder.wider_match(ip, ilow, longest, True)
        if got[0] < 0:
            raise _GaveUp
        return got

    for p in range(len(s) - MF_LIMIT + 1):
        made = 0
        try:
            encode_hc.hc_episode(s, p, p, len(s) - MF_LIMIT, search, None)
        except _GaveUp:
            pass
        searches += made
    return {"searches": searches, "steps": finder.steps}


def parse_against_pass(rows, kinds, cut: int = 16384) -> dict:
    """The level 9 parse's episodes, searches and chain steps on the first
    ``cut`` bytes of each row (`encode_hc_passes.hc_parse_plain`, every
    search on the spot) against `_pass_counts`' on the same bytes."""
    import torch
    from lz4_tpu_torch.ops import encode_hc_passes, encode_opt

    by_row = {}
    for kind, row in zip(kinds, rows):
        s = row[:cut]
        base = torch.frombuffer(bytearray(s), dtype=torch.uint8)
        prev = encode_opt.opt_chain_plain(base, [0], [len(s)])
        counts = []
        encode_hc_passes.hc_parse_plain(base, [0], [0], [len(s)], prev,
                                        encode_hc_passes.deltas_plain(prev, [len(s)]), len(s),
                                        256, counts)
        by_row[kind] = {"parse": counts[0], "pass": _pass_counts(s)}
    total = {side: {k: sum(r[side][k] for r in by_row.values()) for k in ("searches", "steps")}
             for side in ("parse", "pass")}
    return {"level": 9, "row_bytes": cut, "by_row": by_row, "all": total,
            "pass_over_parse_steps": total["pass"]["steps"] / total["parse"]["steps"]}


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
    print(json.dumps(parse_against_pass(rows, kinds)), flush=True)
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
    ap.add_argument("--iters", type=int, default=2, help="launches a timing")
    ap.add_argument("--levels", default="9,10,11", help="--parent: the levels to time")
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
        parent_turns(cs, args.parent.resolve(), args.iters,
                     [int(x) for x in args.levels.split(",")], dev)
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
    import numpy as np

    noise = np.random.default_rng(2).integers(0, 256, 64 << 20, dtype=np.uint8).tobytes()
    for name, data, block, chained in (
        ("mix_independent", mix, 1 << 16, False), ("mix_chained", mix, 1 << 16, True),
        ("lz4_9_rows", cs.make_corpus(64 << 20, 0), 4 << 20, False),
        ("random_4MiB", noise, 4 << 20, False),
    ):
        report = {"payload": name, **_report(cs, *_windows(cs, data, block, chained), block,
                                             dev, args.iters)}
        print(json.dumps(report), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
