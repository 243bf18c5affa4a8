"""The HC arm (levels 3-9) as three passes: the chain pass of level 12
(`encode_opt.opt_chain`), then kernels `hc_episodes` and `hc_parse`
(`csrc/encode_hc_passes.cu`), and their plain versions.

The port, at levels 3-9, of the HC arm `hc_body` of `pallas_encode5`
(`lz4_tpu/ops/encode_pallas5.py:953`) and of `pallas_encode_stream`'s HC
arm (`lz4_tpu/ops/encode_pallas_stream.py:266`), with the bytes of
`encode_hc.encode_hc`.  The HC parse runs in episodes (`encode_hc.
hc_episode`): a first search at ip, then the lookahead searches that
follow from its answers, until control returns to the top of the parse.
Everything an episode searches depends on the window and ip alone, and
every search is made with the positions below it inserted in the chain and
none at or above it (the frontier property, below).  So the passes build
the chain of every position of a row (`opt_chain`), run the episode that
starts at every block position at once and keep the first `SLOTS`
searches of each (`hc_episodes`), then run the parse, with each search
read from that table where its key matches, or made on the spot
(`hc_parse`: each row cut into segments of `HC_SEGMENT` positions walked
at once and joined where their states meet, `parse_segments`;
`hc_parse_segments_plain` is its model).

Table layout: `opt_chain`'s prev holds every window position back to back
(`encode_opt.table_offsets`); the episode tables hold the block positions
only, row r from the sum of the block lengths before it (`slot_offsets`).
`first` keeps each position's first two searches in four int32: the first
search's key is (p, p, 3) and its m_start p, so (length, m_pos); the
second is the search2 after it, whose key (p + length - 2, p, length) the
first answer sets, so its length and its answer packed: back (its ip -
m_start) << 16 | m_start - m_pos (0 where m_pos is -1).  `more` keeps the
next `slots` - 2 searches as SLOT_INTS int32 each: the key (ip, ilow,
longest) and the answer (length, m_start, m_pos).  A length below 0 means
the search gave up under its work budget (`encode_opt.FIRST_BUDGET`,
`MATCH_BUDGET`, `RETRY_LONGEST`, as at level 12), was not made, or (the
second search) its back does not fit 16 bits; ip -1 marks a later search
the episode did not reach.  `deltas` holds every window position's chain step,
min(p - prev[p], 0xFFFF), as the bits of a u16 (int16 storage), which the
parse reads at its searches made on the spot.  `encode_windows_hc_passes`
runs the passes on groups of rows whose tables fit `group_budget`.  A CPU
tensor runs each pass's plain version; a CUDA tensor launches its kernel
(counted on the wrapper) or raises.  `encode_stream.encode_windows` sends
levels 3-9 here only on a CUDA tensor: on a CPU tensor it keeps the serial
plain parse (`encode_hc.encode_hc`, the same bytes), as level 12 keeps
`encode_hc.encode_opt`, since the plain episode pass runs a Python episode
at every block position where the parse runs one per parse step.

The frontier property: the serial arm inserts into its chain up to each
search position, so a search made below an earlier one would see
positions at or above it in the chain, and its 64 K delta ring aliased,
where the table answers as if only the positions below it were inserted.
No such search has been seen; the plain episode pass asserts the property
inside every episode, and the parse checks it at every search: one behind
its row's frontier takes no slot and searches on the spot with the ring's
answers (`FrontierFinder`, csrc FrontierChain).
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import LAST_LITERALS, MF_LIMIT, MIN_MATCH, compress_bound
from .build import check, load
from .common import align1024, read32
from .encode import _outputs, pack_rows
from .encode_hc import _hash, hc_episode, hc_parse_row, level_arm
from .encode_opt import (
    FIRST_BUDGET, MATCH_BUDGET, MAX_GROUP_ROWS, RETRY_LONGEST, SEGMENT_ROUNDS, TableFinder,
    _check_segments, _rows, _stream, _table, chain_scratch_bytes, opt_chain, segment_rows,
    table_offsets,
)
from .parse_segments import Walk, encode_seqs, parse_limit, schedule

# Searches kept per episode.  Text rows run episodes of up to ~17 searches
# (`hc9bench.py --host`: the first 8 hold 98.3% of the plain parse's search
# time, the first 12 99.8%); on the card more slots move search work from
# the parse (one thread per row) to the episode pass (one per position)
# (`hc9bench.py`, PERF.md).
SLOTS = 10
SLOT_INTS = 6  # a third search on: key (ip, ilow, longest), answer (length, m_start, m_pos)
HEAD_INTS = 4  # the first two searches: (length, m_pos, length, back << 16 | offset)
# The tables of one group of rows (`table_bytes`: 6 bytes per window byte
# and 208 per block byte at 10 slots): a 64 MiB `lz4 -9` frame's 16 rows of
# 4 MiB in one group (13.4 GiB), whose parse runs every row at once.  On a
# card a group also takes at most half the memory free for it
# (`group_budget`).
GROUP_TABLE_BYTES = 16 << 30
# The parse's segments (`csrc/parse_segments.cuh` kHcSegment,
# kHcOverlap): a thread walks the parse positions [s_k, s_k + HC_SEGMENT)
# of a row from a guessed state and goes on HC_OVERLAP positions past them,
# where the walk before links to it (`parse_segments`).
HC_SEGMENT = 16384
HC_OVERLAP = 1024

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("encode_hc_passes")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lz4t_hc_episodes.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.lz4t_hc_parse.argtypes = [p, p, p, p, p, p, p, p, p, p, i, p, ll, i, i, p, p, i, p,
                                       p, i, i, i, i, p, p, p]
        lib.lz4t_hc_seg_scratch.argtypes = [ll, i, i, i, p]
        for fn in (lib.lz4t_hc_episodes, lib.lz4t_hc_parse, lib.lz4t_hc_segment,
                   lib.lz4t_hc_overlap, lib.lz4t_hc_seg_scratch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def slot_offsets(src_offs, lens) -> tuple[torch.Tensor, int]:
    """Where each row's block positions start in a slot table (int64 [B]),
    and the table's number of positions."""
    blk = (torch.as_tensor(lens, dtype=torch.int64)
           - torch.as_tensor(src_offs, dtype=torch.int64)).cpu()
    return torch.cumsum(blk, 0) - blk, int(blk.sum())


def _episode_tables(tables, total: int, window_total: int, dev):
    """Checked (first, more, deltas) episode tables of ``total`` block and
    ``window_total`` window positions, and the searches they keep per
    episode."""
    first, more, deltas = (torch.as_tensor(t) for t in tables)
    if (first.dtype != torch.int32 or tuple(first.shape) != (total, HEAD_INTS)
            or more.dtype != torch.int32 or more.dim() != 3
            or tuple(more.shape[::2]) != (total, SLOT_INTS)
            or deltas.dtype != torch.int16 or tuple(deltas.shape) != (window_total,)):
        raise ValueError(f"the episode tables must be int32 [{total}, {HEAD_INTS}], int32 "
                         f"[{total}, slots - 2, {SLOT_INTS}] and int16 [{window_total}]")
    if any(t.device != dev for t in (first, more, deltas)):
        raise ValueError(f"the episode tables must lie on the windows' device {dev}")
    return first.contiguous(), more.contiguous(), deltas.contiguous(), 2 + more.shape[1]


def deltas_plain(prev: torch.Tensor, lens) -> torch.Tensor:
    """Each window position's chain step min(p - prev[p], 0xFFFF) from
    `encode_opt.opt_chain`'s table, as the bits of a u16 in int16."""
    pos = torch.cat([torch.arange(int(n), dtype=torch.int64)
                     for n in torch.as_tensor(lens).tolist()] or
                    [torch.zeros(0, dtype=torch.int64)])
    d = (pos - prev.cpu().to(torch.int64)).clamp(max=0xFFFF)
    return torch.where(d >= 0x8000, d - 0x10000, d).to(torch.int16).to(prev.device)


def _check_slots(slots: int):
    if not 1 <= slots <= 16:
        raise ValueError("slots must lie in [1, 16]")


class FrontierFinder(TableFinder):
    """`TableFinder` with the ring's answers when the chain holds every
    position below ``frontier``, which may pass the search position: the
    head read at p is the latest position below the frontier with p's hash,
    and the delta at q the one of the latest position below the frontier in
    q's ring slot (q & 0xFFFF), which the ring overwrites.  With the
    frontier at the search position it answers as `TableFinder` does."""

    def __init__(self, s, match_limit: int, max_attempts: int, prev: list,
                 frontier: int):
        super().__init__(s, match_limit, max_attempts, prev)
        self.frontier = frontier
        self.table_delta = self.delta

    def insert_upto(self, pos: int):
        self.frontier = max(self.frontier, pos)
        h = _hash(read32(self.s, pos))
        if self.frontier == pos:
            self.delta = self.table_delta
            self.head[h] = self.prev[pos]
            return
        self.delta = _RingDelta(self)
        self.head[h] = next(
            (q for q in range(self.frontier - 1, pos, -1) if _hash(read32(self.s, q)) == h),
            pos)


class _RingDelta:
    """The ring's delta at q as `FrontierFinder` reads it."""

    def __init__(self, finder: FrontierFinder):
        self.finder = finder

    def __getitem__(self, q: int) -> int:
        f = self.finder
        return f.table_delta[q + (((f.frontier - 1 - q) >> 16) << 16)]


# ---- pass 2: every position's episode ------------------------------------

def _episode_slots(finder, s, p: int, mf_limit: int, slots: int, budget: int,
                   first_budget: int, retry_longest: int) -> list:
    """The first ``slots`` searches of the episode at p over a budgeted
    `TableFinder`, each (ip, ilow, longest, length, m_start, m_pos); the
    episode stops at a search that gives up."""
    pa = finder.max_attempts > 128
    rec = []
    frontier = p

    def search(ip, ilow, longest):
        nonlocal frontier
        if len(rec) == slots:
            return None
        if ip < frontier:
            raise AssertionError(
                f"episode at {p}: a search at {ip} behind the frontier {frontier}, "
                "where the ring would hold positions past it")
        frontier = ip
        finder.budget = min(first_budget, budget)
        got = finder.wider_match(ip, ilow, longest, pa)
        if got[0] < 0 and budget > first_budget and -1 - got[0] <= retry_longest:
            finder.budget = budget
            got = finder.wider_match(ip, ilow, longest, pa)
        rec.append((ip, ilow, longest) + got)
        return got if got[0] >= 0 else None

    hc_episode(s, p, p, mf_limit, search, None)
    return rec


def _head(rec) -> list:
    """The four int32 of an episode's first two recorded searches."""
    _, _, _, len1, _, pos1 = rec[0]
    if len(rec) < 2:
        return [len1, pos1, -1, 0]
    ip2, _, _, len2, start2, pos2 = rec[1]
    back, off = ip2 - start2, 0 if pos2 < 0 else start2 - pos2
    if len2 >= 0 and back > 0xFFFF:
        len2 = -1  # a match reaching that far back: not kept
    packed = (back << 16) | off
    return [len1, pos1, len2, packed - (1 << 32) if packed >= 1 << 31 else packed]


def _unpack_head(p: int, head) -> list:
    """The first two searches' records [ip, ilow, longest, length, m_start,
    m_pos] of the episode at p from its four int32 (None for a second
    search not kept)."""
    len1, pos1, len2, packed = head
    first = [p, p, MIN_MATCH - 1, len1, p, pos1]
    if len1 < MIN_MATCH or len2 < 0:
        return [first, None]
    ip2 = p + len1 - 2
    back, off = (packed & 0xFFFFFFFF) >> 16, packed & 0xFFFF
    start2 = ip2 - back
    return [first, [ip2, p, len1, len2, start2, start2 - off if off else -1]]


def hc_episodes_plain(base_u8, starts, src_offs, lens, prev, depth: int = 256,
                      slots: int = SLOTS, budget: int = MATCH_BUDGET,
                      first_budget: int = FIRST_BUDGET,
                      retry_longest: int = RETRY_LONGEST, counts: list | None = None):
    """The plain PyTorch version of `hc_episodes`: each block position's
    episode over a budgeted `TableFinder`, asserting inside every episode
    that no search falls behind an earlier one.  ``counts``, if given, gets
    one dict per row: its searches, their chain steps and the most chain
    steps of one position's episode."""
    _check_slots(slots)
    base, st, so, ln, toff, _ = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, int(ln.sum()), 1, "prev", base.device).cpu().tolist()
    soff, total = slot_offsets(so, ln)
    raw = base.cpu().numpy()
    first = [[-1, -1, -1, 0]] * total
    unreached = [-1, 0, 0, 0, 0, 0]
    nmore = max(slots - 2, 0)
    more = [[unreached] * nmore] * total
    for a, off, n, at, sat in zip(st.tolist(), so.tolist(), ln.tolist(), toff.tolist(),
                                  soff.tolist()):
        tally = {"searches": 0, "steps": 0, "most_steps": 0}
        if counts is not None:
            counts.append(tally)
        if n - off < MF_LIMIT + 1:
            continue
        s = raw[a:a + n].tobytes()
        finder = TableFinder(s, n - LAST_LITERALS, depth, prev[at:at + n])
        mf_limit = n - MF_LIMIT
        for p in range(off, mf_limit + 1):
            steps = finder.steps
            rec = _episode_slots(finder, s, p, mf_limit, slots, budget, first_budget,
                                 retry_longest)
            tally["searches"] += len(rec)
            tally["most_steps"] = max(tally["most_steps"], finder.steps - steps)
            q = sat + p - off
            first[q] = _head(rec)
            more[q] = [list(r) for r in rec[2:]] + [unreached] * (nmore - max(len(rec) - 2, 0))
        tally["steps"] = finder.steps
    return (torch.tensor(first, dtype=torch.int32).reshape(total, HEAD_INTS).to(base.device),
            torch.tensor(more, dtype=torch.int32).reshape(total, nmore, SLOT_INTS)
            .to(base.device), deltas_plain(torch.tensor(prev, dtype=torch.int32), ln)
            .to(base.device))


def hc_episodes(base_u8, starts, src_offs, lens, prev, depth: int = 256,
                slots: int = SLOTS, budget: int = MATCH_BUDGET,
                first_budget: int = FIRST_BUDGET,
                retry_longest: int = RETRY_LONGEST):
    """Every block position's episode: the HC episode at p with ``depth``
    chain steps per search (pattern analysis above 128), its first
    ``slots`` searches kept as (first int32 [P, HEAD_INTS], more int32 [P,
    max(slots - 2, 0), SLOT_INTS]), P the sum of the block lengths, row r's
    position p at `slot_offsets` r + p - src_offs[r]; and deltas int16
    [sum(lens)], every window position's chain step (`deltas_plain`), laid
    out as prev.  first[p] holds the first two searches (the module
    docstring says how), more[p, j - 2] the j-th search's (ip, ilow,
    longest, length, m_start, m_pos).  A search that gave up (`encode_opt.
    opt_matches`' budgets) holds length -1 - L, and the episode stops
    there; first (-1, -1, -1, 0) and ip -1 in `more` where no search was
    made (past the episode, p past lens[r] - 12, or a block shorter than 13
    bytes).
    ``prev`` is `encode_opt.opt_chain`'s table of the same rows.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    once (counted here)."""
    _check_slots(slots)
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device)
    if base.device.type != "cuda":
        return hc_episodes_plain(base, st, so, ln, prev, depth, slots, budget, first_budget,
                                 retry_longest)
    dev = base.device
    nb = st.numel()
    if nb > MAX_GROUP_ROWS:
        raise ValueError(f"at most {MAX_GROUP_ROWS} rows per launch")
    soff, stotal = slot_offsets(so, ln)
    first = torch.empty((stotal, HEAD_INTS), dtype=torch.int32, device=dev)
    more = torch.empty((stotal, max(slots - 2, 0), SLOT_INTS), dtype=torch.int32, device=dev)
    deltas = torch.empty((total,), dtype=torch.int16, device=dev)
    if nb == 0 or total == 0:
        return first, more, deltas
    base = base.contiguous()
    st_d, so_d, ln_d, toff_d, soff_d = (t.to(dev) for t in (st, so, ln, toff, soff))
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_hc_episodes(
            base.data_ptr(), st_d.data_ptr(), so_d.data_ptr(), ln_d.data_ptr(),
            toff_d.data_ptr(), soff_d.data_ptr(), prev.data_ptr(), first.data_ptr(),
            more.data_ptr(), deltas.data_ptr(), slots, depth, min(first_budget, budget),
            budget, retry_longest, nb, int(ln.max()), _stream(dev))
    check(rc, "hc_episodes")
    hc_episodes.launches += 1
    return first, more, deltas


# ---- pass 3: the parse ----------------------------------------------------

def _replay_rows(base, st, so, ln, prev, tables, total, depth: int):
    """Each row's window, block start, length and `encode_hc.hc_parse_row`
    search factory for `hc_parse_plain`: the j-th search of the episode at
    ip read from the episode tables where they answer it, else made by the
    row's `FrontierFinder` at the row's frontier; with the finder and a
    tally (episodes, searches read and made on the spot, the chain steps of
    the latter)."""
    soff, stotal = slot_offsets(so, ln)
    first, more, deltas, _ = _episode_tables(tables, stotal, total, base.device)
    first, more = first.cpu().numpy(), more.cpu().numpy()
    deltas = (deltas.cpu().to(torch.int32) & 0xFFFF).tolist()
    raw = base.cpu().numpy()
    pa = depth > 128
    toff, _ = table_offsets(ln)
    for a, off, n, at, sat in zip(st.tolist(), so.tolist(), ln.tolist(), toff.tolist(),
                                  soff.tolist()):
        s = raw[a:a + n].tobytes()
        fs, ms = first[sat:sat + n - off], more[sat:sat + n - off]
        finder = FrontierFinder(s, n - LAST_LITERALS, depth, prev[at:at + n].tolist(), off)
        finder.table_delta = deltas[at:at + n]
        tally = {"episodes": 0, "read": 0, "on_the_spot": 0, "spot_steps": 0}

        def episode_search(p, fs=fs, ms=ms, finder=finder, off=off, tally=tally):
            recs = iter(_unpack_head(p, fs[p - off].tolist()) + ms[p - off].tolist())
            tally["episodes"] += 1

            def search(ip, ilow, longest):
                rec = next(recs, None)
                if (rec and ip >= finder.frontier and rec[:3] == [ip, ilow, longest]
                        and rec[3] >= 0):
                    finder.frontier = ip
                    tally["read"] += 1
                    return tuple(rec[3:])
                tally["on_the_spot"] += 1
                steps = finder.steps
                got = finder.wider_match(ip, ilow, longest, pa)
                tally["spot_steps"] += finder.steps - steps
                return got

            return search

        yield s, off, n, episode_search, finder, tally


def hc_parse_plain(base_u8, starts, src_offs, lens, prev, tables, bcap: int,
                   depth: int = 256, counts: list | None = None):
    """The plain PyTorch version of `hc_parse`: `encode_hc.hc_parse_row`
    with each search read from the episode tables where they answer it,
    else made by a `FrontierFinder` at the row's frontier.  ``counts``, if
    given, gets one dict per row: its episodes, the searches read from the
    tables and made on the spot, and the chain steps of the latter."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu()
    comps = []
    for s, off, _, episode_search, _, tally in _replay_rows(base, st, so, ln, prev, tables,
                                                             total, depth):
        comps.append(hc_parse_row(s, off, episode_search))
        if counts is not None:
            counts.append(tally)
    return pack_rows(comps, align1024(compress_bound(bcap)), base.device)


def hc_segment_caps(segment: int, overlap: int) -> tuple[int, int, int]:
    """A walk's capacities at levels 3-9 (`csrc/parse_segments.cuh`): the
    states kept from its start (head) and past its segment's end (tail),
    and its sequences.  Every episode's start is a state, one a position at
    most; its sequences, 4 positions each at least, start from its
    segment's start to its stop, and up to 1,024 more in the episode that
    crosses the stop."""
    return overlap + 2, overlap + 2, (segment + overlap) // 4 + 1026


def hc_parse_segments_plain(base_u8, starts, src_offs, lens, prev, tables, bcap: int,
                            depth: int = 256, segment: int = HC_SEGMENT,
                            overlap: int = HC_OVERLAP, max_rounds: int = SEGMENT_ROUNDS,
                            counts: list | None = None):
    """`hc_parse` by the kernels' schedule (`parse_segments.schedule`), a
    model for the tests and the step count (no path runs it): each row's
    parse cut into segments of ``segment`` positions, each walked by the
    episodes of `hc_parse_plain` from a guessed state (ip = anchor = the
    frontier = the segment's start) until ``overlap`` positions past its
    end, the walks linked where their states (ip and the frontier raised
    to it, at every episode's start) meet, the others walked again from
    their predecessors' end states for up to ``max_rounds`` rounds, then
    one after another.  Asserts at every link that the frontier there is
    at ip.  Returns the bytes of `hc_parse_plain`; ``counts``, if given,
    gets one tally per row (`parse_segments.schedule`'s, each walk's
    dependent steps its searches read from the tables plus the chain steps
    of those made on the spot)."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu()
    head, tail_cap, seq_cap = hc_segment_caps(segment, overlap)
    comps = []
    for s, off, n, episode_search, finder, steps in _replay_rows(base, st, so, ln, prev,
                                                                 tables, total, depth):
        def walk(start, stop, s=s, episode_search=episode_search, finder=finder,
                 steps=steps, mf_limit=parse_limit(off, n), episode_limit=n - MF_LIMIT):
            w = Walk(start, keyed=True)
            ip, anchor, finder.frontier = start
            before = steps["read"] + steps["spot_steps"]

            def put(_, __, anchor, ll, off, ml):
                w.seqs.append((anchor + ll, off, ml))

            while ip <= mf_limit:
                state = (ip, anchor, max(finder.frontier, ip))
                w.states.append((ip, state[2], len(w.seqs), anchor))
                if stop is not None and ip >= stop:
                    w.end = state
                    break
                ip, anchor = hc_episode(s, ip, anchor, episode_limit, episode_search(ip), None,
                                        put)
            w.steps = steps["read"] + steps["spot_steps"] - before
            return w

        tally = {}
        seqs, anchor = schedule(off, n, segment, overlap, head, tail_cap, seq_cap, max_rounds,
                                walk, tally)
        for ip, key, _, _ in tally["linked_states"]:
            assert key == ip, f"a link at {ip} with the frontier at {key}, past it"
        comps.append(encode_seqs(s, off, seqs, anchor))
        if counts is not None:
            counts.append(tally)
    return pack_rows(comps, align1024(compress_bound(bcap)), base.device)


def hc_parse(base_u8, starts, src_offs, lens, prev, tables, bcap: int, depth: int = 256,
             segment: int = HC_SEGMENT, overlap: int = HC_OVERLAP,
             max_rounds: int = SEGMENT_ROUNDS):
    """The HC parse of each row's block (`encode_hc.hc_parse_row`), the
    j-th search of the episode at ip read from ``tables`` (`hc_episodes`'
    (first, more, deltas) of the same rows) where the table holds the
    search's key and an answer and the search lies at or past the row's
    frontier (every earlier search's position); any other search made on
    the spot (``depth`` chain steps) over ``prev`` (`encode_opt.opt_chain`'s
    table, for its head) and the deltas, with the ring's answers at that
    frontier.

    Returns (out uint8 [B, OCAP], clens int32 [B], errs int32 [B]) as
    `encode_stream.encode_windows` does, OCAP = align1024(compress_bound(
    bcap)).  A CPU tensor runs the plain version (`hc_parse_plain`, the
    same bytes); a CUDA tensor launches the kernels of the parse by
    segments (counted once here; `hc_parse_segments_plain` is their
    model): ``max_rounds`` rounds of threads walking every row's segments
    of ``segment`` positions on by ``overlap``, their links checked after
    each, the serial tail and the emit.  ``hc_parse.stats`` then holds the
    launch's counts (`encode_opt.segment_stats`)."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device)
    soff, stotal = slot_offsets(so, ln)
    first, more, deltas, slots = _episode_tables(tables, stotal, total, base.device)
    if st.numel() and int((ln - so).max()) > bcap:
        raise ValueError(f"block lengths must lie in [0, bcap={bcap}]")
    _check_segments(segment, overlap, max_rounds)
    if base.device.type != "cuda":
        return hc_parse_plain(base, st, so, ln, prev, (first, more, deltas), bcap, depth)
    dev = base.device
    nb = st.numel()
    out, clens, errs = _outputs(nb, bcap, dev)
    if nb == 0:
        return out, clens, errs
    base = base.contiguous()
    segoff, seg_row = segment_rows(so, ln, segment)
    nseg = seg_row.numel()
    lib = _kernel()
    size = ctypes.c_longlong()
    lib.lz4t_hc_seg_scratch(nseg, nb, segment, overlap, ctypes.addressof(size))
    scratch = torch.empty(size.value, dtype=torch.uint8, device=dev)
    stats = torch.empty(max_rounds + 4, dtype=torch.int32, device=dev)
    st_d, so_d, ln_d, toff_d, soff_d, segoff_d, seg_row_d = (
        t.to(dev) for t in (st, so, ln, toff, soff, segoff, seg_row))
    with torch.cuda.device(dev):
        rc = lib.lz4t_hc_parse(
            base.data_ptr(), st_d.data_ptr(), so_d.data_ptr(), ln_d.data_ptr(),
            toff_d.data_ptr(), soff_d.data_ptr(), prev.data_ptr(), first.data_ptr(),
            more.data_ptr(), deltas.data_ptr(), slots, out.data_ptr(), out.shape[1],
            out.shape[1], depth, clens.data_ptr(), errs.data_ptr(), nb, segoff_d.data_ptr(),
            seg_row_d.data_ptr(), nseg, segment, overlap, max_rounds, scratch.data_ptr(),
            stats.data_ptr(), _stream(dev))
    check(rc, "hc_parse")
    hc_parse.launches += 1
    hc_parse.stats = stats
    return out, clens, errs


def parse_segment() -> tuple[int, int]:
    """The built kernel's kHcSegment and kHcOverlap, which `HC_SEGMENT` and
    `HC_OVERLAP` restate."""
    lib = _kernel()
    return lib.lz4t_hc_segment(), lib.lz4t_hc_overlap()


# ---- the three passes over a batch ---------------------------------------

def table_bytes(n: int, block: int) -> int:
    """Device bytes of one row's tables: prev and the deltas of its n window
    positions and the episode tables of its block positions, or prev and
    the chain pass's scratch (`encode_opt.chain_scratch_bytes`, freed
    before the episode tables are made) where that were more."""
    return max(6 * n + 4 * (HEAD_INTS + SLOT_INTS * (SLOTS - 2)) * block,
               4 * n + chain_scratch_bytes(n))


def group_budget(dev) -> int:
    """The table bytes one group of rows may take on ``dev``:
    `GROUP_TABLE_BYTES`, and on a card at most half of what is free for the
    tables (the device's free memory and the blocks PyTorch's allocator
    holds unused), so that a card shared with other work, or a payload of
    tens of GB, runs in more groups rather than out of memory."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return GROUP_TABLE_BYTES
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return min(GROUP_TABLE_BYTES, (free + cached) // 2)


def row_groups(src_offs, lens, budget: int | None = None) -> list[tuple[int, int]]:
    """Consecutive [first, end) row ranges whose tables fit ``budget``
    bytes (`GROUP_TABLE_BYTES` if None; a row larger than that makes a
    group of its own) and whose rows fit one episode-pass launch."""
    budget = GROUP_TABLE_BYTES if budget is None else budget
    groups, first, size = [], 0, 0
    ln = torch.as_tensor(lens).tolist()
    so = torch.as_tensor(src_offs).tolist()
    for r, (n, off) in enumerate(zip(ln, so)):
        need = table_bytes(n, n - off)
        if r > first and (size + need > budget or r - first == MAX_GROUP_ROWS):
            groups.append((first, r))
            first, size = r, 0
        size += need
    groups.append((first, len(ln)))
    return groups


def encode_windows_hc_passes(base_u8, starts, src_offs, lens, bcap: int, level: int = 9):
    """`encode_stream.encode_windows` at levels 3-9: on each group of rows
    (`row_groups` under `group_budget`), `encode_opt.opt_chain`,
    `hc_episodes` and `hc_parse`, one launch of each on a CUDA tensor,
    their plain versions on a CPU tensor.  Returns (out, clens, errs) as
    `encode_windows` does, the same bytes as kernel D's serial HC arm."""
    arm, depth, _, _ = level_arm(level)
    if arm != "hc":
        raise ValueError(f"level {level} is not an HC level (3-9)")
    base, st, so, ln, _, _ = _rows(base_u8, starts, src_offs, lens)
    parts = []
    for g0, g1 in row_groups(so, ln, group_budget(base.device)):
        rows = st[g0:g1], so[g0:g1], ln[g0:g1]
        prev = opt_chain(base, rows[0], rows[2])
        tables = hc_episodes(base, *rows, prev, depth)
        parts.append(hc_parse(base, *rows, prev, tables, bcap, depth))
        del prev, tables
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(ts) for ts in zip(*parts))


hc_episodes.launches = 0
hc_parse.launches = 0
hc_parse.stats = None
