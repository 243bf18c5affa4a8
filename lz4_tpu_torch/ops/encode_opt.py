"""The OPT arm as three passes: kernels `opt_chain`, `opt_matches` and, at
level 12, `opt_parse`, at levels 10-11 `opt_parse_spec` (`csrc/encode_opt.cu`),
and their plain versions.

The port of the OPT arm `opt_body` of `pallas_encode5`
(`lz4_tpu/ops/encode_pallas5.py:1172`) and of `pallas_encode_stream`'s OPT
arm (`lz4_tpu/ops/encode_pallas_stream.py`), with the bytes of
`encode_hc.encode_opt`.  The arm inserts into its chain only up to the
search position, so the search at p with a given minimum length is a
function of the row, p and that length.  The passes build the chain of
every position of a row (`opt_chain`: segments of `CHAIN_SEGMENT`
positions walked at once, then joined; `opt_chain_segments_plain` is its
model) and make every position's
min-length-3 search at once with the level's depth (`opt_matches`, one CTA
per slice of `SLICE` positions, the chain deltas its searches read staged
in shared memory).  Both parses run on a warp, up to 32 searches a round
(`opt_parse_rounds_row` says why that is exact), their price-table steps
spread over the lanes (`opt_add_warp`, `opt_seed_warp`).  At level 12
every search of the parse is the min-length-3 search, and `opt_parse`
reads each from the table, one warp per row.  At levels 10-11 the parse
asks for a match longer than a length its price table sets:
`opt_parse_spec` reads the searches whose minimum length is 3 or less from
the table (they give what the min-length-3 search gives) and makes the
others on the spot, each row cut into segments of `OPT_SEGMENT` positions
walked at once and joined where their states meet (`parse_segments`;
`opt_parse_segments_plain` is its model).

Rows are kernel D's windows (`encode_stream.encode_windows`): row r is
base_u8[starts[r] : starts[r] + lens[r]], its first src_offs[r] bytes a
prefix that matches may reach.  A table holds every position of every row
back to back, row r from the sum of the lengths before it
(`table_offsets`); the tables take `TABLE_BYTES` per window byte, so
`encode_windows_opt_passes` runs the passes on groups of rows under
`GROUP_TABLE_BYTES`.  A CPU tensor runs each pass's plain version; a CUDA
tensor launches its kernel (counted on the wrapper) or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import LAST_LITERALS, MF_LIMIT, MIN_MATCH, compress_bound
from .build import check, load
from .common import align1024, emit, read32
from .encode import _outputs, pack_rows
from .encode_hc import (
    OPT_NUM, TRAILING, ChainFinder, _hash, _lit_price, _seq_price, _trailing, level_arm,
    opt_encode, opt_parse_row,
)
from .parse_segments import Walk, encode_seqs, parse_limit, schedule, segment_count

HC_EMPTY = -65536  # prev of a position with no earlier one of its hash
TABLE_BYTES = 12  # prev (int32) and the match (int32 length and offset)
GROUP_TABLE_BYTES = 1 << 30  # the tables of one group of rows
# The match pass's work budgets (chain steps plus bytes measured; a search
# over budget gives up and leaves its position to the parse, which makes it
# in full, one after another).  Every search starts with FIRST_BUDGET, and
# one that gives up with no match longer than RETRY_LONGEST starts again
# with MATCH_BUDGET: a longer match is a repeat, where every position would
# measure the repeat up to the budget and the parse jumps over most
# positions.  `opt12bench.py` measures the trade-off.
FIRST_BUDGET = 1024
MATCH_BUDGET = 65536
RETRY_LONGEST = 256
MAX_GROUP_ROWS = 65535  # the match pass's grid holds one row per y index
# The match pass's slices (`csrc/encode_opt.cu` kSlice): a CTA searches
# positions [k * SLICE, (k + 1) * SLICE) of a row and stages in shared
# memory the chain deltas of every position its searches reach, from 65,535
# below its first.
SLICE = 16384
# The chain pass's segments (`csrc/encode_opt.cu` kChainSegment): a CTA
# walks positions [k * CHAIN_SEGMENT, (k + 1) * CHAIN_SEGMENT) of a row, and
# each segment of a row that has more than one leaves each hash's last and
# first position in it (two u16 tables of CHAIN_HASHES entries) for the
# join.
CHAIN_SEGMENT = 16384
CHAIN_HASHES = 1 << 15
# The level 10-11 parse's segments (`csrc/parse_segments.cuh`
# kOptSegment, kOptOverlap): a warp walks the parse positions [s_k, s_k +
# OPT_SEGMENT) of a row from a guessed state and goes on OPT_OVERLAP
# positions past them, where the walk before links to it
# (`parse_segments`).  The rounds of walks before the serial tail:
# SEGMENT_ROUNDS (`csrc/parse_segments.cuh` kMaxRounds), for the HC parse
# too.
OPT_SEGMENT = 16384
OPT_OVERLAP = 2048
SEGMENT_ROUNDS = 8

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("encode_opt")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lz4t_opt_chain.argtypes = [p, p, p, p, p, p, p, p, i, i, p]
        lib.lz4t_opt_matches.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.lz4t_opt_parse.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, p, p, i, p]
        lib.lz4t_opt_parse_spec.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, p, p, i, p, p,
                                             i, i, i, i, p, p, p]
        lib.lz4t_opt_seg_scratch.argtypes = [ll, i, i, i, p]
        for fn in (lib.lz4t_opt_chain, lib.lz4t_opt_matches, lib.lz4t_opt_parse,
                   lib.lz4t_opt_parse_spec, lib.lz4t_opt_chain_shared_bytes,
                   lib.lz4t_opt_matches_shared_bytes, lib.lz4t_opt_parse_shared_bytes,
                   lib.lz4t_opt_slice, lib.lz4t_opt_chain_segment,
                   lib.lz4t_opt_chain_ctas_per_sm, lib.lz4t_opt_segment,
                   lib.lz4t_opt_overlap, lib.lz4t_opt_seg_scratch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def shared_bytes() -> dict:
    """Dynamic shared memory of one CTA of each pass ("opt_parse": level
    12's; the level 10-11 parse keeps its price tables in device
    memory)."""
    lib = _kernel()
    return {"opt_chain": lib.lz4t_opt_chain_shared_bytes(),
            "opt_matches": lib.lz4t_opt_matches_shared_bytes(),
            "opt_parse": lib.lz4t_opt_parse_shared_bytes()}


def slice_positions() -> int:
    """The built kernel's kSlice, which `SLICE` restates."""
    return _kernel().lz4t_opt_slice()


def chain_segment() -> int:
    """The built kernel's kChainSegment, which `CHAIN_SEGMENT` restates."""
    return _kernel().lz4t_opt_chain_segment()


def parse_segment() -> tuple[int, int]:
    """The built kernel's kOptSegment and kOptOverlap, which `OPT_SEGMENT`
    and `OPT_OVERLAP` restate."""
    lib = _kernel()
    return lib.lz4t_opt_segment(), lib.lz4t_opt_overlap()


def chain_ctas_per_sm() -> int:
    """CTAs of the chain walk that one SM of the card holds at once."""
    return _kernel().lz4t_opt_chain_ctas_per_sm()


def _segments(n, segment: int):
    """A row's segments, where it has more than one: it then has tables."""
    k = -(-n // segment)
    return k * (k > 1)


def chain_tables(lens, segment: int = CHAIN_SEGMENT) -> tuple[torch.Tensor, int]:
    """Where each row's segment tables start in the chain pass's scratch
    (int64 [B]: row r has a pair for each of its ceil(lens[r] / segment)
    segments where that is more than one), and the number of pairs."""
    tables = _segments(torch.as_tensor(lens, dtype=torch.int64).cpu(), segment)
    return torch.cumsum(tables, 0) - tables, int(tables.sum())


def chain_scratch_bytes(n: int) -> int:
    """Device bytes of the chain pass's scratch for a row of ``n``
    positions: its segments' pairs of tables, 2 bytes a hash each."""
    return _segments(n, CHAIN_SEGMENT) * 4 * CHAIN_HASHES


def table_offsets(lens) -> tuple[torch.Tensor, int]:
    """Where each row's positions start in a table (int64 [B]), and the
    table's length."""
    ln = torch.as_tensor(lens, dtype=torch.int64).cpu()
    toff = torch.cumsum(ln, 0) - ln
    return toff, int(ln.sum())


def _rows(base_u8, starts, src_offs, lens):
    """The windows as CPU tensors: (base, starts int64, src_offs int32
    (zeros for None), lens int32, table offsets, table length)."""
    base = torch.as_tensor(base_u8)
    if base.dtype != torch.uint8 or base.dim() != 1:
        raise ValueError("base_u8 must be a 1-D uint8 tensor")
    st = torch.as_tensor(starts, dtype=torch.int64).cpu()
    ln = torch.as_tensor(lens, dtype=torch.int32).cpu()
    so = (torch.zeros_like(ln) if src_offs is None
          else torch.as_tensor(src_offs, dtype=torch.int32).cpu())
    if st.dim() != 1 or so.shape != st.shape or ln.shape != st.shape:
        raise ValueError("starts, src_offs and lens must hold one value per row")
    if st.numel() and (int(st.min()) < 0 or int(ln.min()) < 0
                       or int((st + ln).max()) > base.numel()
                       or int(so.min()) < 0 or bool((so > ln).any())):
        raise ValueError("a window reaches outside base_u8")
    toff, total = table_offsets(ln)
    return base, st, so, ln, toff, total


def _table(t, total: int, width: int, name: str, dev):
    t = torch.as_tensor(t)
    shape = (total,) if width == 1 else (total, width)
    if t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be int32 {list(shape)}")
    if t.device != dev:
        raise ValueError(f"{name} must lie on the windows' device {dev}")
    return t.contiguous()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---- pass 1: the chain of every position ---------------------------------

def _hash32(w: torch.Tensor) -> torch.Tensor:
    """`_hash` of int64 words without overflowing 64 bits."""
    k = 2654435761
    lo = (w & 0xFFFF) * k
    hi = (((w >> 16) * k) & 0xFFFF) << 16
    return ((lo + hi) & 0xFFFFFFFF) >> (32 - 15)


def opt_chain_plain(base_u8, starts, lens) -> torch.Tensor:
    """The plain PyTorch version of `opt_chain`: one stable sort of each
    row's position hashes."""
    base, st, _, ln, toff, total = _rows(base_u8, starts, None, lens)
    raw = base.cpu()
    prev = torch.full((total,), HC_EMPTY, dtype=torch.int32)
    for a, n, at in zip(st.tolist(), ln.tolist(), toff.tolist()):
        if n < MIN_MATCH:
            continue
        w = raw[a:a + n].to(torch.int64)
        w = w[:-3] | (w[1:-2] << 8) | (w[2:-1] << 16) | (w[3:] << 24)
        h = _hash32(w)
        order = torch.sort(h, stable=True).indices
        same = h[order[1:]] == h[order[:-1]]
        pv = prev[at:at + n]
        pv[order[1:][same]] = order[:-1][same].to(torch.int32)
    return prev.to(base.device)


def chain_steps(n: int, segment: int = CHAIN_SEGMENT) -> tuple[int, int]:
    """The chain pass's dependent steps on a row of ``n`` positions: its
    longest segment's walk steps (32 positions a step) and its segment
    count (the join's carry, one step a segment)."""
    return -(-min(n, segment) // 32), -(-n // segment)


def opt_chain_segments_plain(base_u8, starts, lens, segment: int = CHAIN_SEGMENT,
                             counts: list | None = None) -> torch.Tensor:
    """`opt_chain` by the kernels' schedule, a model for the tests and the
    step count (no path runs it): each row cut into segments of
    ``segment`` positions (a power of two, 32 to 65,536), each walked
    alone (a stable sort by hash inside the segment); a position whose
    hash has no earlier one in its segment takes the last position of that
    hash in the row's earlier segments, which the join carries from
    segment to segment.

    ``counts``, if given, gets one tally per row: its `segments`, its
    longest segment's `walk_steps`, `steps` (the two added: the design's
    dependent steps) and the positions `joined`, those the join writes
    (first of their hash in their segment, the hash in an earlier one)."""
    if segment & (segment - 1) or not 32 <= segment <= 65536:
        raise ValueError("segment must be a power of two from 32 to 65,536")
    base, st, _, ln, toff, total = _rows(base_u8, starts, None, lens)
    raw = base.cpu().numpy()
    prev = np.full(total, HC_EMPTY, dtype=np.int64)
    for a, n, at in zip(st.tolist(), ln.tolist(), toff.tolist()):
        walk, segments = chain_steps(n, segment)
        tally = {"segments": segments, "walk_steps": walk, "steps": walk + segments,
                 "joined": 0}
        m = n - MIN_MATCH + 1
        # each hash's last position in the segments walked so far: what the
        # join carries
        latest = np.full(CHAIN_HASHES, HC_EMPTY, dtype=np.int64)
        if m > 0:
            w = raw[a:a + n].astype(np.uint32)
            h = (((w[:-3] | w[1:-2] << 8 | w[2:-1] << 16 | w[3:] << 24)
                  * np.uint32(2654435761)) >> np.uint32(32 - 15)).astype(np.int64)
        for k in range(segments):
            lo, hi = k * segment, min((k + 1) * segment, m)
            if hi <= lo:
                break
            hs = h[lo:hi]
            order = np.argsort(hs, kind="stable")
            same = hs[order[1:]] == hs[order[:-1]]
            seg = np.full(hi - lo, -1, dtype=np.int64)
            seg[order[1:][same]] = order[:-1][same]
            first = np.flatnonzero(seg < 0)
            seg[first] = latest[hs[first]] - lo  # the join
            prev[at + lo:at + hi] = seg + lo
            tally["joined"] += int((latest[hs[first]] != HC_EMPTY).sum())
            ends = np.append(order[:-1][~same], order[-1])  # each hash's last
            latest[hs[ends]] = ends + lo
        if counts is not None:
            counts.append(tally)
    return torch.from_numpy(prev.astype(np.int32)).to(base.device)


def opt_chain(base_u8, starts, lens) -> torch.Tensor:
    """The chain of every position of each row: prev int32 [sum(lens)],
    row r's entry p (at `table_offsets` r + p) the previous position of p's
    hash in the row, HC_EMPTY when there is none or p >= lens[r] - 3.

    A CPU tensor runs the plain version; a CUDA tensor enqueues the
    kernels (`opt_chain_walk` over every segment of every row, then
    `opt_chain_join` over every hash of every row of more than one
    segment; counted once here), their scratch (`chain_tables`) freed
    before this returns."""
    base, st, _, ln, toff, total = _rows(base_u8, starts, None, lens)
    if base.device.type != "cuda":
        return opt_chain_plain(base, st, ln)
    dev = base.device
    prev = torch.empty((total,), dtype=torch.int32, device=dev)
    if st.numel() == 0:
        return prev
    base = base.contiguous()
    segoff, tables = chain_tables(ln)
    last, first = torch.empty((2, max(tables, 1), CHAIN_HASHES), dtype=torch.int16, device=dev)
    st_d, ln_d, toff_d, segoff_d = st.to(dev), ln.to(dev), toff.to(dev), segoff.to(dev)
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_opt_chain(
            base.data_ptr(), st_d.data_ptr(), ln_d.data_ptr(), toff_d.data_ptr(),
            segoff_d.data_ptr(), last.data_ptr(), first.data_ptr(), prev.data_ptr(),
            st.numel(), int(ln.max()), _stream(dev))
    check(rc, "opt_chain")
    opt_chain.launches += 1
    return prev


# ---- pass 2: every position's match --------------------------------------

class TableFinder(ChainFinder):
    """`ChainFinder` over a row's chain table (`opt_chain`): the head read
    at p is prev[p], and the delta of each chain step min(q - prev[q],
    0xFFFF), indexed by the whole position.  What the ring holds when the
    search at p begins, as long as nothing was inserted past p."""

    mask = -1  # delta[q & -1] is delta[q]

    def __init__(self, s, match_limit: int, max_attempts: int, prev: list):
        super().__init__(s, match_limit, max_attempts)
        self.prev = prev
        self.delta = [min(q - pv, 0xFFFF) for q, pv in enumerate(prev)]

    def insert_upto(self, pos: int):
        self.head[_hash(read32(self.s, pos))] = self.prev[pos]


def opt_matches_plain(base_u8, starts, src_offs, lens, prev, depth: int = 16384,
                      budget: int = MATCH_BUDGET, first_budget: int = FIRST_BUDGET,
                      retry_longest: int = RETRY_LONGEST, counts: list | None = None,
                      span: tuple[int, int] | None = None):
    """The plain PyTorch version of `opt_matches`: a `TableFinder`
    search per position, made again with ``budget`` where the first gave up
    with no match longer than ``retry_longest``.

    ``span`` (p0, p1), if given, searches only the positions of each row
    in [p0, p1) and leaves the others (0, 0).  ``counts``, if given, gets
    one tally per row: the searches made, those made again with the large
    budget, those given up, their chain steps, their work (chain steps plus
    bytes measured, what the budgets count), `most_work`, the most work of
    one position (its first search and its second, if made), and
    `most_steps`, the most dependent steps of one position (chain steps
    plus the measures' word and byte compares, `ChainFinder.dependent`):
    the slowest search, the match pass's step bound."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu().tolist()
    raw = base.cpu().numpy()
    out = torch.zeros((total, 2), dtype=torch.int32)
    p0, p1 = span if span is not None else (0, 1 << 62)
    for a, off, n, at in zip(st.tolist(), so.tolist(), ln.tolist(), toff.tolist()):
        tally = dict.fromkeys(("searches", "retries", "given_up", "steps", "work", "most_work",
                               "most_steps"), 0)
        lo, hi = max(off, p0), min(n - MF_LIMIT + 1, p1)
        if n - off >= MF_LIMIT + 1 and lo < hi:
            s = raw[a:a + n].tobytes()
            finder = TableFinder(s, n - LAST_LITERALS, depth, prev[at:at + n])
            finder.count_dependent = counts is not None
            found = []
            for p in range(lo, hi):
                finder.budget = min(first_budget, budget)
                steps = finder.steps
                ml, _, mp = finder.wider_match(p, p, MIN_MATCH - 1, True, True)
                work, dep = finder.work, finder.dependent
                tally["searches"] += 1
                if ml < 0 and budget > first_budget and -1 - ml <= retry_longest:
                    finder.budget = budget
                    ml, _, mp = finder.wider_match(p, p, MIN_MATCH - 1, True, True)
                    work += finder.work
                    dep += finder.dependent
                    tally["retries"] += 1
                tally["steps"] += finder.steps - steps
                tally["work"] += work
                tally["most_work"] = max(tally["most_work"], work)
                tally["most_steps"] = max(tally["most_steps"], dep)
                if ml < 0:
                    tally["given_up"] += 1
                    found.append((ml, 0))
                else:
                    found.append((ml, p - mp) if ml > MIN_MATCH - 1 and mp >= 0 else (0, 0))
            out[at + lo:at + hi] = torch.tensor(found, dtype=torch.int32)
        if counts is not None:
            counts.append(tally)
    return out.to(base.device)


def opt_matches(base_u8, starts, src_offs, lens, prev, depth: int = 16384,
                budget: int = MATCH_BUDGET, first_budget: int = FIRST_BUDGET,
                retry_longest: int = RETRY_LONGEST):
    """Every position's match: int32 [sum(lens), 2], row r's entry p the
    (length, offset) of the chain-swap search at p with ``depth`` steps
    (`encode_hc.ChainFinder.wider_match(p, p, 3, True, True)` walked in
    position order), (0, 0) when nothing is longer than 3 bytes or p lies
    outside [src_offs[r], lens[r] - 12] (or the block is shorter than 13
    bytes), and (-1 - the longest match found, 0) where the search gave up
    (`ChainFinder.wider_match`): after ``first_budget`` of work, or, where
    it had found no match longer than ``retry_longest``, after ``budget``
    (a search that ends inside a budget finds what it finds under any
    larger one).  ``prev`` is `opt_chain`'s table of the same rows.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    once (counted here)."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device)
    if base.device.type != "cuda":
        return opt_matches_plain(base, st, so, ln, prev, depth, budget, first_budget,
                                 retry_longest)
    dev = base.device
    nb = st.numel()
    if nb > MAX_GROUP_ROWS:
        raise ValueError(f"at most {MAX_GROUP_ROWS} rows per launch")
    matches = torch.empty((total, 2), dtype=torch.int32, device=dev)
    if nb == 0 or total == 0:
        return matches
    base = base.contiguous()
    st_d, so_d, ln_d, toff_d = st.to(dev), so.to(dev), ln.to(dev), toff.to(dev)
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_opt_matches(
            base.data_ptr(), st_d.data_ptr(), so_d.data_ptr(), ln_d.data_ptr(),
            toff_d.data_ptr(), prev.data_ptr(), matches.data_ptr(), depth,
            min(first_budget, budget), budget, retry_longest, nb, int(ln.max()),
            _stream(dev))
    check(rc, "opt_matches")
    opt_matches.launches += 1
    return matches


# ---- pass 3: the price parse ---------------------------------------------

def opt_parse_plain(base_u8, starts, src_offs, lens, prev, matches, bcap: int,
                    depth: int = 16384, sufficient: int = 4095):
    """The plain PyTorch version of `opt_parse`, the CPU route:
    `encode_hc.opt_parse_row` with each search read from the table, or made
    by a `TableFinder` where the match pass gave up.  The kernel's rounds
    give the same bytes: `opt_parse_rounds_plain` with ``full``."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu()
    table = _table(matches, total, 2, "matches", base.device).cpu()
    raw = base.cpu().numpy()
    comps = []
    for a, off, n, at in zip(st.tolist(), so.tolist(), ln.tolist(), toff.tolist()):
        s = raw[a:a + n].tobytes()
        t = table[at:at + n].tolist()
        finder = TableFinder(s, n - LAST_LITERALS, depth, prev[at:at + n].tolist())

        def find(p, min_len, t=t, finder=finder):
            if t[p][0] >= 0:
                return t[p]
            ml, _, mp = finder.wider_match(p, p, min_len, True, True)
            return (ml, p - mp) if ml > min_len and mp >= 0 else (0, 0)

        comps.append(opt_parse_row(s, off, find, sufficient, True))
    return pack_rows(comps, align1024(compress_bound(bcap)), base.device)


def opt_parse(base_u8, starts, src_offs, lens, prev, matches, bcap: int,
              depth: int = 16384, sufficient: int = 4095):
    """The level 12 price parse of each row's block by one warp, its
    searches read 32 at a time from ``matches`` (`opt_matches`' table of
    the same rows; `opt_parse_rounds_row` with ``full``), a search that
    gave up there made in full (``depth`` steps) over ``prev``
    (`opt_chain`'s table) by its lane.

    Returns (out uint8 [B, OCAP], clens int32 [B], errs int32 [B]) as
    `encode_stream.encode_windows` does, OCAP = align1024(compress_bound(
    bcap)).  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel once (counted here)."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device)
    matches = _table(matches, total, 2, "matches", base.device)
    if st.numel() and int((ln - so).max()) > bcap:
        raise ValueError(f"block lengths must lie in [0, bcap={bcap}]")
    if base.device.type != "cuda":
        return opt_parse_plain(base, st, so, ln, prev, matches, bcap, depth, sufficient)
    dev = base.device
    nb = st.numel()
    out, clens, errs = _outputs(nb, bcap, dev)
    if nb == 0:
        return out, clens, errs
    base = base.contiguous()
    st_d, so_d, ln_d, toff_d = st.to(dev), so.to(dev), ln.to(dev), toff.to(dev)
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_opt_parse(
            base.data_ptr(), st_d.data_ptr(), so_d.data_ptr(), ln_d.data_ptr(),
            toff_d.data_ptr(), prev.data_ptr(), matches.data_ptr(), out.data_ptr(),
            out.shape[1], out.shape[1], depth, sufficient, clens.data_ptr(),
            errs.data_ptr(), nb, _stream(dev))
    check(rc, "opt_parse")
    opt_parse.launches += 1
    return out, clens, errs


# ---- the price parse by rounds, as the kernels run it ---------------------

def _lanes_steps(count: int, lanes: int) -> int:
    """Dependent steps of ``count`` independent table writes on ``lanes``."""
    return -(-count // lanes)


def opt_seed_warp(o: list, llen: int, first_len: int, first_off: int, lanes: int = 32) -> int:
    """`encode_hc.opt_seed` as the warp runs it (`lz4_hc_body.cuh`
    opt_seed_warp): every cell written from the table as it stood before
    the step, each cell once (lane l takes the lengths 4 + l, 4 + l +
    lanes, ...; the trailing literals price cells[first_len] as the seed
    sets it).  Returns the dependent steps, ceil((first_len - 3) /
    ``lanes``)."""
    writes = {r: [_lit_price(llen + r), 0, 1, llen + r] for r in range(MIN_MATCH)}
    for m in range(MIN_MATCH, first_len + 1):
        writes[m] = [_seq_price(llen, m), first_off, m, llen]
    for a in range(1, TRAILING + 1):
        writes[first_len + a] = [_seq_price(llen, first_len) + _lit_price(a), 0, 1, a]
    for p, cell in writes.items():
        o[p] = cell
    return _lanes_steps(first_len - MIN_MATCH + 1, lanes)


def opt_add_warp(o: list, cur: int, new_len: int, new_off: int, last: int,
                 lanes: int = 32) -> tuple[int, int]:
    """`encode_hc.opt_add` as the warp runs it (`lz4_hc_body.cuh`
    opt_add_warp): the literal extensions and every match length priced
    from the table as it stood before the step, each cell written at most
    once (lane l takes the lengths 4 + l, 4 + l + ``lanes``, ...); the lane
    of new_len moves ``last``; then, after the lanes' writes, the trailing
    literals.  Returns (the new last, the dependent steps, ceil((new_len -
    3) / ``lanes``))."""
    base_p, _, mlen, base_ll = o[cur]
    writes = {}
    for ext in range(1, MIN_MATCH):
        price = base_p - _lit_price(base_ll) + _lit_price(base_ll + ext)
        if price < o[cur + ext][0]:
            writes[cur + ext] = [price, 0, 1, base_ll + ext]
    if mlen == 1:
        ll = base_ll
        base = o[cur - ll][0] if cur > ll else 0
    else:
        ll, base = 0, base_p
    moved = last
    for m in range(MIN_MATCH, new_len + 1):
        p = cur + m
        price = base + _seq_price(ll, m)
        if p > last + TRAILING or price <= o[p][0]:
            if m == new_len and last < p:
                moved = p
            writes[p] = [price, new_off, m, ll]
    for p, cell in writes.items():
        o[p] = cell
    _trailing(o, moved)
    return moved, _lanes_steps(new_len - MIN_MATCH + 1, lanes)


def opt_parse_rounds_row(s: bytes, src_off: int, t: list, search, sufficient: int,
                         lanes: int = 32, tally: dict | None = None,
                         full: bool = False) -> bytearray:
    """The OPT parse of s[src_off:] (`encode_hc.opt_parse_row`) as
    `opt_parse` (``full``, level 12) and `opt_parse_spec` (levels 10-11)
    run it, ``lanes`` searches a round.

    ``t`` is the row's `opt_matches` table as (length, offset) pairs;
    ``search(p, m)`` makes the search at p for a match longer than m on the
    spot, (length, offset, chain steps), (0, 0, steps) for none.  Exact for
    two reasons.  A search whose minimum length m is 3 or less gives what
    the min-length-3 search gives (the quick reject reads two bytes inside
    the 4-byte compare, and every length the search measures is at least
    4), so it reads ``t`` unless the entry gave up; with ``full`` every
    search has m = 3.  A search that finds nothing changes nothing (the
    parse moves on before it writes a price or ``last``), so from one state
    every position up to the first match is skipped (with ``full``, by
    level 12's test: o[cur + 1] no dearer than o[cur] and o[cur + 4] below
    it + 3) or searched with the minimum length that state gives.  At
    levels 10-11 a round therefore takes the next ``lanes`` positions the
    state does not skip, makes all their searches, and commits them in
    order up to the first that finds a match, which it applies
    (`opt_add_warp`); each round asserts that the committed lanes are the
    positions, and their minimum lengths those, of the serial loop walked
    over the live state.  With ``full`` no search depends on the state, so
    a round reads the entries of the next ``lanes`` positions and commits
    their matches in order, each the first position past the last commit
    that the live state does not skip and whose entry (or search on the
    spot, where it gave up) has a match: the serial loop's next search,
    which each commit asserts by walking level 12's skip test from the last
    commit to it over the live cells.
    Where a window starts, it reads ``lanes`` table entries and takes the
    first that is not (0, 0).

    ``tally``, if given, adds: windows, rounds (with ``full``, reads of
    ``lanes`` entries), rounds (with ``full``, commit steps) in which a lane
    searched on the spot, table reads, searches made on the spot and their
    chain steps, `table_steps` (ceil((length - 3) / ``lanes``) per window
    seed and per match priced), and `steps`, the dependent steps the parse
    needs: one per window-start read and per round, a round's (with
    ``full``, each commit step's, and one per round) being the longest
    chain walk among the lanes it commits up to (at least one), plus the
    chain steps of a window start's search made on the spot, plus
    `table_steps`.  `speculative_steps` counts each as its longest lane's
    walk, the lanes past the commit included, as the warp runs it.
    `serial_steps` is what one thread's walk of the same parse takes:
    `visited` (positions the serial loop looks at), `priced` (match lengths
    its seeds and steps write) and the chain steps of the searches it makes
    on the spot."""
    n = len(s)
    out = bytearray()
    anchor = ip = src_off
    tl = _rounds_tally()
    if n - src_off >= MF_LIMIT + 1:
        ip, anchor, _ = opt_rounds_walk(s, t, search, sufficient, lanes, tl, full, ip, anchor,
                                        n - MF_LIMIT, out)
    tl["serial_steps"] += tl["visited"]
    emit(out, s, anchor, n - anchor, 0, 0)
    if tally is not None:
        for key, v in tl.items():
            tally[key] = tally.get(key, 0) + v
    return out


def _rounds_tally() -> dict:
    return dict.fromkeys(("windows", "rounds", "search_rounds", "table_reads", "searches",
                          "search_steps", "table_steps", "steps", "speculative_steps",
                          "visited", "priced", "serial_steps"), 0)


def opt_rounds_walk(s: bytes, t: list, search, sufficient: int, lanes: int, tl: dict,
                    full: bool, ip: int, anchor: int, mf_limit: int, out, put=emit,
                    stop=None) -> tuple[int, int, bool]:
    """The loop of `opt_parse_rounds_row` from the state (``ip``,
    ``anchor``) up to ``mf_limit``, its sequences given to ``put(out, s,
    anchor, ll, off, ml)`` and its counts added to ``tl``; ``stop(ip,
    anchor)``, if given, is asked at the top of every turn of the loop (a
    window's start, or the next ``lanes`` positions read where none had a
    match), and True ends the walk there.  Returns (ip, anchor, whether
    ``stop`` ended it)."""
    def is_open(q):
        return o[q + 1][0] > o[q][0] or (full and o[q + MIN_MATCH][0] >= o[q][0] + 3)

    def min_len(q):
        return MIN_MATCH - 1 if full else last - q

    def priced(count, steps):
        tl["priced"] += count
        tl["serial_steps"] += count
        tl["table_steps"] += steps
        tl["steps"] += steps
        tl["speculative_steps"] += steps

    o = [[0, 0, 0, 0] for _ in range(OPT_NUM + TRAILING)]
    last = 0

    def on_the_spot(p, m):
        ln, off, steps = search(p, m)
        tl["searches"] += 1
        tl["search_steps"] += steps
        return ln, off, steps

    while ip <= mf_limit:
        if stop is not None and stop(ip, anchor):
            return ip, anchor, True
        seen = [t[q] for q in range(ip, min(ip + lanes, mf_limit + 1))]
        tl["table_reads"] += len(seen)
        tl["steps"] += 1
        tl["speculative_steps"] += 1
        k = next((j for j, e in enumerate(seen) if e[0] != 0), None)
        tl["visited"] += len(seen) if k is None else k + 1
        if k is None:
            ip += lanes
            continue
        ip += k
        first_len, first_off = seen[k]
        if first_len < 0:  # gave up in the match pass
            first_len, first_off, steps = on_the_spot(ip, MIN_MATCH - 1)
            tl["steps"] += steps
            tl["speculative_steps"] += steps
            tl["serial_steps"] += steps
        if first_len == 0:
            ip += 1
            continue
        tl["windows"] += 1
        llen = ip - anchor
        if first_len > sufficient:
            put(out, s, anchor, llen, first_off, first_len)
            ip += first_len
            anchor = ip
            continue
        priced(first_len - MIN_MATCH + 1,
               opt_seed_warp(o, llen, first_len, first_off, lanes))
        last = first_len
        early = False
        cur = 1
        while True:  # one round
            end = min(last, mf_limit - ip + 1)
            if cur >= end:
                break
            if full:  # the next `lanes` positions' entries, their matches in order
                base = cur
                ents = [list(t[ip + q]) if ip + q <= mf_limit else [0, 0]
                        for q in range(base, base + lanes)]
                tl["rounds"] += 1
                tl["table_reads"] += lanes
                tl["steps"] += 1
                tl["speculative_steps"] += 1
                while True:  # one commit: the live state's first open lane with a match
                    live = [cur <= base + j < end and is_open(base + j) for j in range(lanes)]
                    walks, searched = {}, tl["searches"]
                    for j in range(lanes):
                        if live[j] and ents[j][0] < 0:  # gave up in the match pass
                            ln, off, steps = on_the_spot(ip + base + j, MIN_MATCH - 1)
                            ents[j] = [ln, off]
                            walks[j] = steps
                    tl["search_rounds"] += tl["searches"] > searched
                    k = next((j for j in range(lanes) if live[j] and ents[j][0] != 0), None)
                    q = cur  # the serial loop over the live cells, up to the commit
                    while q < (base + k if k is not None else min(end, base + lanes)):
                        assert ((o[q + 1][0] <= o[q][0] and o[q + MIN_MATCH][0] < o[q][0] + 3)
                                or ents[q - base][0] == 0), (
                            f"commit at {ip + cur}: the serial loop takes {ip + q}, "
                            "which the round passed over")
                        q += 1
                    assert k is None or (q == base + k < end and not (
                        o[q + 1][0] <= o[q][0] and o[q + MIN_MATCH][0] < o[q][0] + 3)), (
                        f"commit at {ip + cur}: the round takes {ip + q}, which the serial "
                        "loop skips")
                    committed = [w for j, w in walks.items() if k is None or j <= k]
                    tl["steps"] += max([1, *committed])
                    tl["speculative_steps"] += max([1, *walks.values()])
                    tl["serial_steps"] += sum(committed)
                    tl["visited"] += (base + k + 1 if k is not None
                                      else max(cur, min(end, base + lanes))) - cur
                    if k is None:
                        cur = base + lanes
                        break
                    cur = base + k
                    new_len, new_off = ents[k]
                    if new_len > sufficient or new_len + cur >= OPT_NUM:
                        best_mlen, best_off = new_len, new_off
                        last = cur + 1
                        early = True
                        break
                    last, steps = opt_add_warp(o, cur, new_len, new_off, last, lanes)
                    priced(new_len - MIN_MATCH + 1, steps)
                    cur += 1
                    end = min(last, mf_limit - ip + 1)
                    if cur >= end:
                        break
                if early:
                    break
                continue
            picked, q = [], cur  # (position, minimum length) of each lane
            while q < end and len(picked) < lanes:
                if is_open(q):
                    picked.append((q, min_len(q)))
                q += 1
            nxt = picked[-1][0] + 1 if len(picked) == lanes else end
            found, walks, searched = [], [], tl["searches"]
            for c, m in picked:
                e = t[ip + c]
                if m <= MIN_MATCH - 1 and e[0] >= 0:
                    tl["table_reads"] += 1
                    found.append(tuple(e))
                    walks.append(0)
                    continue
                ln, off, steps = on_the_spot(ip + c, m)
                found.append((ln, off))
                walks.append(steps)
            tl["rounds"] += 1
            tl["search_rounds"] += tl["searches"] > searched
            k = next((j for j, f in enumerate(found) if f[0] != 0), None)
            committed = walks[:len(walks) if k is None else k + 1]
            tl["steps"] += max([1, *committed])
            tl["speculative_steps"] += max([1, *walks])
            tl["serial_steps"] += sum(committed)
            tl["visited"] += (picked[k][0] + 1 if k is not None else nxt) - cur
            q = cur  # the serial loop over the live state, up to the commit
            for c, m in picked[:len(committed)]:
                while q < c:
                    assert q < last and ip + q <= mf_limit and not is_open(q), (
                        f"round at {ip + cur}: the serial loop searches {ip + q}, "
                        "which no lane took")
                    q += 1
                assert is_open(q) and min_len(q) == m, (
                    f"round at {ip + cur}: the lane at {ip + c} searched with minimum "
                    f"length {m}, the serial loop would not search there or with "
                    f"{min_len(q)}")
                q += 1
            if k is None:
                cur = nxt
                continue
            cur = picked[k][0]
            new_len, new_off = found[k]
            if new_len > sufficient or new_len + cur >= OPT_NUM:
                best_mlen, best_off = new_len, new_off
                last = cur + 1
                early = True
                break
            last, steps = opt_add_warp(o, cur, new_len, new_off, last, lanes)
            priced(new_len - MIN_MATCH + 1, steps)
            cur += 1
        if not early:
            best_mlen, best_off = o[last][2], o[last][1]
            cur = last - best_mlen
        ip, anchor = opt_encode(out, s, o, cur, best_mlen, best_off, last, ip, anchor,
                                put)
    return ip, anchor, False


def opt_parse_rounds_plain(base_u8, starts, src_offs, lens, prev, matches, bcap: int,
                           depth: int, sufficient: int, full: bool, lanes: int = 32,
                           counts: list | None = None):
    """The parse as the kernels run it: `opt_parse_rounds_row` over each
    row with ``lanes`` searches a round (``full``: level 12's `opt_parse`,
    else `opt_parse_spec`), each search on the spot made by a
    `TableFinder`; ``counts``, if given, gets one tally per row."""
    if lanes < 1:
        raise ValueError("lanes must be at least 1")
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu()
    table = _table(matches, total, 2, "matches", base.device).cpu()
    raw = base.cpu().numpy()
    comps = []
    for a, off, n, at in zip(st.tolist(), so.tolist(), ln.tolist(), toff.tolist()):
        s = raw[a:a + n].tobytes()
        finder = TableFinder(s, n - LAST_LITERALS, depth, prev[at:at + n].tolist())

        def search(p, min_len, finder=finder):
            steps = finder.steps
            ml, _, mp = finder.wider_match(p, p, min_len, True, True)
            got = (ml, p - mp) if ml > min_len and mp >= 0 else (0, 0)
            return (*got, finder.steps - steps)

        tally = {} if counts is not None else None
        comps.append(opt_parse_rounds_row(s, off, table[at:at + n].tolist(), search,
                                          sufficient, lanes, tally, full))
        if counts is not None:
            counts.append(tally)
    return pack_rows(comps, align1024(compress_bound(bcap)), base.device)


def opt_parse_spec_plain(base_u8, starts, src_offs, lens, prev, matches, bcap: int,
                         depth: int = 96, sufficient: int = 64, lanes: int = 32,
                         counts: list | None = None):
    """The plain PyTorch version of `opt_parse_spec`: `opt_parse_rounds_row`
    with ``lanes`` searches a round, each made by a `TableFinder`.
    ``counts``, if given, gets one tally per row (`opt_parse_rounds_row`)."""
    return opt_parse_rounds_plain(base_u8, starts, src_offs, lens, prev, matches, bcap, depth,
                                  sufficient, False, lanes, counts)


def opt_segment_caps(segment: int, overlap: int) -> tuple[int, int, int]:
    """A walk's capacities at levels 10-11 (`csrc/parse_segments.cuh`):
    the states kept from its start (head) and past its segment's end
    (tail), and its sequences.  Its states lie where a sequence ends, so
    two are at least 4 positions apart; its sequences start from its
    segment's start to its stop, or in the window (up to `OPT_NUM`
    positions) that crosses it."""
    return overlap // 4 + 2, overlap // 4 + 2, (segment + overlap + OPT_NUM) // 4 + 2


def opt_parse_segments_plain(base_u8, starts, src_offs, lens, prev, matches, bcap: int,
                             depth: int = 96, sufficient: int = 64,
                             segment: int = OPT_SEGMENT, overlap: int = OPT_OVERLAP,
                             max_rounds: int = SEGMENT_ROUNDS, counts: list | None = None):
    """`opt_parse_spec` by the kernels' schedule (`parse_segments.schedule`),
    a model for the tests and the step count (no path runs it): each row's
    parse cut into segments of ``segment`` positions, each walked by the
    parse by rounds (`opt_rounds_walk`, 32 lanes) from a guessed state
    until ``overlap`` positions past its end, the walks linked where their
    states (ip, anchor; recorded where ip == anchor) meet, the others
    walked again from their predecessors' end states for up to
    ``max_rounds`` rounds, then one after another.  Returns the bytes of
    `opt_parse_spec_plain`; ``counts``, if given, gets one tally per row
    (`parse_segments.schedule`'s, each walk's dependent steps the rounds
    model's `steps`)."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu()
    table = _table(matches, total, 2, "matches", base.device).cpu()
    raw = base.cpu().numpy()
    head, tail_cap, seq_cap = opt_segment_caps(segment, overlap)
    comps = []
    for a, off, n, at in zip(st.tolist(), so.tolist(), ln.tolist(), toff.tolist()):
        s = raw[a:a + n].tobytes()
        t = table[at:at + n].tolist()
        finder = TableFinder(s, n - LAST_LITERALS, depth, prev[at:at + n].tolist())

        def search(p, min_len, finder=finder):
            steps = finder.steps
            ml, _, mp = finder.wider_match(p, p, min_len, True, True)
            got = (ml, p - mp) if ml > min_len and mp >= 0 else (0, 0)
            return (*got, finder.steps - steps)

        def walk(start, stop, _exact, s=s, t=t, search=search, mf_limit=parse_limit(off, n)):
            w = Walk(start)
            tl = _rounds_tally()

            def put(_, __, anchor, ll, off, ml):
                w.seqs.append((anchor + ll, off, ml))

            def top(ip, anchor):
                if ip == anchor:
                    w.states.append((ip, 0, len(w.seqs), anchor))
                return stop is not None and ip >= stop

            ip, anchor, stopped = opt_rounds_walk(s, t, search, sufficient, 32, tl, False,
                                                  start[0], start[1], mf_limit, None,
                                                  put, top)
            w.end = (ip, anchor, 0) if stopped else None
            w.steps = tl["steps"]
            w.free = tl["windows"] == 0
            return w

        tally = {}
        seqs, anchor = schedule(off, n, segment, overlap, head, tail_cap, seq_cap, max_rounds,
                                walk, tally)
        comps.append(encode_seqs(s, off, seqs, anchor))
        if counts is not None:
            counts.append(tally)
    return pack_rows(comps, align1024(compress_bound(bcap)), base.device)


def segment_rows(src_offs, lens, segment: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The segments of a launch of the parses by segments: (segoff int32
    [B + 1], row r's segments [segoff[r], segoff[r + 1]), at least one a
    row; seg_row int32 [the segments], each one's row)."""
    k = torch.tensor([max(1, segment_count(o, n, segment))
                      for o, n in zip(torch.as_tensor(src_offs).tolist(),
                                      torch.as_tensor(lens).tolist())], dtype=torch.int64)
    segoff = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(k, 0)])
    return segoff.to(torch.int32), torch.repeat_interleave(
        torch.arange(k.numel(), dtype=torch.int32), k)


def opt_parse_spec(base_u8, starts, src_offs, lens, prev, matches, bcap: int,
                   depth: int = 96, sufficient: int = 64, segment: int = OPT_SEGMENT,
                   overlap: int = OPT_OVERLAP, max_rounds: int = SEGMENT_ROUNDS):
    """The level 10-11 price parse of each row's block, its searches a
    search whose minimum length is 3 or less read from ``matches``
    (`opt_matches`' table of the same rows, made with ``depth``), any
    other, or one that gave up there, made on the spot (``depth`` steps)
    over ``prev`` (`opt_chain`'s table).

    Returns (out uint8 [B, OCAP], clens int32 [B], errs int32 [B]) as
    `encode_stream.encode_windows` does, OCAP = align1024(compress_bound(
    bcap)).  A CPU tensor runs the plain version (`opt_parse_spec_plain`,
    the same bytes); a CUDA tensor launches the kernels of the parse by
    segments (counted once here; `opt_parse_segments_plain` is their
    model): ``max_rounds`` rounds of warps walking every row's segments of
    ``segment`` positions on by ``overlap`` (the parse by rounds of
    `opt_parse_rounds_row` from each segment's state), their links checked
    after each, the serial tail and the emit.  ``opt_parse_spec.stats``
    then holds the launch's counts (int32 [max_rounds + 4], on the card:
    each round's walks, the tail's, a record overflow flag (never set),
    links behind a frontier (0 here), the links kept)."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device)
    matches = _table(matches, total, 2, "matches", base.device)
    if st.numel() and int((ln - so).max()) > bcap:
        raise ValueError(f"block lengths must lie in [0, bcap={bcap}]")
    _check_segments(segment, overlap, max_rounds)
    if base.device.type != "cuda":
        return opt_parse_spec_plain(base, st, so, ln, prev, matches, bcap, depth, sufficient)
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
    lib.lz4t_opt_seg_scratch(nseg, nb, segment, overlap, ctypes.addressof(size))
    scratch = torch.empty(size.value, dtype=torch.uint8, device=dev)
    stats = torch.empty(max_rounds + 4, dtype=torch.int32, device=dev)
    st_d, so_d, ln_d, toff_d, segoff_d, seg_row_d = (
        t.to(dev) for t in (st, so, ln, toff, segoff, seg_row))
    with torch.cuda.device(dev):
        rc = lib.lz4t_opt_parse_spec(
            base.data_ptr(), st_d.data_ptr(), so_d.data_ptr(), ln_d.data_ptr(),
            toff_d.data_ptr(), prev.data_ptr(), matches.data_ptr(), out.data_ptr(),
            out.shape[1], out.shape[1], depth, sufficient, clens.data_ptr(),
            errs.data_ptr(), nb, segoff_d.data_ptr(), seg_row_d.data_ptr(), nseg, segment,
            overlap, max_rounds, scratch.data_ptr(), stats.data_ptr(), _stream(dev))
    check(rc, "opt_parse_spec")
    opt_parse_spec.launches += 1
    opt_parse_spec.stats = stats
    return out, clens, errs


def _check_segments(segment: int, overlap: int, max_rounds: int):
    if segment < 16 or overlap < 0 or max_rounds < 0:
        raise ValueError("segment must be at least 16 positions, overlap and max_rounds "
                         "at least 0")


def segment_stats(stats, max_rounds: int) -> dict:
    """A parse by segments' counts (`opt_parse_spec.stats`,
    `encode_hc_passes.hc_parse.stats`) by name."""
    v = torch.as_tensor(stats).cpu().tolist()
    walks = v[:max_rounds]
    return {"walks_per_round": walks, "rounds": sum(1 for w in walks if w),
            "tail_walks": v[max_rounds], "overflow": v[max_rounds + 1],
            "links_behind_frontier": v[max_rounds + 2], "links": v[max_rounds + 3]}


# ---- the three passes over a batch ---------------------------------------

def row_groups(lens) -> list[tuple[int, int]]:
    """Consecutive [first, end) row ranges whose tables fit
    `GROUP_TABLE_BYTES` (a row larger than that makes a group of its own)
    and whose rows fit one match-pass launch.  A row's tables are the
    larger of its TABLE_BYTES a position and prev beside the chain pass's
    scratch (`chain_scratch_bytes`: 8 bytes a position for rows of whole
    segments, up to 16 for a row just over one segment)."""
    cap = GROUP_TABLE_BYTES
    groups, first, size = [], 0, 0
    for r, n in enumerate(torch.as_tensor(lens).tolist()):
        # the chain pass's scratch beside prev, freed before the match table
        need = max(n * TABLE_BYTES, 4 * n + chain_scratch_bytes(n))
        if r > first and (size + need > cap or r - first == MAX_GROUP_ROWS):
            groups.append((first, r))
            first, size = r, 0
        size += need
    groups.append((first, len(torch.as_tensor(lens))))
    return groups


def encode_windows_opt_passes(base_u8, starts, src_offs, lens, bcap: int,
                              level: int = 12):
    """`encode_stream.encode_windows` at levels 10 and up: on each group of
    rows (`row_groups`), `opt_chain`, `opt_matches` with the level's depth,
    and `opt_parse` (level 12 and up) or `opt_parse_spec` (10-11), one
    launch of each on a CUDA tensor, their plain versions on a CPU tensor.
    Returns (out, clens, errs) as `encode_windows` does, the same bytes as
    kernel D's serial OPT arm."""
    arm, depth, sufficient, full = level_arm(level)
    if arm != "opt":
        raise ValueError(f"level {level} is not an OPT level (10 and up)")
    parse = opt_parse if full else opt_parse_spec
    base, st, so, ln, _, _ = _rows(base_u8, starts, src_offs, lens)
    parts = []
    for g0, g1 in row_groups(ln):
        rows = st[g0:g1], so[g0:g1], ln[g0:g1]
        prev = opt_chain(base, rows[0], rows[2])
        matches = opt_matches(base, *rows, prev, depth)
        parts.append(parse(base, *rows, prev, matches, bcap, depth, sufficient))
        del prev, matches
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(ts) for ts in zip(*parts))


opt_chain.launches = 0
opt_matches.launches = 0
opt_parse.launches = 0
opt_parse_spec.launches = 0
opt_parse_spec.stats = None
