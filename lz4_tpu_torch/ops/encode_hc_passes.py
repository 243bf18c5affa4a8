"""The HC arm (levels 3-9) as passes: the chain pass of level 12
(`encode_opt.opt_chain`), then kernels `hc_deltas` and `hc_parse`
(`csrc/encode_hc_passes.cu`), and their plain versions.

The port, at levels 3-9, of the HC arm `hc_body` of `pallas_encode5`
(`lz4_tpu/ops/encode_pallas5.py:953`) and of `pallas_encode_stream`'s HC
arm (`lz4_tpu/ops/encode_pallas_stream.py:266`), with the bytes of
`encode_hc.encode_hc`.  The HC parse runs in episodes (`encode_hc.
hc_episode`): a first search at ip, then the lookahead searches that
follow from its answers, until control returns to the top of the parse.
Every search is made with the positions below the row's frontier (the
highest position searched so far) inserted in the chain, which the ring's
answers at that frontier give (`FrontierFinder`, csrc FrontierChain, over
prev and the deltas).  So the parse from a state (ip, the frontier raised
to ip) depends on the window and that state alone, and the passes build
the chain of every position of a row (`opt_chain`), each position's chain
step as a u16 (`hc_deltas`), then run the parse with each row cut into
segments of `HC_SEGMENT` positions walked at once and joined where their
states meet (`hc_parse`, `parse_segments`; `hc_parse_segments_plain` is
its model).  A walk makes every search of its episodes on the spot: the
serial arm's searches, where the parse needs them and nowhere else.

Table layout: `opt_chain`'s prev holds every window position back to back
(`encode_opt.table_offsets`); `deltas` holds every window position's
chain step, min(p - prev[p], 0xFFFF), as the bits of a u16 (int16
storage), laid out as prev.  `encode_windows_hc_passes` runs the passes on
the OPT passes' groups of rows (`encode_opt.row_groups`).  A CPU tensor
runs each pass's plain version; a CUDA tensor launches its kernel (counted
on the wrapper) or raises.  `encode_stream.encode_windows` sends levels 3-9
here only on a CUDA tensor: on a CPU tensor it keeps the serial plain
parse (`encode_hc.encode_hc`, the same bytes), as level 12 keeps
`encode_hc.encode_opt`.

The frontier property: the serial arm inserts into its chain up to each
search position, so a search made below an earlier one sees positions at
or above it in the chain, and its 64 K delta ring aliased.  No such search
has been seen (`tests/test_torch_hc_table.py`), and `FrontierFinder`
answers it as the ring would all the same.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import LAST_LITERALS, MF_LIMIT, compress_bound
from .build import check, load
from .common import align1024, read32
from .encode import _outputs, pack_rows
from .encode_hc import Capped, _hash, hc_episode, hc_parse_row, level_arm
from .encode_opt import (
    MAX_GROUP_ROWS, SEGMENT_ROUNDS, TableFinder, _check_segments, _rows, _stream, _table,
    opt_chain, row_groups, segment_rows, table_offsets,
)
from .parse_segments import Walk, encode_seqs, parse_limit, schedule

# The parse's segments (`csrc/parse_segments.cuh` kHcSegment,
# kHcOverlap): a thread walks the parse positions [s_k, s_k + HC_SEGMENT)
# of a row from a guessed state and goes on HC_OVERLAP positions past them,
# where the walk before links to it (`parse_segments`).
HC_SEGMENT = 512
HC_OVERLAP = 128

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("encode_hc_passes")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lz4t_hc_deltas.argtypes = [p, p, p, p, i, i, p]
        lib.lz4t_hc_parse.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, p, p, i, p, p, i, i, i,
                                       i, p, p, p]
        lib.lz4t_hc_seg_scratch.argtypes = [ll, i, i, i, p]
        for fn in (lib.lz4t_hc_deltas, lib.lz4t_hc_parse, lib.lz4t_hc_segment,
                   lib.lz4t_hc_overlap, lib.lz4t_hc_seg_scratch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _deltas(deltas, total: int, dev) -> torch.Tensor:
    """Checked `hc_deltas` output of ``total`` window positions."""
    deltas = torch.as_tensor(deltas)
    if deltas.dtype != torch.int16 or tuple(deltas.shape) != (total,):
        raise ValueError(f"deltas must be int16 [{total}]")
    if deltas.device != dev:
        raise ValueError(f"deltas must lie on the windows' device {dev}")
    return deltas.contiguous()


# ---- pass 2: every position's chain step ---------------------------------

def deltas_plain(prev: torch.Tensor, lens) -> torch.Tensor:
    """The plain PyTorch version of `hc_deltas`."""
    pos = torch.cat([torch.arange(int(n), dtype=torch.int64)
                     for n in torch.as_tensor(lens).tolist()] or
                    [torch.zeros(0, dtype=torch.int64)])
    d = (pos - prev.cpu().to(torch.int64)).clamp(max=0xFFFF)
    return torch.where(d >= 0x8000, d - 0x10000, d).to(torch.int16).to(prev.device)


def hc_deltas(prev, lens) -> torch.Tensor:
    """Each window position's chain step min(p - prev[p], 0xFFFF) from
    `encode_opt.opt_chain`'s table ``prev`` of rows of ``lens`` positions,
    as the bits of a u16 in int16 [sum(lens)], laid out as prev: the steps
    the parse's searches read (half prev's bytes).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    once (counted here)."""
    ln = torch.as_tensor(lens, dtype=torch.int32).cpu()
    toff, total = table_offsets(ln)
    prev = torch.as_tensor(prev)
    prev = _table(prev, total, 1, "prev", prev.device)
    if prev.device.type != "cuda":
        return deltas_plain(prev, ln)
    dev = prev.device
    nb = ln.numel()
    if nb > MAX_GROUP_ROWS:
        raise ValueError(f"at most {MAX_GROUP_ROWS} rows per launch")
    deltas = torch.empty((total,), dtype=torch.int16, device=dev)
    if nb == 0 or total == 0:
        return deltas
    ln_d, toff_d = ln.to(dev), toff.to(dev)
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_hc_deltas(ln_d.data_ptr(), toff_d.data_ptr(), prev.data_ptr(),
                                      deltas.data_ptr(), nb, int(ln.max()), _stream(dev))
    check(rc, "hc_deltas")
    hc_deltas.launches += 1
    return deltas


# ---- pass 3: the parse ----------------------------------------------------

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


def _spot_rows(base, st, so, ln, prev, deltas, depth: int):
    """Each row's window, block start, length and `encode_hc.hc_parse_row`
    search factory for `hc_parse_plain`: every search of the episode at ip
    made by the row's `FrontierFinder` at the row's frontier; with the
    finder and a tally (episodes, searches, their chain steps)."""
    deltas = (deltas.cpu().to(torch.int32) & 0xFFFF).tolist()
    raw = base.cpu().numpy()
    pa = depth > 128
    toff, _ = table_offsets(ln)
    for a, off, n, at in zip(st.tolist(), so.tolist(), ln.tolist(), toff.tolist()):
        s = raw[a:a + n].tobytes()
        finder = FrontierFinder(s, n - LAST_LITERALS, depth, prev[at:at + n].tolist(), off)
        finder.table_delta = deltas[at:at + n]
        tally = {"episodes": 0, "searches": 0, "steps": 0}

        def search(ip, ilow, longest, finder=finder, tally=tally):
            tally["searches"] += 1
            steps = finder.steps
            got = finder.wider_match(ip, ilow, longest, pa)
            tally["steps"] += finder.steps - steps
            return got

        def episode_search(p, search=search, tally=tally):
            tally["episodes"] += 1
            return search

        yield s, off, n, episode_search, finder, tally


def hc_parse_plain(base_u8, starts, src_offs, lens, prev, deltas, bcap: int,
                   depth: int = 256, counts: list | None = None):
    """The plain PyTorch version of `hc_parse`: `encode_hc.hc_parse_row`
    with every search made by a `FrontierFinder` over prev and the deltas
    at the row's frontier.  ``counts``, if given, gets one dict per row:
    its episodes, its searches and their chain steps."""
    base, st, so, ln, _, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu()
    deltas = _deltas(deltas, total, base.device)
    comps = []
    for s, off, _, episode_search, _, tally in _spot_rows(base, st, so, ln, prev, deltas, depth):
        comps.append(hc_parse_row(s, off, episode_search))
        if counts is not None:
            counts.append(tally)
    return pack_rows(comps, align1024(compress_bound(bcap)), base.device)


def hc_segment_caps(segment: int, overlap: int) -> tuple[int, int, int]:
    """A walk's capacities at levels 3-9 (`csrc/parse_segments.cuh`): the
    states kept from its start (head) and past its segment's end (tail),
    and its sequences.  Every episode's start is a state, one a position at
    most; its sequences, 4 positions each at least, start from its
    segment's start to its stop, and up to 256 more in the episode that
    crosses the stop (a row whose kept walks held more is flagged in
    errs on the card)."""
    return overlap + 2, overlap + 2, (segment + overlap) // 4 + 258


def hc_parse_segments_plain(base_u8, starts, src_offs, lens, prev, deltas, bcap: int,
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
    one after another.  A walk measures no match or pattern run more than
    ``segment`` positions past its stop (`encode_hc.ChainFinder.cap`), but
    in its first episode from an exact start: an episode that would ends
    the walk at the state where it began, its sequences dropped.  Asserts
    at every link that the frontier there is
    at ip.  Returns the bytes of `hc_parse_plain`; ``counts``, if given,
    gets one tally per row (`parse_segments.schedule`'s, each walk's
    dependent steps its episodes plus its searches' chain steps)."""
    base, st, so, ln, _, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu()
    deltas = _deltas(deltas, total, base.device)
    head, tail_cap, seq_cap = hc_segment_caps(segment, overlap)
    comps = []
    for s, off, n, episode_search, finder, tally in _spot_rows(base, st, so, ln, prev, deltas,
                                                               depth):
        def walk(start, stop, exact, s=s, episode_search=episode_search, finder=finder,
                 tally=tally, mf_limit=parse_limit(off, n), episode_limit=n - MF_LIMIT):
            w = Walk(start, keyed=True)
            ip, anchor, finder.frontier = start
            before = tally["episodes"] + tally["steps"]

            def put(_, __, anchor, ll, off, ml):
                w.seqs.append((anchor + ll, off, ml))

            first = True
            while ip <= mf_limit:
                state = (ip, anchor, max(finder.frontier, ip))
                w.states.append((ip, state[2], len(w.seqs), anchor))
                if stop is not None and ip >= stop:
                    w.end = state
                    break
                # the walk's measures stop a segment past its stop, but in
                # the first episode from an exact start
                finder.cap = None if first and exact or stop is None else stop + segment
                nseq = len(w.seqs)
                try:
                    ip, anchor = hc_episode(s, ip, anchor, episode_limit, episode_search(ip),
                                            None, put)
                except Capped:  # the walk ends where this episode began
                    del w.seqs[nseq:]
                    w.end = state
                    break
                first = False
            finder.cap = None
            w.steps = tally["episodes"] + tally["steps"] - before
            return w

        sched = {}
        seqs, anchor = schedule(off, n, segment, overlap, head, tail_cap, seq_cap, max_rounds,
                                walk, sched)
        for ip, key, _, _ in sched["linked_states"]:
            assert key == ip, f"a link at {ip} with the frontier at {key}, past it"
        comps.append(encode_seqs(s, off, seqs, anchor))
        if counts is not None:
            counts.append(sched)
    return pack_rows(comps, align1024(compress_bound(bcap)), base.device)


def hc_parse(base_u8, starts, src_offs, lens, prev, deltas, bcap: int, depth: int = 256,
             segment: int = HC_SEGMENT, overlap: int = HC_OVERLAP,
             max_rounds: int = SEGMENT_ROUNDS):
    """The HC parse of each row's block (`encode_hc.hc_parse_row`), every
    search made on the spot (``depth`` chain steps) over ``prev``
    (`encode_opt.opt_chain`'s table, for its head) and ``deltas``
    (`hc_deltas`' of the same rows, for its steps), with the ring's answers
    at the row's frontier.

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
    deltas = _deltas(deltas, total, base.device)
    if st.numel() and int((ln - so).max()) > bcap:
        raise ValueError(f"block lengths must lie in [0, bcap={bcap}]")
    _check_segments(segment, overlap, max_rounds)
    if base.device.type != "cuda":
        return hc_parse_plain(base, st, so, ln, prev, deltas, bcap, depth)
    dev = base.device
    nb = st.numel()
    out, clens, errs = _outputs(nb, bcap, dev)
    if nb == 0:
        return out, clens, errs
    base = base.contiguous()
    segoff, seg_row = segment_rows(so, ln, segment)
    nseg = seg_row.numel()
    lib = _kernel()
    scratch = torch.empty(parse_scratch_bytes(so, ln, segment, overlap), dtype=torch.uint8,
                          device=dev)
    stats = torch.empty(max_rounds + 4, dtype=torch.int32, device=dev)
    st_d, so_d, ln_d, toff_d, segoff_d, seg_row_d = (
        t.to(dev) for t in (st, so, ln, toff, segoff, seg_row))
    with torch.cuda.device(dev):
        rc = lib.lz4t_hc_parse(
            base.data_ptr(), st_d.data_ptr(), so_d.data_ptr(), ln_d.data_ptr(),
            toff_d.data_ptr(), prev.data_ptr(), deltas.data_ptr(), out.data_ptr(),
            out.shape[1], out.shape[1], depth, clens.data_ptr(), errs.data_ptr(), nb,
            segoff_d.data_ptr(), seg_row_d.data_ptr(), nseg, segment, overlap, max_rounds,
            scratch.data_ptr(), stats.data_ptr(), _stream(dev))
    check(rc, "hc_parse")
    hc_parse.launches += 1
    hc_parse.stats = stats
    return out, clens, errs


def parse_scratch_bytes(src_offs, lens, segment: int = HC_SEGMENT,
                        overlap: int = HC_OVERLAP) -> int:
    """Device bytes of the parse's records (its walks' sequences and states,
    the links and the schedule's state) for the rows (`hc_parse`)."""
    _, seg_row = segment_rows(src_offs, lens, segment)
    size = ctypes.c_longlong()
    _kernel().lz4t_hc_seg_scratch(seg_row.numel(), len(torch.as_tensor(lens)), segment, overlap,
                                  ctypes.addressof(size))
    return size.value


def parse_segment() -> tuple[int, int]:
    """The built kernel's kHcSegment and kHcOverlap, which `HC_SEGMENT` and
    `HC_OVERLAP` restate."""
    lib = _kernel()
    return lib.lz4t_hc_segment(), lib.lz4t_hc_overlap()


# ---- the passes over a batch ---------------------------------------------

def encode_windows_hc_passes(base_u8, starts, src_offs, lens, bcap: int, level: int = 9):
    """`encode_stream.encode_windows` at levels 3-9: on each group of rows
    (`encode_opt.row_groups`, under 1 GiB of its 12-byte tables a group:
    prev, the deltas and the walks' records take ~22 bytes a window byte
    here, so a payload of tens of GB runs in groups of ~2 GB),
    `encode_opt.opt_chain`, `hc_deltas` and `hc_parse`, one launch of each
    on a CUDA tensor, their plain versions on a CPU tensor.  Returns (out,
    clens, errs) as `encode_windows` does, the same bytes as kernel D's
    serial HC arm."""
    arm, depth, _, _ = level_arm(level)
    if arm != "hc":
        raise ValueError(f"level {level} is not an HC level (3-9)")
    base, st, so, ln, _, _ = _rows(base_u8, starts, src_offs, lens)
    parts = []
    for g0, g1 in row_groups(ln):
        rows = st[g0:g1], so[g0:g1], ln[g0:g1]
        prev = opt_chain(base, rows[0], rows[2])
        deltas = hc_deltas(prev, rows[2])
        parts.append(hc_parse(base, *rows, prev, deltas, bcap, depth))
        del prev, deltas
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(ts) for ts in zip(*parts))


hc_deltas.launches = 0
hc_parse.launches = 0
hc_parse.stats = None
