"""Level 12 of the OPT arm as three passes: kernels `opt_chain`,
`opt_matches` and `opt_parse` (`csrc/encode_opt.cu`) and their plain
versions.

The port, at level 12 and above, of the OPT arm `opt_body` of
`pallas_encode5` (`lz4_tpu/ops/encode_pallas5.py:1172`) and of
`pallas_encode_stream`'s OPT arm (`lz4_tpu/ops/encode_pallas_stream.py`),
with the bytes of `encode_hc.encode_opt`.  At level 12 every search of the
parse is the chain-swap search for a match longer than 3 bytes, and the
arm inserts into the chain only up to the search position, so the search
at p is a function of the row and p alone.  The passes therefore build the
chain of every position of a row (`opt_chain`), search every position at
once (`opt_matches`), then run the price parse with each search read from
that table (`opt_parse`).  Levels 10 and 11 search for matches longer than
a length the price table sets, and stay on kernel D's serial OPT arm.

Rows are kernel D's windows (`encode_stream.encode_windows`): row r is
base_u8[starts[r] : starts[r] + lens[r]], its first src_offs[r] bytes a
prefix that matches may reach.  A table holds every position of every row
back to back, row r from the sum of the lengths before it
(`table_offsets`); the tables take `TABLE_BYTES` per window byte, so
`encode_windows_full` runs the passes on groups of rows under
`GROUP_TABLE_BYTES`.  A CPU tensor runs each pass's plain version; a CUDA
tensor launches its kernel (counted on the wrapper) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import LAST_LITERALS, MF_LIMIT, MIN_MATCH, compress_bound
from .build import check, load
from .common import align1024, read32
from .encode import _outputs, pack_rows
from .encode_hc import ChainFinder, _hash, level_arm, opt_parse_row

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

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("encode_opt")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lz4t_opt_chain.argtypes = [p, p, p, p, p, i, p]
        lib.lz4t_opt_matches.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.lz4t_opt_parse.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, p, p, i, p]
        for fn in (lib.lz4t_opt_chain, lib.lz4t_opt_matches, lib.lz4t_opt_parse,
                   lib.lz4t_opt_chain_shared_bytes, lib.lz4t_opt_parse_shared_bytes):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def shared_bytes() -> dict:
    """Dynamic shared memory of one CTA of the chain and parse passes (the
    match pass takes none)."""
    lib = _kernel()
    return {"opt_chain": lib.lz4t_opt_chain_shared_bytes(),
            "opt_parse": lib.lz4t_opt_parse_shared_bytes()}


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


def opt_chain(base_u8, starts, lens) -> torch.Tensor:
    """The chain of every position of each row: prev int32 [sum(lens)],
    row r's entry p (at `table_offsets` r + p) the previous position of p's
    hash in the row, HC_EMPTY when there is none or p >= lens[r] - 3.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    once (counted here)."""
    base, st, _, ln, toff, total = _rows(base_u8, starts, None, lens)
    if base.device.type != "cuda":
        return opt_chain_plain(base, st, ln)
    dev = base.device
    prev = torch.empty((total,), dtype=torch.int32, device=dev)
    if st.numel() == 0:
        return prev
    base = base.contiguous()
    st_d, ln_d, toff_d = st.to(dev), ln.to(dev), toff.to(dev)
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_opt_chain(
            base.data_ptr(), st_d.data_ptr(), ln_d.data_ptr(), toff_d.data_ptr(),
            prev.data_ptr(), st.numel(), _stream(dev))
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
                      retry_longest: int = RETRY_LONGEST):
    """The plain PyTorch version of `opt_matches`: a `TableFinder`
    search per position, made again with ``budget`` where the first gave up
    with no match longer than ``retry_longest``."""
    base, st, so, ln, toff, total = _rows(base_u8, starts, src_offs, lens)
    prev = _table(prev, total, 1, "prev", base.device).cpu().tolist()
    raw = base.cpu().numpy()
    out = torch.zeros((total, 2), dtype=torch.int32)
    for a, off, n, at in zip(st.tolist(), so.tolist(), ln.tolist(), toff.tolist()):
        if n - off < MF_LIMIT + 1:
            continue
        s = raw[a:a + n].tobytes()
        finder = TableFinder(s, n - LAST_LITERALS, depth, prev[at:at + n])
        found = []
        for p in range(off, n - MF_LIMIT + 1):
            finder.budget = min(first_budget, budget)
            ml, _, mp = finder.wider_match(p, p, MIN_MATCH - 1, True, True)
            if ml < 0 and budget > first_budget and -1 - ml <= retry_longest:
                finder.budget = budget
                ml, _, mp = finder.wider_match(p, p, MIN_MATCH - 1, True, True)
            if ml < 0:
                found.append((ml, 0))
            else:
                found.append((ml, p - mp) if ml > MIN_MATCH - 1 and mp >= 0 else (0, 0))
        out[at + off:at + n - MF_LIMIT + 1] = torch.tensor(found, dtype=torch.int32)
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
    """The plain PyTorch version of `opt_parse`: `encode_hc.opt_parse_row`
    with each search read from the table, or made by a `TableFinder` where
    the match pass gave up."""
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
    """The level 12 price parse of each row's block with its searches read
    from ``matches`` (`opt_matches`' table of the same rows), a search that
    gave up there made in full (``depth`` steps) over ``prev``
    (`opt_chain`'s table).

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


# ---- the three passes over a batch ---------------------------------------

def row_groups(lens) -> list[tuple[int, int]]:
    """Consecutive [first, end) row ranges whose tables fit
    `GROUP_TABLE_BYTES` (a row larger than that makes a group of its own)
    and whose rows fit one match-pass launch."""
    cap = GROUP_TABLE_BYTES
    groups, first, size = [], 0, 0
    for r, n in enumerate(torch.as_tensor(lens).tolist()):
        need = n * TABLE_BYTES
        if r > first and (size + need > cap or r - first == MAX_GROUP_ROWS):
            groups.append((first, r))
            first, size = r, 0
        size += need
    groups.append((first, len(torch.as_tensor(lens))))
    return groups


def encode_windows_full(base_u8, starts, src_offs, lens, bcap: int,
                        level: int = 12):
    """`encode_stream.encode_windows` at level 12 and above: on each group of
    rows (`row_groups`), `opt_chain`, `opt_matches` and `opt_parse`, one
    launch of each on a CUDA tensor, their plain versions on a CPU tensor.
    Returns (out, clens, errs) as `encode_windows` does, the same bytes as
    kernel D's serial OPT arm."""
    arm, depth, sufficient, full = level_arm(level)
    if arm != "opt" or not full:
        raise ValueError(f"level {level} is not a level of the full OPT parse (12 and up)")
    base, st, so, ln, _, _ = _rows(base_u8, starts, src_offs, lens)
    parts = []
    for g0, g1 in row_groups(ln):
        rows = st[g0:g1], so[g0:g1], ln[g0:g1]
        prev = opt_chain(base, rows[0], rows[2])
        matches = opt_matches(base, *rows, prev, depth)
        parts.append(opt_parse(base, *rows, prev, matches, bcap, depth, sufficient))
        del prev, matches
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(ts) for ts in zip(*parts))


opt_chain.launches = 0
opt_matches.launches = 0
opt_parse.launches = 0
