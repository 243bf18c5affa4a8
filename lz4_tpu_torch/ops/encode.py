"""Batched LZ4 block encode of blocks up to 64 KB at every level (kernel B)
and the FAST scans' plain versions.

The port of `lz4_tpu/ops/encode_pallas5.py` (`pallas_encode5`, wrapper
`encode_blocks_pallas5`), with the same bytes.  Every level runs on kernel
D (`csrc/encode_stream.cu`) with the rows as its windows: at levels 0-2 its
FAST scan, one warp per row (the canonical byU16 schedule of
LZ4_compress_default, or the dense 15-bit schedule); at levels 3-9 its HC
arm and at 10-12 its OPT arm (`encode_stream.encode_windows_hc`/`_opt`:
on the card levels 3-9 and 12 as passes; plain versions in
`ops/encode_hc.py`).  The FAST scans' plain versions
live here: the serial scans (`_encode_canonical`, `_encode_dense`), the
reference, and the kernel's batched probe search (`_encode_canonical_warp`,
`_encode_dense_warp`: 32 probes a step, the table's writes inside a step
resolved as the warp resolves them), which gives the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import compress_bound
from .common import align1024, emit, read32, run_length
from .encode_hc import encode_row, level_arm

MIN_MATCH = 4
MF_LIMIT = 12
LAST_LITERALS = 5
SKIP_TRIGGER = 6
MAX_DISTANCE = 65535
MAX_BLOCK = 65536  # kernel B's rows (16-bit tables); larger ones go to D
CANON_64K = 65536 + MF_LIMIT - 1  # upstream LZ4_64Klimit: byU32 at/above
GEOMETRIES = ("canonical", "dense")

WARP = 32  # probes of one step of the kernel's batched search
SERIAL_PROBES = 2  # probes a search makes one at a time before going WARP wide


def _encode_canonical(s: bytes, accel: int) -> bytearray:
    """Upstream one-shot schedule: byU16 (13-bit table, 4-byte hash) below
    65,547 bytes, byU32 (12-bit table, 5-byte hash, candidates farther than
    65,535 bytes skipped) at and above."""
    tab, h = _canon_hash(s, len(s))
    return canonical_block(s, 0, len(s), 0, tab, h, len(s) < CANON_64K, accel)


def canonical_block(s: bytes, start: int, n: int, floor: int, tab, h,
                    u16: bool, accel: int) -> bytearray:
    """Upstream's schedule over the block s[start:n] of a buffer whose bytes
    before ``start`` matches may reach, positions absolute, with the table
    ``tab`` and hash ``h`` carried in (`_canon_hash`): the one-shot rows
    are start = floor = 0 with a fresh table, the continue schedule's
    blocks carry the byU32 table (`encode_continue`).  A block of fewer than
    13 bytes is all literals and leaves the table as it was; a longer one
    inserts its first byte and probes from the next; back-extension stops
    at ``floor``."""
    out = bytearray()
    anchor = start
    if n - start >= MF_LIMIT + 1:
        mf1 = n - MF_LIMIT + 1
        match_limit = n - LAST_LITERALS
        tab[h(start)] = start
        ip = start + 1
        fh = h(ip)
        while True:
            fwd, step, ramp = ip, 1, accel << SKIP_TRIGGER
            while True:
                hh = fh
                ip = fwd
                fwd += step
                step = ramp >> SKIP_TRIGGER
                ramp += 1
                if fwd > mf1:
                    emit(out, s, anchor, n - anchor, 0, 0)
                    return out
                match = tab[hh]
                fh = h(fwd)
                tab[hh] = ip
                if not u16 and match + MAX_DISTANCE < ip:
                    continue
                if read32(s, match) == read32(s, ip):
                    break
            while ip > anchor and match > floor and s[ip - 1] == s[match - 1]:
                ip -= 1
                match -= 1
            while True:
                ml = MIN_MATCH + run_length(
                    s, match + MIN_MATCH, ip + MIN_MATCH, match_limit
                )
                emit(out, s, anchor, ip - anchor, ip - match, ml)
                ip += ml
                anchor = ip
                if ip >= mf1:
                    emit(out, s, anchor, n - anchor, 0, 0)
                    return out
                tab[h(ip - 2)] = ip - 2
                h2 = h(ip)
                m2 = tab[h2]
                tab[h2] = ip
                if not u16 and m2 + MAX_DISTANCE < ip:
                    break
                if read32(s, m2) != read32(s, ip):
                    break
                match = m2
            ip += 1
            fh = h(ip)
    emit(out, s, anchor, n - anchor, 0, 0)
    return out


def _encode_dense(s: bytes, accel: int, src_off: int = 0) -> bytearray:
    """This library's 15-bit greedy finder over s[src_off:], with matches
    reaching into the prefix s[:src_off] (seeded at stride 2)."""
    n = len(s)
    out = bytearray()
    tab = [-1] * (1 << 15)

    def h(w):
        return ((w * 2654435761) & 0xFFFFFFFF) >> 17

    for i in range(0, src_off - MIN_MATCH + 1, 2):
        tab[h(read32(s, i))] = i
    anchor = src_off
    if n - src_off > MF_LIMIT:
        mf_limit = n - MF_LIMIT
        match_limit = n - LAST_LITERALS
        p = src_off
        search = accel << SKIP_TRIGGER
        while p < mf_limit:
            w = read32(s, p)
            hh = h(w)
            cand = tab[hh]
            tab[hh] = p
            if cand >= 0 and p - cand <= MAX_DISTANCE and read32(s, cand) == w:
                while p > anchor and cand > 0 and s[p - 1] == s[cand - 1]:
                    p -= 1
                    cand -= 1
                ml = MIN_MATCH + run_length(
                    s, cand + MIN_MATCH, p + MIN_MATCH, match_limit
                )
                emit(out, s, anchor, p - anchor, p - cand, ml)
                p += ml
                anchor = p
                if p >= mf_limit:
                    break
                tab[h(read32(s, p - 2))] = p - 2
                search = accel << SKIP_TRIGGER
                continue
            p += search >> SKIP_TRIGGER
            search += 1
    emit(out, s, anchor, n - anchor, 0, 0)
    return out


def hash5(v: int) -> int:
    """Upstream LZ4_hash5, the byU32 table's hash of the 5 low bytes of
    ``v`` (`csrc/lz4_encode_body.cuh` `canon_hash5`)."""
    return (((v << 24) * 889523592379) & 0xFFFFFFFFFFFFFFFF) >> 52


def _canon_hash(s: bytes, n: int):
    """The canonical schedule's table and hash: byU16 below 65,547 bytes,
    byU32 at and above."""
    if n < CANON_64K:
        return [0] * (1 << 13), lambda p: (
            ((read32(s, p) * 2654435761) & 0xFFFFFFFF) >> 19)
    return [0] * (1 << 12), lambda p: hash5(int.from_bytes(s[p:p + 8], "little"))


def _probe_step(tab, hash_of, positions, valid, accept):
    """One step of the warp's search over its probes (one, or WARP): each
    valid probe reads the table as it stood when the step began, or the
    position of the latest earlier probe of the step in its bucket
    (`accept` tests a candidate: ("table", value) or ("lane", position)).
    Returns the first probe that hits (the step's width if none) with its
    candidate, the first probe that is not valid (the width if none), and
    a function that makes the table writes of the probes up to a given one
    (in order: the highest of a bucket wins)."""
    hashes = [hash_of(p) if v else None for p, v in zip(positions, valid)]
    latest: dict = {}
    width = len(positions)
    first = width
    cand = None
    for k, (p, v, h) in enumerate(zip(positions, valid, hashes)):
        if not v:
            break
        c = latest.get(h, ("table", tab[h]))
        latest[h] = ("lane", p)
        if first == width and accept(c, p):
            first, cand = k, c
    stop = valid.index(False) if False in valid else width

    def commit(last, value):
        for k in range(last + 1):
            tab[hashes[k]] = value(positions[k])

    return first, cand, stop, commit


def _encode_canonical_warp(s: bytes, accel: int, steps=None) -> bytearray:
    """`_encode_canonical` as kernel D's warp computes it: each search
    makes its first SERIAL_PROBES probes one at a time, then WARP a step
    (`_probe_step`); the bytes are the same.
    ``steps``, a dict, counts the warp's probe steps and sequences."""
    tab, h = _canon_hash(s, len(s))
    return canonical_block_warp(s, 0, len(s), 0, tab, h, len(s) < CANON_64K,
                                accel, WARP, steps)


def canonical_block_warp(s: bytes, start: int, n: int, floor: int, tab, h,
                         u16: bool, accel: int, lanes: int = WARP,
                         steps=None) -> bytearray:
    """`canonical_block` as the warp computes it (`canon_scan` in
    `csrc/lz4_encode_body.cuh`): each search makes its first SERIAL_PROBES
    probes one at a time, then ``lanes`` a step (`_probe_step`; one lane is
    the serial walk); the bytes and the table are the same.  ``steps``, a
    dict, counts the warp's probe steps and sequences."""
    steps = {} if steps is None else steps
    steps.setdefault("probe_steps", 0)
    steps.setdefault("sequences", 0)
    out = bytearray()
    anchor = start
    if n - start >= MF_LIMIT + 1:
        mf1 = n - MF_LIMIT + 1
        match_limit = n - LAST_LITERALS
        ramp = accel << SKIP_TRIGGER

        def accept(c, p):
            m = c[1]
            return (u16 or m + MAX_DISTANCE >= p) and read32(s, m) == read32(s, p)

        tab[h(start)] = start
        first = start + 1
        while True:
            p, j = first, 0
            while True:
                width = 1 if j < SERIAL_PROBES else lanes
                positions, valid = [], []
                for k in range(width):
                    i = j + k
                    positions.append(p)
                    p += (ramp + i - 1) >> SKIP_TRIGGER if i else 1
                    valid.append(p <= mf1)
                first_hit, cand, stop, commit = _probe_step(
                    tab, h, positions, valid, accept)
                steps["probe_steps"] += 1
                if first_hit < stop:
                    commit(first_hit, lambda q: q)
                    ip, match = positions[first_hit], cand[1]
                    break
                if stop < width:  # the probes before it were made: the
                    commit(stop - 1, lambda q: q)  # next block reads them
                    emit(out, s, anchor, n - anchor, 0, 0)
                    return out
                commit(width - 1, lambda q: q)
                j += width
            while ip > anchor and match > floor and s[ip - 1] == s[match - 1]:
                ip -= 1
                match -= 1
            while True:
                ml = MIN_MATCH + run_length(
                    s, match + MIN_MATCH, ip + MIN_MATCH, match_limit
                )
                emit(out, s, anchor, ip - anchor, ip - match, ml)
                steps["sequences"] += 1
                ip += ml
                anchor = ip
                if ip >= mf1:
                    emit(out, s, anchor, n - anchor, 0, 0)
                    return out
                tab[h(ip - 2)] = ip - 2
                h2 = h(ip)
                m2 = tab[h2]
                tab[h2] = ip
                if not u16 and m2 + MAX_DISTANCE < ip:
                    break
                if read32(s, m2) != read32(s, ip):
                    break
                match = m2
            first = ip + 1
    emit(out, s, anchor, n - anchor, 0, 0)
    return out


def dense_seed_warp(s: bytes, src_off: int, tab=None) -> list:
    """The dense scan's prefix seed as the warp makes it: WARP stride-2
    positions a step, the highest of a bucket writing position + 1 (the
    later insert wins).  Returns the table (0 == empty)."""
    tab = [0] * (1 << 15) if tab is None else tab
    for base in range(0, src_off - MIN_MATCH + 1, 2 * WARP):
        step = {}
        for k in range(WARP):
            i = base + 2 * k
            if i + MIN_MATCH > src_off:
                break
            step[((read32(s, i) * 2654435761) & 0xFFFFFFFF) >> 17] = i + 1
        for hh, v in step.items():
            tab[hh] = v
    return tab


def _encode_dense_warp(s: bytes, accel: int, src_off: int = 0,
                       steps=None) -> bytearray:
    """`_encode_dense` as kernel D's warp computes it: the seed WARP
    positions a step (`dense_seed_warp`), each search its first
    SERIAL_PROBES probes one at a time, then WARP a step (`_probe_step`);
    the bytes are the same.  The table holds position + 1
    (0 == empty).  ``steps``, a dict, counts the warp's probe steps and
    sequences."""
    steps = {} if steps is None else steps
    steps.setdefault("probe_steps", 0)
    steps.setdefault("sequences", 0)
    n = len(s)
    out = bytearray()

    def h(p):
        return ((read32(s, p) * 2654435761) & 0xFFFFFFFF) >> 17

    tab = dense_seed_warp(s, src_off)
    anchor = src_off
    if n - src_off > MF_LIMIT:
        mf_limit = n - MF_LIMIT
        match_limit = n - LAST_LITERALS
        ramp = accel << SKIP_TRIGGER

        def accept(c, p):
            m = c[1] - 1 if c[0] == "table" else c[1]
            return m >= 0 and p - m <= MAX_DISTANCE and read32(s, m) == read32(s, p)

        p = src_off
        while True:
            j = 0
            while True:
                width = 1 if j < SERIAL_PROBES else WARP
                positions, valid, q = [], [], p
                for k in range(width):
                    positions.append(q)
                    valid.append(q < mf_limit)
                    q += (ramp + j + k) >> SKIP_TRIGGER
                first, cand, stop, commit = _probe_step(
                    tab, h, positions, valid, accept)
                steps["probe_steps"] += 1
                if first < stop:
                    commit(first, lambda x: x + 1)
                    p = positions[first]
                    c = cand[1] - 1 if cand[0] == "table" else cand[1]
                    break
                if stop < width:
                    emit(out, s, anchor, n - anchor, 0, 0)
                    return out
                commit(width - 1, lambda x: x + 1)
                p, j = q, j + width
            while p > anchor and c > 0 and s[p - 1] == s[c - 1]:
                p -= 1
                c -= 1
            ml = MIN_MATCH + run_length(s, c + MIN_MATCH, p + MIN_MATCH, match_limit)
            emit(out, s, anchor, p - anchor, p - c, ml)
            steps["sequences"] += 1
            p += ml
            anchor = p
            if p >= mf_limit:
                break
            tab[h(p - 2)] = p - 1
    emit(out, s, anchor, n - anchor, 0, 0)
    return out


def encode_row_warp(s: bytes, accel: int, fast_schedule: str,
                    src_off: int = 0):
    """One FAST row through the batched plain version of its schedule:
    (compressed bytes, {"probe_steps", "sequences"})."""
    steps: dict = {}
    if fast_schedule == "dense":
        return _encode_dense_warp(s, accel, src_off, steps), steps
    return _encode_canonical_warp(s, accel, steps), steps


def clip_acceleration(acceleration: int, fast_schedule: str) -> int:
    """Check the FAST geometry and clip ``acceleration`` as the kernels
    take it."""
    if fast_schedule not in GEOMETRIES:
        raise ValueError(
            f"unknown FAST geometry {fast_schedule!r}; expected {GEOMETRIES}"
        )
    accel = max(int(acceleration), 1)
    if fast_schedule == "canonical":
        return min(accel, 65537)  # upstream's LZ4_ACCELERATION_MAX
    if accel >= 1 << 24:
        raise ValueError("acceleration must be < 2**24")
    return accel


def pack_rows(comps, ocap: int, device):
    """Per-row compressed bytes -> (out uint8 [B, ocap], clens int32 [B],
    errs int32 [B]) on ``device``, as the kernels return them: a row longer
    than ``ocap`` is cut, counted in full and flagged."""
    out = np.zeros((len(comps), ocap), np.uint8)
    clens = np.zeros((len(comps),), np.int32)
    errs = np.zeros((len(comps),), np.int32)
    for b, comp in enumerate(comps):
        kept = min(len(comp), ocap)
        out[b, :kept] = np.frombuffer(bytes(comp[:kept]), np.uint8)
        clens[b] = len(comp)
        errs[b] = len(comp) > ocap
    return (
        torch.from_numpy(out).to(device),
        torch.from_numpy(clens).to(device),
        torch.from_numpy(errs).to(device),
    )


def _validate(bufs_u8, lens, bcap, acceleration, fast_schedule):
    if bcap > MAX_BLOCK:
        raise ValueError(
            f"bcap {bcap} > 65536: kernel B takes blocks of at most 64 KB; "
            "larger blocks encode on kernel D (ops.encode_stream)"
        )
    accel = clip_acceleration(acceleration, fast_schedule)
    bufs = torch.as_tensor(bufs_u8)
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError("bufs_u8 must be a 2-D uint8 tensor")
    if bufs.shape[1] < bcap:
        raise ValueError(f"rows of {bufs.shape[1]} bytes < bcap {bcap}")
    lens_t = torch.as_tensor(lens, dtype=torch.int32, device=bufs.device)
    lens_t = lens_t.contiguous()
    if lens_t.shape != (bufs.shape[0],):
        raise ValueError("lens must hold one length per row")
    if lens_t.numel() and (int(lens_t.min()) < 0 or int(lens_t.max()) > bcap):
        raise ValueError(f"row lengths must lie in [0, bcap={bcap}]")
    return bufs, lens_t, accel


def encode_blocks_plain(bufs_u8, lens, bcap: int, level: int = 0,
                        acceleration: int = 1,
                        fast_schedule: str = "canonical"):
    """The plain PyTorch version of `encode_blocks`: the same checks, the
    same outputs, one scalar parse per row on the host."""
    bufs, lens_t, accel = _validate(
        bufs_u8, lens, bcap, acceleration, fast_schedule
    )
    rows = bufs.cpu().numpy()
    if level_arm(level)[0] != "fast":
        comps = [encode_row(rows[b, :n].tobytes(), 0, level)
                 for b, n in enumerate(lens_t.tolist())]
    else:
        run = _encode_canonical if fast_schedule == "canonical" else _encode_dense
        comps = [run(rows[b, :n].tobytes(), accel)
                 for b, n in enumerate(lens_t.tolist())]
    return pack_rows(comps, align1024(compress_bound(bcap)), bufs.device)


def _outputs(nb: int, bcap: int, dev):
    ocap = align1024(compress_bound(bcap))
    return (torch.zeros((nb, ocap), dtype=torch.uint8, device=dev),
            torch.empty((nb,), dtype=torch.int32, device=dev),
            torch.empty((nb,), dtype=torch.int32, device=dev))


def encode_blocks(bufs_u8, lens, bcap: int, level: int = 0,
                  acceleration: int = 1, fast_schedule: str = "canonical"):
    """Encode B independent blocks of at most ``bcap`` <= 65536 bytes.

    bufs_u8: uint8 [B, CAP >= bcap], row b's bytes at [0, lens[b]).  Levels
    0-2 run the FAST arm ("canonical": byte-identical to
    LZ4_compress_default; "dense": the 15-bit finder), levels 3-9 the HC arm
    and 10 and up the OPT arm (above 12 as 12), with the rows as kernel
    D's windows (`encode_stream.encode_windows_hc`/`_opt`, which say where
    each level's launches are counted); ``acceleration`` and
    ``fast_schedule`` act at the FAST levels only.  ``bcap`` > 65536 raises
    ValueError (kernel D, `ops.encode_stream`, takes those).

    Returns (out uint8 [B, OCAP], clens int32 [B], errs int32 [B]) on the
    input's device, OCAP = align1024(compress_bound(bcap)); errs is 1 where a
    row's output exceeds OCAP.  A CPU tensor runs the plain version; a CUDA
    tensor launches kernel D's FAST scan over the rows as windows (counted
    here).
    """
    bufs, lens_t, accel = _validate(
        bufs_u8, lens, bcap, acceleration, fast_schedule
    )
    # imported here: encode_stream imports this module's plain encoders
    from .encode_stream import encode_blocks_stream, launch_fast

    if level_arm(level)[0] != "fast":
        return encode_blocks_stream(bufs, lens_t, bcap, level)
    if bufs.device.type != "cuda":
        return encode_blocks_plain(
            bufs, lens_t, bcap, level, acceleration, fast_schedule
        )
    nb, width = bufs.shape
    if nb == 0:
        return _outputs(nb, bcap, bufs.device)
    got = launch_fast(
        bufs.contiguous().reshape(-1), torch.arange(nb, dtype=torch.int64) * width,
        torch.zeros((nb,), dtype=torch.int32), lens_t.cpu(), bcap, accel,
        fast_schedule,
    )
    encode_blocks.launches += 1
    return got


encode_blocks.launches = 0
