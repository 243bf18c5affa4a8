"""Canonical chained FAST frames (kernel F) and the byU32 hash over a
tensor (`hash5_rows`), with their plain versions.

Kernel F (`csrc/encode_continue.cu`) is upstream's LZ4_compress_fast_continue
over the blocks of one contiguous payload: one byU32 table of 4,096 absolute
positions carried from block to block, each block inserting its first byte
and probing from the next, back-extending no lower than its 64 KB window,
a stale entry rejected by its distance alone, a block under 13 bytes all
literals with the table left as it was.  Those are the blocks of the JAX
package's canonical chained frames (`lz4_tpu/frame/api.py:313`
`_host_chained_canonical_compress`, on `lz4tpu_encode_fast_continue`),
which liblz4's frame API writes for linked blocks; the kernel replaces
that host route.

A block's walk is serial, and it reads the table the block before left,
but only that table's live entries (an entry more than 65,535 bytes behind
the block's start is rejected at every position).  So the kernel walks
every block at once from a guessed table, then checks each guess against
the table its predecessor left, and re-walks, round after round, only the
blocks whose table changed; after `MAX_ROUNDS` rounds the rest is walked
serially.  What bounds it is the slowest walk of each round times the
rounds the data takes to settle (the noise of the bench mix settles one
block a round), not the frame's steps one after another.  It keeps two
16 KB tables per block, in windows of `WINDOW_BLOCKS` blocks (256 MiB at
most), and stages each walk's 64 KB window and block in shared memory
where they fit (blocks up to ~147 KB; a longer block's walk reads the
payload through the read-only path).  The payload may start at any byte
of its allocation (a view of a tensor).

Plain versions, all with the same bytes: `continue_blocks_plain` is the
serial schedule, `continue_blocks_warp` the warp's search (32 probes a
step, with each block's step counts) and `continue_blocks_rounds` the
kernel's schedule of rounds (with its counts of rounds and walks).

`hash5_rows` computes the hash kernels D and F call (`canon_hash5`) over a
tensor of 40-bit values: the Hopper counterpart of the TPU's 32-bit split
of that hash (`experiments/tests/test_canon_hash32.py:90`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import compress_bound
from .build import check, load
from .encode import (
    CANON_64K, MAX_DISTANCE, WARP, _canon_hash, canonical_block, canonical_block_warp,
    clip_acceleration, pack_rows,
)
from .encode_stream import WINDOW

# The longest frame: positions are absolute u32 offsets that are never
# renormalised (upstream renormalises its stream state near 2 GiB), as in
# the JAX package's native engine.
MAX_FRAME = (1 << 31) - (64 << 20)
_TOO_LONG = "canonical chained encoding supports up to ~2 GiB per frame"

TABLE_ENTRIES = 4096  # the byU32 table: 4,096 absolute u32 positions, 16 KB
# Kernel F keeps two tables per block of a window (the one it started from,
# the one it left): 256 MiB of tables at most, 8,192 blocks a window.
WINDOW_BLOCKS = (256 << 20) // (2 * 4 * TABLE_ENTRIES)
MAX_ROUNDS = 32  # kernel F's rounds of parallel walks before its serial tail

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("encode_continue")
        lib.lz4t_encode_continue.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.lz4t_hash5_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ]
        for fn in (lib.lz4t_encode_continue, lib.lz4t_hash5_rows):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _blocks(n: int, block_size: int):
    """Each block's (start, end, floor) in a frame of n bytes."""
    for off in range(0, n, block_size):
        yield off, min(n, off + block_size), off - min(off, WINDOW)


def continue_blocks_plain(data, block_size: int, acceleration: int = 1) -> list:
    """Each block's compressed candidate of LZ4_compress_fast_continue over
    ``data`` in blocks of ``block_size`` bytes, one table carried through
    them: the serial schedule (`encode.canonical_block`)."""
    s = bytes(data)
    _check_frame(len(s), block_size)
    accel = clip_acceleration(acceleration, "canonical")
    tab, h = _canon_hash(s, CANON_64K)
    return [bytes(canonical_block(s, a, b, floor, tab, h, False, accel))
            for a, b, floor in _blocks(len(s), block_size)]


def continue_blocks_warp(data, block_size: int, acceleration: int = 1,
                         lanes: int = WARP, steps=None) -> list:
    """`continue_blocks_plain` as kernel F's warp computes it: each search
    its first probes one at a time, then ``lanes`` a step
    (`encode.canonical_block_warp`); the same bytes.  ``steps``, a list,
    gets each block's {"probe_steps", "sequences"}."""
    s = bytes(data)
    _check_frame(len(s), block_size)
    accel = clip_acceleration(acceleration, "canonical")
    tab, h = _canon_hash(s, CANON_64K)
    out = []
    for a, b, floor in _blocks(len(s), block_size):
        counts: dict = {}
        out.append(bytes(canonical_block_warp(s, a, b, floor, tab, h, False, accel,
                                              lanes, counts)))
        if steps is not None:
            steps.append(counts)
    return out


def _live_equal(a, b, start: int) -> bool:
    """Whether two byU32 tables give a block that starts at ``start`` the
    same walk: equal wherever either entry is live there (an entry e with
    e + 65,535 < start is rejected by its distance at every position of
    the block, so any two such entries count as equal)."""
    return all(x == y or (x + MAX_DISTANCE < start and y + MAX_DISTANCE < start)
               for x, y in zip(a, b))


def continue_blocks_rounds(data, block_size: int, acceleration: int = 1,
                           max_rounds: int | None = None, stats=None) -> list:
    """`continue_blocks_plain` by kernel F's schedule of rounds, block by
    block with `encode.canonical_block`; the same bytes.

    The blocks go in windows of `WINDOW_BLOCKS`, the first block of each
    starting from the table the window before left (a zeroed one in the
    first).  Round 1 walks every block of the window from a guessed table,
    zeroed but for that first block's; after each round, a block whose
    predecessor was walked compares the table it started from with the one
    its predecessor now leaves (`_live_equal`), and where they differ takes
    that table and is walked again in the next round.  A block is final
    once no block up to it differs; when none differs, all are.  After
    ``max_rounds`` rounds (None: no cap) the window's non-final suffix is
    walked serially from its first block, on the table its predecessor
    left: ``max_rounds=0`` is the serial schedule.  ``stats``, a dict, gets
    "rounds" (the most rounds a window walked in), "walked" (the blocks
    walked in each round, over the windows), "tail" (the first block the
    serial tail walked, None if it walked none) and "walks" (each block's
    walks)."""
    s = bytes(data)
    _check_frame(len(s), block_size)
    accel = clip_acceleration(acceleration, "canonical")
    _, h = _canon_hash(s, CANON_64K)
    blocks = list(_blocks(len(s), block_size))
    nb = len(blocks)
    rows = [b""] * nb
    walks = [0] * nb
    walked: list = []
    tail = None

    def walk(k, tab):
        a, b, floor = blocks[k]
        rows[k] = bytes(canonical_block(s, a, b, floor, tab, h, False, accel))
        walks[k] += 1
        return tab

    carry = [0] * TABLE_ENTRIES
    for w0 in range(0, nb, WINDOW_BLOCKS):
        ks = range(w0, min(nb, w0 + WINDOW_BLOCKS))
        tin = {k: [0] * TABLE_ENTRIES for k in ks}
        tin[w0] = carry
        tout = {}
        dirty = list(ks)
        r = 0
        while dirty and (max_rounds is None or r < max_rounds):
            for k in dirty:
                tout[k] = walk(k, list(tin[k]))
            if r == len(walked):
                walked.append(0)
            walked[r] += len(dirty)
            again = []
            for k in dirty:
                if k + 1 in tin and not _live_equal(tin[k + 1], tout[k], blocks[k + 1][0]):
                    tin[k + 1] = list(tout[k])
                    again.append(k + 1)
            dirty = again
            r += 1
        if dirty:
            tail = dirty[0] if tail is None else tail
            tab = list(tin[dirty[0]])
            for k in range(dirty[0], ks.stop):
                tout[k] = walk(k, tab)
        carry = tout[ks[-1]]
    if stats is not None:
        stats.update(rounds=len(walked), walked=walked, tail=tail, walks=walks)
    return rows


def _check_frame(n: int, block_size: int) -> None:
    if n > MAX_FRAME:
        raise ValueError(_TOO_LONG)
    if block_size < 1:
        raise ValueError("block_size must be positive")


def _payload(payload_u8, block_size: int):
    payload = torch.as_tensor(payload_u8)
    if payload.dtype != torch.uint8 or payload.dim() != 1:
        raise ValueError("payload_u8 must be a 1-D uint8 tensor")
    _check_frame(payload.numel(), block_size)
    return payload, -(-payload.numel() // block_size)


def _rounds(max_rounds, nb: int) -> int:
    """The rounds kernel F launches: ``max_rounds`` (None: no cap), at most
    the blocks of a window (each round makes at least one more final)."""
    most = min(nb, WINDOW_BLOCKS)
    if max_rounds is None:
        return most
    if max_rounds < 0:
        raise ValueError("max_rounds must be at least 0")
    return min(int(max_rounds), most)


def encode_continue_plain(payload_u8, block_size: int, acceleration: int = 1, steps=None,
                          max_rounds: int | None = MAX_ROUNDS, stats=None):
    """The plain PyTorch version of `encode_continue`: the same checks and
    outputs, the blocks through `continue_blocks_warp` on the host (the
    bytes of `continue_blocks_plain`, at its speed, and the warp's steps);
    ``stats`` from `continue_blocks_rounds`, run too when it is asked."""
    payload, nb = _payload(payload_u8, block_size)
    _rounds(max_rounds, nb)
    data = payload.cpu().numpy().tobytes()
    counts: list = []
    comps = continue_blocks_warp(data, block_size, acceleration, steps=counts)
    out, clens, _ = pack_rows(comps, compress_bound(block_size), payload.device)
    if steps is not None:
        steps.copy_(torch.tensor([[c["probe_steps"], c["sequences"]] for c in counts],
                                 dtype=torch.int32).reshape(steps.shape))
    if stats is not None:
        continue_blocks_rounds(data, block_size, acceleration, max_rounds, stats)
    return out, clens


def encode_continue(payload_u8, block_size: int, acceleration: int = 1, steps=None,
                    max_rounds: int | None = MAX_ROUNDS, stats=None):
    """Encode one canonical chained FAST frame's blocks with kernel F.

    ``payload_u8`` (a 1-D uint8 tensor of at most `MAX_FRAME` bytes; longer
    raises ValueError, as the JAX package's native engine does) is cut into
    blocks of ``block_size`` bytes, each encoded by
    LZ4_compress_fast_continue with one table carried through the blocks.
    Returns (out uint8 [NB, OCAP], clens int32 [NB]) on the input's device,
    OCAP = compress_bound(block_size), so that no block stops early.
    ``steps``, an int32 [NB, 2] tensor on the same device, gets each
    block's probe steps and sequences of the warp's scan.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel (counted in
    `encode_continue.launches`): rounds of every block at once, then the
    serial tail after ``max_rounds`` rounds (`continue_blocks_rounds`; 0:
    the serial schedule, None: no cap).  ``stats``, a dict, gets what
    `continue_blocks_rounds` puts there (the kernel's counts; reading them
    synchronises)."""
    payload, nb = _payload(payload_u8, block_size)
    accel = clip_acceleration(acceleration, "canonical")
    rounds = _rounds(max_rounds, nb)
    if payload.device.type != "cuda":
        return encode_continue_plain(payload, block_size, accel, steps, max_rounds, stats)
    ocap = compress_bound(block_size)
    dev = payload.device
    out = torch.zeros((nb, ocap), dtype=torch.uint8, device=dev)
    clens = torch.empty((nb,), dtype=torch.int32, device=dev)
    if steps is None:
        steps = torch.empty((nb, 2), dtype=torch.int32, device=dev)
    if steps.shape != (nb, 2) or steps.dtype != torch.int32 or steps.device != dev:
        raise ValueError(f"steps must be an int32 [{nb}, 2] tensor on {dev}")
    if nb == 0:
        if stats is not None:
            stats.update(rounds=0, walked=[], tail=None, walks=[])
        return out, clens
    payload = payload.contiguous()
    window = min(nb, WINDOW_BLOCKS)
    tables = torch.empty((2, window, TABLE_ENTRIES), dtype=torch.int32, device=dev)
    dirty = torch.empty((2, window), dtype=torch.int32, device=dev)
    counts = torch.empty((rounds + 1 + nb,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_encode_continue(
            payload.data_ptr(), payload.numel(), block_size, out.data_ptr(), ocap, accel,
            clens.data_ptr(), steps.data_ptr(), rounds, window, tables.data_ptr(),
            dirty.data_ptr(), counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, "encode_continue")
    encode_continue.launches += 1
    if stats is not None:
        c = counts.tolist()
        walked = [w for w in c[:rounds] if w]
        stats.update(rounds=len(walked), walked=walked,
                     tail=c[rounds] - 1 if c[rounds] else None, walks=c[rounds + 1:])
    return out, clens


def hash5_rows_plain(values) -> torch.Tensor:
    """The plain version of `hash5_rows`: ((v << 24) * 889523592379 mod
    2^64) >> 52 in numpy's wrapping uint64 arithmetic."""
    v = torch.as_tensor(values)
    _check_values(v)
    x = v.cpu().numpy().view(np.uint64)
    with np.errstate(over="ignore"):
        h = ((x << np.uint64(24)) * np.uint64(889523592379)) >> np.uint64(52)
    return torch.from_numpy(h.astype(np.int32)).to(v.device)


def _check_values(v) -> None:
    if v.dtype not in (torch.uint64, torch.int64) or v.dim() != 1:
        raise ValueError("values must be a 1-D uint64 (or int64) tensor")


def hash5_rows(values) -> torch.Tensor:
    """The byU32 hash (`canon_hash5`: upstream LZ4_hash5 of the 5 low
    bytes) of each value of a 1-D uint64 tensor (int64 is read as its
    bits): int32 values in [0, 4096) on the input's device.  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel (counted in
    `hash5_rows.launches`)."""
    v = torch.as_tensor(values)
    _check_values(v)
    if v.device.type != "cuda":
        return hash5_rows_plain(v)
    v = v.contiguous()
    out = torch.empty(v.shape, dtype=torch.int32, device=v.device)
    if not v.numel():
        return out
    with torch.cuda.device(v.device):
        rc = _kernel().lz4t_hash5_rows(
            v.data_ptr(), out.data_ptr(), v.numel(),
            torch.cuda.current_stream(v.device).cuda_stream)
    check(rc, "hash5_rows")
    hash5_rows.launches += 1
    return out


encode_continue.launches = 0
hash5_rows.launches = 0
