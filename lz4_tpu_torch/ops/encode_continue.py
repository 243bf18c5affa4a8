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
which liblz4's frame API writes for linked blocks.  The kernel runs one
warp for the frame with kernel D's warp scan; `continue_blocks_plain` is
the serial schedule and `continue_blocks_warp` the warp's (32 probes a
step), which give the same bytes.

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
    CANON_64K, WARP, _canon_hash, canonical_block, canonical_block_warp, clip_acceleration,
    pack_rows,
)
from .encode_stream import WINDOW

# The longest frame: positions are absolute u32 offsets that are never
# renormalised (upstream renormalises its stream state near 2 GiB), as in
# the JAX package's native engine.
MAX_FRAME = (1 << 31) - (64 << 20)
_TOO_LONG = "canonical chained encoding supports up to ~2 GiB per frame"

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("encode_continue")
        lib.lz4t_encode_continue.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
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


def encode_continue_plain(payload_u8, block_size: int, acceleration: int = 1, steps=None):
    """The plain PyTorch version of `encode_continue`: the same checks and
    outputs, the blocks through `continue_blocks_warp` on the host (the
    bytes of `continue_blocks_plain`, at its speed, and the warp's
    steps)."""
    payload, _ = _payload(payload_u8, block_size)
    counts: list = []
    comps = continue_blocks_warp(payload.cpu().numpy().tobytes(), block_size, acceleration,
                                 steps=counts)
    out, clens, _ = pack_rows(comps, compress_bound(block_size), payload.device)
    if steps is not None:
        steps.copy_(torch.tensor([[c["probe_steps"], c["sequences"]] for c in counts],
                                 dtype=torch.int32).reshape(steps.shape))
    return out, clens


def encode_continue(payload_u8, block_size: int, acceleration: int = 1, steps=None):
    """Encode one canonical chained FAST frame's blocks with kernel F.

    ``payload_u8`` (a 1-D uint8 tensor of at most `MAX_FRAME` bytes; longer
    raises ValueError, as the JAX package's native engine does) is cut into
    blocks of ``block_size`` bytes, each encoded by
    LZ4_compress_fast_continue with one table carried through the blocks.
    Returns (out uint8 [NB, OCAP], clens int32 [NB]) on the input's device,
    OCAP = compress_bound(block_size), so that no block stops early.
    ``steps``, an int32 [NB, 2] tensor on the same device, gets each
    block's probe steps and sequences of the warp's scan.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel, one warp for the
    frame (counted in `encode_continue.launches`)."""
    payload, nb = _payload(payload_u8, block_size)
    accel = clip_acceleration(acceleration, "canonical")
    if payload.device.type != "cuda":
        return encode_continue_plain(payload, block_size, accel, steps)
    ocap = compress_bound(block_size)
    dev = payload.device
    out = torch.zeros((nb, ocap), dtype=torch.uint8, device=dev)
    clens = torch.empty((nb,), dtype=torch.int32, device=dev)
    if steps is None:
        steps = torch.empty((nb, 2), dtype=torch.int32, device=dev)
    if steps.shape != (nb, 2) or steps.dtype != torch.int32 or steps.device != dev:
        raise ValueError(f"steps must be an int32 [{nb}, 2] tensor on {dev}")
    if nb == 0:
        return out, clens
    payload = payload.contiguous()
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_encode_continue(
            payload.data_ptr(), payload.numel(), block_size, out.data_ptr(), ocap, accel,
            clens.data_ptr(), steps.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, "encode_continue")
    encode_continue.launches += 1
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
