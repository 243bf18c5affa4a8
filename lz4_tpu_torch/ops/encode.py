"""Batched LZ4 block encode at the FAST levels: kernel B
(`csrc/encode.cu`) and its plain version.

The port of the FAST arms of `lz4_tpu/ops/encode_pallas5.py`
(`pallas_encode5`, wrapper `encode_blocks_pallas5`), with the same bytes:
the canonical byU16 schedule (LZ4_compress_default) and the dense 15-bit
schedule.  The kernel's source says what bounds it on the card and what
its design does about that.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import compress_bound
from .build import check, load
from .common import LEVEL_ATTEMPTS, align1024

MIN_MATCH = 4
MF_LIMIT = 12
LAST_LITERALS = 5
SKIP_TRIGGER = 6
MAX_DISTANCE = 65535
MAX_BLOCK = 65536  # kernel B's rows; larger blocks belong to kernel D
GEOMETRIES = ("canonical", "dense")

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("encode")
        lib.lz4t_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.lz4t_encode.restype = ctypes.c_int
        lib.lz4t_encode_shared_bytes.argtypes = [ctypes.c_int]
        lib.lz4t_encode_shared_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def shared_bytes(fast_schedule: str) -> int:
    """Dynamic shared memory of one CTA of kernel B for a geometry (its
    hash table)."""
    return _kernel().lz4t_encode_shared_bytes(int(fast_schedule == "dense"))


def _read32(s, p: int) -> int:
    return s[p] | (s[p + 1] << 8) | (s[p + 2] << 16) | (s[p + 3] << 24)


def _run_length(s, a: int, b: int, limit: int) -> int:
    k = 0
    while b + k < limit and s[a + k] == s[b + k]:
        k += 1
    return k


def _emit(out: bytearray, s, anchor: int, ll: int, off: int, ml: int):
    mlc = ml - MIN_MATCH if ml else 0
    out.append((min(ll, 15) << 4) | min(mlc, 15))
    if ll >= 15:
        v = ll - 15
        out += b"\xff" * (v // 255)
        out.append(v % 255)
    out += s[anchor:anchor + ll]
    if ml:
        out.append(off & 0xFF)
        out.append(off >> 8)
        if mlc >= 15:
            v = mlc - 15
            out += b"\xff" * (v // 255)
            out.append(v % 255)


def _encode_canonical(s: bytes, accel: int) -> bytearray:
    """Upstream one-shot schedule, byU16 (rows below 65,547 bytes)."""
    n = len(s)
    out = bytearray()
    anchor = 0
    if n >= MF_LIMIT + 1:
        tab = [0] * (1 << 13)

        def h(p):
            return ((_read32(s, p) * 2654435761) & 0xFFFFFFFF) >> 19

        mf1 = n - MF_LIMIT + 1
        match_limit = n - LAST_LITERALS
        ip = 1
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
                    _emit(out, s, anchor, n - anchor, 0, 0)
                    return out
                match = tab[hh]
                fh = h(fwd)
                tab[hh] = ip
                if _read32(s, match) == _read32(s, ip):
                    break
            while ip > anchor and match > 0 and s[ip - 1] == s[match - 1]:
                ip -= 1
                match -= 1
            while True:
                ml = MIN_MATCH + _run_length(
                    s, match + MIN_MATCH, ip + MIN_MATCH, match_limit
                )
                _emit(out, s, anchor, ip - anchor, ip - match, ml)
                ip += ml
                anchor = ip
                if ip >= mf1:
                    _emit(out, s, anchor, n - anchor, 0, 0)
                    return out
                tab[h(ip - 2)] = ip - 2
                h2 = h(ip)
                m2 = tab[h2]
                tab[h2] = ip
                if _read32(s, m2) != _read32(s, ip):
                    break
                match = m2
            ip += 1
            fh = h(ip)
    _emit(out, s, anchor, n - anchor, 0, 0)
    return out


def _encode_dense(s: bytes, accel: int) -> bytearray:
    """This library's 15-bit greedy finder (no dictionary)."""
    n = len(s)
    out = bytearray()
    anchor = 0
    if n > MF_LIMIT:
        tab = [-1] * (1 << 15)
        mf_limit = n - MF_LIMIT
        match_limit = n - LAST_LITERALS
        p = 0
        search = accel << SKIP_TRIGGER
        while p < mf_limit:
            w = _read32(s, p)
            hh = ((w * 2654435761) & 0xFFFFFFFF) >> 17
            cand = tab[hh]
            tab[hh] = p
            if cand >= 0 and p - cand <= MAX_DISTANCE and _read32(s, cand) == w:
                while p > anchor and cand > 0 and s[p - 1] == s[cand - 1]:
                    p -= 1
                    cand -= 1
                ml = MIN_MATCH + _run_length(
                    s, cand + MIN_MATCH, p + MIN_MATCH, match_limit
                )
                _emit(out, s, anchor, p - anchor, p - cand, ml)
                p += ml
                anchor = p
                if p >= mf_limit:
                    break
                hh = ((_read32(s, p - 2) * 2654435761) & 0xFFFFFFFF) >> 17
                tab[hh] = p - 2
                search = accel << SKIP_TRIGGER
                continue
            p += search >> SKIP_TRIGGER
            search += 1
    _emit(out, s, anchor, n - anchor, 0, 0)
    return out


def _validate(bufs_u8, lens, bcap, level, acceleration, fast_schedule):
    level = int(level)
    if level >= 10 or LEVEL_ATTEMPTS.get(level, 0):
        raise NotImplementedError(
            f"level {level}: the HC (L3-L9) and OPT (L10-L12) arms of "
            "kernel B are not ported yet (ROADMAP.md Queue 2, B2/B3)"
        )
    if bcap > MAX_BLOCK:
        raise NotImplementedError(
            f"bcap {bcap} > 65536: blocks above 64 KB belong to kernel D, "
            "not ported yet (ROADMAP.md Queue 2, D)"
        )
    if fast_schedule not in GEOMETRIES:
        raise ValueError(
            f"unknown FAST geometry {fast_schedule!r}; expected {GEOMETRIES}"
        )
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
    accel = max(int(acceleration), 1)
    if fast_schedule == "canonical":
        accel = min(accel, 65537)  # upstream's LZ4_ACCELERATION_MAX
    elif accel >= 1 << 24:
        raise ValueError("acceleration must be < 2**24")
    return bufs, lens_t, accel


def encode_blocks_plain(bufs_u8, lens, bcap: int, level: int = 0,
                        acceleration: int = 1,
                        fast_schedule: str = "canonical"):
    """The plain PyTorch version of `encode_blocks`: the same checks, the
    same outputs, one scalar parse per row on the host."""
    bufs, lens_t, accel = _validate(
        bufs_u8, lens, bcap, level, acceleration, fast_schedule
    )
    ocap = align1024(compress_bound(bcap))
    nb = bufs.shape[0]
    out = np.zeros((nb, ocap), np.uint8)
    clens = np.zeros((nb,), np.int32)
    errs = np.zeros((nb,), np.int32)
    rows = bufs.cpu()
    run = _encode_canonical if fast_schedule == "canonical" else _encode_dense
    for b, n in enumerate(lens_t.tolist()):
        comp = run(bytes(rows[b, :n].tolist()), accel)
        kept = min(len(comp), ocap)
        out[b, :kept] = np.frombuffer(bytes(comp[:kept]), np.uint8)
        clens[b] = len(comp)
        errs[b] = len(comp) > ocap
    dev = bufs.device
    return (
        torch.from_numpy(out).to(dev),
        torch.from_numpy(clens).to(dev),
        torch.from_numpy(errs).to(dev),
    )


def encode_blocks(bufs_u8, lens, bcap: int, level: int = 0,
                  acceleration: int = 1, fast_schedule: str = "canonical"):
    """Encode B independent blocks of at most ``bcap`` <= 65536 bytes.

    bufs_u8: uint8 [B, CAP >= bcap], row b's bytes at [0, lens[b]).  Levels
    0-2 run the FAST arm ("canonical": byte-identical to
    LZ4_compress_default; "dense": the 15-bit finder); levels >= 3 and
    ``bcap`` > 65536 raise NotImplementedError.

    Returns (out uint8 [B, OCAP], clens int32 [B], errs int32 [B]) on the
    input's device, OCAP = align1024(compress_bound(bcap)); errs is 1 where a
    row's output exceeds OCAP.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel.
    """
    bufs, lens_t, accel = _validate(
        bufs_u8, lens, bcap, level, acceleration, fast_schedule
    )
    if bufs.device.type != "cuda":
        return encode_blocks_plain(
            bufs, lens_t, bcap, level, acceleration, fast_schedule
        )
    bufs = bufs.contiguous()
    ocap = align1024(compress_bound(bcap))
    nb = bufs.shape[0]
    dev = bufs.device
    out = torch.zeros((nb, ocap), dtype=torch.uint8, device=dev)
    clens = torch.empty((nb,), dtype=torch.int32, device=dev)
    errs = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return out, clens, errs
    lib = _kernel()
    with torch.cuda.device(dev):
        rc = lib.lz4t_encode(
            bufs.data_ptr(), bufs.stride(0), lens_t.data_ptr(),
            out.data_ptr(), ocap, ocap, accel,
            int(fast_schedule == "dense"), clens.data_ptr(), errs.data_ptr(),
            nb, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, "encode")
    encode_blocks.launches += 1
    return out, clens, errs


encode_blocks.launches = 0
