"""The plain check of an LZ4 frame against the object it was made from.

Written from the LZ4 frame and block format specifications alone, with
numpy and the standard library: it imports nothing of the program under
test.  `check_frame` reads a frame as a conformant sequential decoder
does and counts what breaks the configuration's guarantees:

- frame faults: magic, FLG/BD flags other than the configuration states,
  the header checksum byte, a block length over the frame's block size or
  past the frame's end, a block count or stored-block length other than
  the object's, an end mark missing, a content checksum missing or not
  XXH32 of the object, bytes after the frame, no liblz4 to hold the
  blocks to;
- block faults: a block other than upstream's at the configuration's
  level (the system's liblz4, through ctypes, compresses the block's raw
  bytes as `LZ4F_compressFrame` does, into at most one byte less than
  them: a block it stores has to be stored, and one it compresses has to
  be its payload byte for byte); a compressed block whose sequences break
  the block format (an offset of 0 or before the block's start, since the
  blocks are independent; literals or a match past the block's end; the
  last match starting less than 12 bytes or ending less than 5 bytes
  before the end), or which decodes to bytes other than the object's; a
  stored block that is not the object's bytes; a block checksum that is
  not XXH32 of the block's payload.

Every fault counts, and the limit for each count is 0.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import multiprocessing
import struct
from concurrent.futures import ProcessPoolExecutor

import numpy as np

MAGIC = 0x184D2204
P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
M32 = 0xFFFFFFFF
BLOCK_SIZE_IDS = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}
MFLIMIT, LASTLITERALS = 12, 5


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & M32


def xxh32_lane(words: np.ndarray, v: int) -> int:
    """One of XXH32's four accumulators carried over its column of words
    (every fourth little-endian u32 of the stripes)."""
    adds = (words.astype(np.uint32) * np.uint32(P2)).tolist()  # wraps mod 2^32
    for a in adds:
        v = (v + a) & M32
        v = (((v << 13) | (v >> 19)) & M32) * P1 & M32
    return v


def xxh32_lanes(data, seed: int = 0) -> list[tuple]:
    """XXH32's four accumulators over ``data``'s whole stripes, as jobs
    for `run_jobs`: each a serial chain, so the four run side by side."""
    data = memoryview(data).cast("B")
    stripes = len(data) // 16
    cols = np.frombuffer(data, "<u4", count=stripes * 4).reshape(stripes, 4)
    init = [(seed + P1 + P2) & M32, (seed + P2) & M32, seed & M32, (seed - P1) & M32]
    return [("xxh32_lane", (np.ascontiguousarray(cols[:, k]), init[k])) for k in range(4)]


def xxh32(data, seed: int = 0, lanes: list[int] | None = None) -> int:
    """XXH32 of ``data``; ``lanes`` its four accumulators where they were
    carried already (`xxh32_lanes`)."""
    data = memoryview(data).cast("B")
    n = len(data)
    stripes = n // 16
    if stripes:
        v = lanes or run_jobs(xxh32_lanes(data, seed))
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & M32
    else:
        h = (seed + P5) & M32
    h = (h + n) & M32
    p = stripes * 16
    while p + 4 <= n:
        (w,) = struct.unpack_from("<I", data, p)
        h = _rotl((h + w * P3) & M32, 17) * P4 & M32
        p += 4
    while p < n:
        h = _rotl((h + data[p] * P5) & M32, 11) * P1 & M32
        p += 1
    h ^= h >> 15
    h = h * P2 & M32
    h ^= h >> 13
    h = h * P3 & M32
    return h ^ (h >> 16)


def decode_block(src: bytes, raw_len: int):
    """Decode one independent LZ4 block of ``raw_len`` bytes: (the bytes,
    None) or (None, the first format fault)."""
    n = len(src)
    out = bytearray()
    ip = 0
    last_start = last_end = -1
    while True:
        if ip >= n:
            return None, "the block ends inside a sequence"
        token = src[ip]
        ip += 1
        ll = token >> 4
        if ll == 15:
            while True:
                if ip >= n:
                    return None, "the block ends inside a literal length"
                b = src[ip]
                ip += 1
                ll += b
                if b != 255:
                    break
        end = ip + ll
        if end > n:
            return None, "literals run past the block"
        out += src[ip:end]
        ip = end
        if ip == n:
            break
        if ip + 2 > n:
            return None, "the block ends inside an offset"
        off = src[ip] | (src[ip + 1] << 8)
        ip += 2
        ml = (token & 15) + 4
        if ml == 19:
            while True:
                if ip >= n:
                    return None, "the block ends inside a match length"
                b = src[ip]
                ip += 1
                ml += b
                if b != 255:
                    break
        pos = len(out)
        if off == 0 or off > pos:
            return None, f"offset {off} at output byte {pos} reaches before the block"
        if pos + ml > raw_len:
            return None, "a match runs past the block"
        if off >= ml:
            out += out[pos - off:pos - off + ml]
        else:
            pattern = out[pos - off:]
            reps, rest = divmod(ml, off)
            out += pattern * reps + pattern[:rest]
        last_start, last_end = pos, pos + ml
    if len(out) != raw_len:
        return None, f"decodes to {len(out)} bytes, not {raw_len}"
    if last_start >= 0 and (last_start > raw_len - MFLIMIT or last_end > raw_len - LASTLITERALS):
        return None, "the last match is too close to the block's end"
    return bytes(out), None


_LIBLZ4 = []


def liblz4():
    """The system's liblz4 through ctypes, or None where it has none."""
    if not _LIBLZ4:
        lib = None
        for name in ("liblz4.so.1", "liblz4.so", ctypes.util.find_library("lz4")):
            try:
                lib = ctypes.CDLL(name) if name else None
            except OSError:
                continue
            if lib is not None:
                break
        if lib is not None:
            for fn in ("LZ4_compress_default", "LZ4_compress_HC"):
                getattr(lib, fn).restype = ctypes.c_int
            lib.LZ4_compress_default.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                                 ctypes.c_int, ctypes.c_int]
            lib.LZ4_compress_HC.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int]
            lib.LZ4_versionNumber.restype = ctypes.c_int
        _LIBLZ4.append(lib)
    return _LIBLZ4[0]


def liblz4_block(raw: bytes, level: int) -> bytes | None:
    """liblz4's block of ``raw`` at compression ``level`` as
    `LZ4F_compressFrame` makes it (levels under 3 are
    `LZ4_compress_default`'s, the others `LZ4_compress_HC`'s, into
    len(raw) - 1 bytes at most); None where it stores the block."""
    lib = liblz4()
    cap = len(raw) - 1
    if cap <= 0:
        return None
    out = ctypes.create_string_buffer(cap)
    if level >= 3:
        n = lib.LZ4_compress_HC(raw, out, len(raw), cap, level)
    else:
        n = lib.LZ4_compress_default(raw, out, len(raw), cap)
    return out.raw[:n] if n > 0 else None


def check_block(payload: bytes, stored: bool, raw: bytes, checksum: int | None,
                level: int) -> str | None:
    """The first fault of one block (its payload, whether it is stored,
    its object bytes, its checksum or None, the configuration's level),
    or None."""
    if checksum is not None and checksum != xxh32(payload):
        return "block checksum is not XXH32 of the payload"
    upstream = liblz4_block(raw, level)
    if stored:
        if upstream is not None:
            return f"stored, where liblz4 at level {level} compresses it to {len(upstream)} bytes"
        return None if payload == raw else "stored block is not the object's bytes"
    if len(payload) >= len(raw):
        return f"compressed block of {len(payload)} bytes for {len(raw)} raw: upstream stores it"
    out, fault = decode_block(payload, len(raw))
    if fault is None and out != raw:
        fault = "decodes to other bytes than the object's"
    if fault is None and payload != upstream:
        if upstream is None:
            return f"compressed, where liblz4 at level {level} stores it"
        k = next((i for i, (a, b) in enumerate(zip(payload, upstream)) if a != b),
                 min(len(payload), len(upstream)))
        fault = (f"{len(payload)} bytes, liblz4's at level {level} {len(upstream)}: "
                 f"they differ from byte {k}")
    return fault


def frame_block_size(block_size: int, n: int) -> int:
    """The block size a one-shot frame of ``n`` bytes declares: the
    configured one, or for a payload of one block the smallest standard
    size that holds it (LZ4F_compressFrame's rule)."""
    if n <= block_size:
        return min(bs for bs in BLOCK_SIZE_IDS.values() if bs >= min(n, block_size))
    return block_size


def run_jobs(jobs: list[tuple], workers: int = 1) -> list:
    """The results of ``jobs`` ((a function of this module by name, its
    arguments)), in order; with more than one worker, in that many
    spawned processes (the caller may hold a CUDA context, which a fork
    would copy).  Every worker has ended on return."""
    if workers <= 1 or len(jobs) <= 1:
        return [_run(job) for job in jobs]
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(workers, len(jobs)), mp_context=spawn) as pool:
        return list(pool.map(_run, jobs))


def _run(job):
    name, args = job
    return globals()[name](*args)


def check_frame(frame: bytes, obj: bytes, settings: dict, workers: int = 1) -> dict:
    """Count the faults of ``frame`` as the one-shot frame of ``obj``
    under ``settings`` (the configuration's compression_level and frame
    fields: block_size, chain_blocks, block_checksum, content_checksum,
    content_length).
    ``workers`` processes check the blocks and carry the object's XXH32
    accumulators side by side.  Returns {"frame_faults", "block_faults",
    "blocks", "faults": the first messages}."""
    faults = []
    n = len(obj)
    bs = frame_block_size(settings["block_size"], n)
    if len(frame) < 7 or struct.unpack_from("<I", frame)[0] != MAGIC:
        return {"frame_faults": 1, "block_faults": 0, "blocks": 0,
                "faults": ["no LZ4 frame magic"]}
    flg, bd = frame[4], frame[5]
    want_flg = (0b01 << 6) | (0 if settings["chain_blocks"] else 1 << 5) \
        | (1 << 4 if settings["block_checksum"] else 0) \
        | (1 << 3 if settings.get("content_length") is not None else 0) \
        | (1 << 2 if settings["content_checksum"] else 0)
    if flg != want_flg:
        faults.append(f"FLG {flg:#04x}, the configuration states {want_flg:#04x}")
    want_bd = {v: k for k, v in BLOCK_SIZE_IDS.items()}[bs] << 4
    if bd != want_bd:
        faults.append(f"BD {bd:#04x}, the configuration states {want_bd:#04x}")
    ip = 6
    if flg & (1 << 3):
        (declared,) = struct.unpack_from("<Q", frame, ip)
        if declared != n:
            faults.append(f"content size {declared}, the object has {n}")
        ip += 8
    if flg & 1:
        ip += 4
    if ip >= len(frame) or frame[ip] != (xxh32(frame[4:ip]) >> 8) & 0xFF:
        faults.append("header checksum byte")
    ip += 1
    blocks = []
    while True:
        if ip + 4 > len(frame):
            faults.append("no end mark")
            break
        (word,) = struct.unpack_from("<I", frame, ip)
        ip += 4
        if word == 0:
            break
        size, stored = word & 0x7FFFFFFF, bool(word >> 31)
        if size > bs or ip + size > len(frame):
            faults.append(f"block {len(blocks)}: length {size} over the block size or the frame")
            break
        payload = frame[ip:ip + size]
        ip += size
        checksum = None
        if flg & (1 << 4):
            (checksum,) = struct.unpack_from("<I", frame, ip)
            ip += 4
        lo = len(blocks) * bs
        blocks.append(("check_block", (payload, stored, obj[lo:lo + bs], checksum,
                                       settings["compression_level"])))
    want_blocks = -(-n // bs)
    if len(blocks) != want_blocks:
        faults.append(f"{len(blocks)} blocks, the object needs {want_blocks}")
    csum = None
    if flg & (1 << 2):
        if ip + 4 > len(frame):
            faults.append("no content checksum")
        else:
            (csum,) = struct.unpack_from("<I", frame, ip)
            ip += 4
    if ip != len(frame):
        faults.append(f"{len(frame) - ip} bytes after the frame")
    if liblz4() is None:
        faults.append("no liblz4 on this machine to hold the blocks to")
        blocks = []
    lanes = xxh32_lanes(obj) if csum is not None and n >= 16 else []
    results = run_jobs(lanes + blocks, workers)
    if csum is not None and csum != xxh32(obj, lanes=results[:len(lanes)]):
        faults.append("content checksum is not XXH32 of the object")
    frame_faults = len(faults)
    block_faults = 0
    for i, fault in enumerate(results[len(lanes):]):
        if fault is not None:
            block_faults += 1
            if block_faults <= 3:
                faults.append(f"block {i}: {fault}")
    return {"frame_faults": frame_faults, "block_faults": block_faults,
            "blocks": len(blocks), "faults": faults}
