"""One-shot frame compress and decompress over independent blocks.

The port of the device path of `lz4_tpu/frame/api.py`: `compress` splits
the payload into independent blocks and encodes them in one batch with
kernel B; `decompress` scans the frame's block table on the host, copies
the stored blocks and decodes the compressed ones in one batch with
kernel A.  Chained frames, preset dictionaries and multi-frame streams
need the streaming kernels C and D, which are not ported yet.
"""

from __future__ import annotations

import dataclasses
import io
import struct

from ..constants import _as_bytes, compress_bound
from ..ops.common import resolve_device
from ..parallel.blocks import decode_block_parts, encode_blocks
from ..xxh32 import xxh32
from .descriptor import DecoderSettings, EncoderSettings
from .header import LZ4FormatError, build_header, parse_header, parse_magic

__all__ = ["compress", "decompress"]

_UNCOMPRESSED_FLAG = 0x80000000


def _assemble_frame(d, data, bs, payloads, csum=None) -> bytes:
    """Assemble one frame: header, per-block stored-vs-compressed framing
    (a block is STORED when its compressed payload is not smaller — the
    upstream rule), optional block checksums, EndMark, optional content
    checksum.  `payloads` are per-block compressed candidates, in frame
    order."""
    parts = [build_header(d)]
    n = len(data)
    for i, comp in enumerate(payloads):
        off = i * bs
        raw_len = min(bs, n - off)
        if len(comp) >= raw_len:
            parts.append(struct.pack("<I", raw_len | _UNCOMPRESSED_FLAG))
            payload = data[off : off + raw_len]
        else:
            parts.append(struct.pack("<I", len(comp)))
            payload = comp
        parts.append(payload)
        if d.block_checksum:
            parts.append(struct.pack("<I", xxh32(payload)))
    parts.append(b"\x00\x00\x00\x00")
    if csum is not None:
        parts.append(struct.pack("<I", csum))
    return b"".join(parts)


def _independent_geometry(settings) -> str:
    """Effective FAST geometry for independent blocks ("auto" maps to
    canonical; see EncoderSettings.geometry)."""
    return "dense" if settings.geometry == "dense" else "canonical"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} need the streaming kernels C and D, which are not ported "
        "yet (ROADMAP.md Queue 2, C and D)"
    )


def compress(
    data,
    settings: EncoderSettings | None = None,
    store_size: bool = False,
    device="cuda",
) -> bytes:
    """Compress ``data`` into one LZ4 frame of independent blocks, encoded
    in one batch on ``device`` (the plain versions when ``device="cpu"``).

    Chained frames raise NotImplementedError, except a payload that fits
    one block at the canonical geometry, which upstream's single-block
    rule emits as an independent frame."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    settings = settings or EncoderSettings()
    if store_size and settings.content_length is None:
        settings = dataclasses.replace(settings, content_length=len(data))
    if (
        settings.chain_blocks
        and len(data) <= settings.block_size
        and (settings.compression_level >= 3 or settings.geometry == "canonical")
    ):
        # LZ4F_compressFrame's single-block rule: linkage is meaningless
        # for one block and the payload is identical
        settings = dataclasses.replace(settings, chain_blocks=False)
    if settings.chain_blocks:
        raise _not_ported("chained frames")
    if len(data) <= settings.block_size:
        # upstream LZ4F_optimalBSID: the smallest standard block size that
        # holds the whole payload
        bs_opt = 65536
        while bs_opt < len(data):
            bs_opt <<= 2
        if bs_opt < settings.block_size:
            settings = dataclasses.replace(settings, block_size=bs_opt)
    d = settings.to_descriptor()
    blocks = encode_blocks(
        data,
        block_size=settings.block_size,
        level=settings.compression_level,
        geometry=_independent_geometry(settings),
        device=dev,
    )
    csum = xxh32(data) if d.content_checksum else None
    return _assemble_frame(d, data, settings.block_size, blocks, csum)


def _scan_single_frame(data: bytes):
    """Parse one independent-block frame's block table on the host.

    Returns (descriptor, [(offset, length, stored)], tail_pos).  Raises
    LZ4FormatError on a malformed or truncated frame and
    NotImplementedError on what this slice does not decode."""
    src = io.BytesIO(data)
    info = parse_header(src.read)
    if info.kind != "frame":
        raise _not_ported(f"{info.kind} frames")
    d = info.descriptor
    if d.block_chaining:
        raise _not_ported("chained frames")
    if d.dictionary_id is not None:
        raise _not_ported("frames with a preset dictionary")
    blocks = []
    pos = info.header_length
    n = len(data)
    limit = d.block_size_limit
    while True:
        if pos + 4 > n:
            raise LZ4FormatError("truncated block length")
        (word,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if word == 0:
            break
        stored = bool(word & _UNCOMPRESSED_FLAG)
        length = word & ~_UNCOMPRESSED_FLAG
        if length > (limit if stored else compress_bound(limit)):
            # a crafted length word must not reach the decoder
            raise LZ4FormatError(
                f"block length {length} exceeds block size limit"
            )
        if pos + length > n:
            raise LZ4FormatError("truncated block data")
        blocks.append((pos, length, stored))
        pos += length
        if d.block_checksum:
            if pos + 4 > n:
                raise LZ4FormatError("truncated block checksum")
            (expected,) = struct.unpack_from("<I", data, pos)
            if xxh32(data[pos - length : pos]) != expected:
                raise LZ4FormatError("block checksum mismatch")
            pos += 4
    tail = 4 if d.content_checksum else 0
    if pos + tail > n:
        raise LZ4FormatError("truncated content checksum")
    rest = data[pos + tail :]
    if rest:
        if len(rest) < 4:
            raise LZ4FormatError("truncated frame magic")
        (magic,) = struct.unpack_from("<I", rest)
        if parse_magic(magic) is None:
            raise LZ4FormatError(f"invalid magic 0x{magic:08X}")
        raise _not_ported("multi-frame streams")
    return d, blocks, pos


def decompress(
    data,
    settings: DecoderSettings | None = None,
    device="cuda",
) -> bytes:
    """Decompress one LZ4 frame of independent blocks: the compressed
    blocks decode in one batch on ``device`` (the plain version when
    ``device="cpu"``), the stored ones are copied, in frame order."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    settings = settings or DecoderSettings()
    if not data:
        return b""
    if settings.dictionary:
        raise _not_ported("preset dictionaries")
    d, blocks, pos = _scan_single_frame(data)
    decoded = iter(
        decode_block_parts(
            [data[off : off + length] for off, length, st in blocks if not st],
            d.block_size,
            dev,
        )
    )
    result = b"".join(
        data[off : off + length] if st else next(decoded).tobytes()
        for off, length, st in blocks
    )
    if d.content_checksum:
        (expected,) = struct.unpack_from("<I", data, pos)
        if xxh32(result) != expected:
            raise LZ4FormatError("content checksum mismatch")
    if d.content_length is not None and len(result) != d.content_length:
        raise LZ4FormatError(
            f"content length mismatch: {len(result)} != {d.content_length}"
        )
    return result
