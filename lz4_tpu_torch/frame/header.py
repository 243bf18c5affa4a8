"""LZ4 frame header codec.

Implements the public LZ4 Frame Format spec v1.6.x (magic 0x184D2204,
FLG/BD/[content size]/[dict id]/HC), the same wire format the reference
builds in `TryStashFrame` (`Frames/LZ4FrameWriter.cs:57-108`) and parses in
`ReadHeader` (`Frames/LZ4FrameReader.blocking.cs:57-115`).
"""

from __future__ import annotations

import struct

from ..constants import (
    BLOCK_SIZE_CODES,
    FRAME_MAGIC,
    LEGACY_FRAME_MAGIC,
    SKIPPABLE_MAGIC_MIN,
    SKIPPABLE_MAGIC_MAX,
)
from ..xxh32 import xxh32
from .descriptor import FrameDescriptor

__all__ = ["build_header", "parse_header", "LZ4FormatError", "HeaderInfo"]

_FLG_VERSION = 0b01 << 6
_FLG_BLOCK_INDEP = 1 << 5
_FLG_BLOCK_CHECKSUM = 1 << 4
_FLG_CONTENT_SIZE = 1 << 3
_FLG_CONTENT_CHECKSUM = 1 << 2
_FLG_DICT_ID = 1 << 0


class LZ4FormatError(ValueError):
    """Malformed or unsupported LZ4 frame data (analog of the reference's
    InvalidDataException paths, `Frames/LZ4FrameReader.cs:184-194`)."""

    # True for a block length word over the frame's limit, which one-shot
    # decompress raises before any block decodes (`reader.read_block`)
    over_limit = False


def _header_checksum(descriptor_bytes: bytes) -> int:
    """HC byte: second byte of xxh32 of FLG..end-of-descriptor."""
    return (xxh32(descriptor_bytes) >> 8) & 0xFF


def build_header(d: FrameDescriptor) -> bytes:
    flg = _FLG_VERSION
    if not d.block_chaining:
        flg |= _FLG_BLOCK_INDEP
    if d.block_checksum:
        flg |= _FLG_BLOCK_CHECKSUM
    if d.content_length is not None:
        flg |= _FLG_CONTENT_SIZE
    if d.content_checksum:
        flg |= _FLG_CONTENT_CHECKSUM
    if d.dictionary_id is not None:
        flg |= _FLG_DICT_ID
    bd = d.block_size_code << 4
    body = bytes([flg, bd])
    if d.content_length is not None:
        body += struct.pack("<Q", d.content_length)
    if d.dictionary_id is not None:
        body += struct.pack("<I", d.dictionary_id)
    return (
        struct.pack("<I", FRAME_MAGIC) + body + bytes([_header_checksum(body)])
    )


class HeaderInfo:
    """Result of parsing the stream head: either an LZ4 frame descriptor, a
    skippable frame, or the legacy frame format."""

    __slots__ = ("kind", "descriptor", "skip_length", "header_length")

    def __init__(self, kind, descriptor=None, skip_length=0, header_length=0):
        self.kind = kind  # "frame" | "skippable" | "legacy"
        self.descriptor = descriptor
        self.skip_length = skip_length
        self.header_length = header_length


def parse_magic(magic: int) -> str | None:
    if magic == FRAME_MAGIC:
        return "frame"
    if SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX:
        return "skippable"
    if magic == LEGACY_FRAME_MAGIC:
        return "legacy"
    return None


def parse_header(read) -> HeaderInfo | None:
    """Parse a frame header from ``read(n) -> bytes`` (exact-or-fewer reader).

    Returns None on clean EOF before any magic byte.
    """
    magic_bytes = read(4)
    if len(magic_bytes) == 0:
        return None
    if len(magic_bytes) < 4:
        raise LZ4FormatError("truncated frame magic")
    (magic,) = struct.unpack("<I", magic_bytes)
    kind = parse_magic(magic)
    if kind is None:
        raise LZ4FormatError(f"invalid magic 0x{magic:08X}")
    if kind == "skippable":
        size_bytes = read(4)
        if len(size_bytes) < 4:
            raise LZ4FormatError("truncated skippable frame size")
        (size,) = struct.unpack("<I", size_bytes)
        return HeaderInfo("skippable", skip_length=size, header_length=8)
    if kind == "legacy":
        return HeaderInfo("legacy", header_length=4)

    fixed = read(2)
    if len(fixed) < 2:
        raise LZ4FormatError("truncated frame descriptor")
    flg, bd = fixed
    if (flg >> 6) != 0b01:
        raise LZ4FormatError(f"unsupported frame version {flg >> 6}")
    if flg & 0b10:
        raise LZ4FormatError("reserved FLG bit set")
    if bd & 0b10001111:
        raise LZ4FormatError("reserved BD bits set")
    bs_code = (bd >> 4) & 0b111
    if bs_code not in BLOCK_SIZE_CODES:
        raise LZ4FormatError(f"invalid block size code {bs_code}")

    body = bytes([flg, bd])
    content_length = None
    if flg & _FLG_CONTENT_SIZE:
        cs = read(8)
        if len(cs) < 8:
            raise LZ4FormatError("truncated content size")
        (content_length,) = struct.unpack("<Q", cs)
        body += cs
    dictionary_id = None
    if flg & _FLG_DICT_ID:
        di = read(4)
        if len(di) < 4:
            raise LZ4FormatError("truncated dictionary id")
        (dictionary_id,) = struct.unpack("<I", di)
        body += di
    hc = read(1)
    if len(hc) < 1:
        raise LZ4FormatError("truncated header checksum")
    expected = _header_checksum(body)
    if hc[0] != expected:
        raise LZ4FormatError(
            f"invalid header checksum 0x{hc[0]:02X} (expected 0x{expected:02X})"
        )
    d = FrameDescriptor(
        content_length=content_length,
        content_checksum=bool(flg & _FLG_CONTENT_CHECKSUM),
        block_chaining=not (flg & _FLG_BLOCK_INDEP),
        block_checksum=bool(flg & _FLG_BLOCK_CHECKSUM),
        dictionary_id=dictionary_id,
        block_size=BLOCK_SIZE_CODES[bs_code],
    )
    return HeaderInfo("frame", descriptor=d, header_length=4 + len(body) + 1)
