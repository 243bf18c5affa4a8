"""One-shot frame compress and decompress.

The port of the device path of `lz4_tpu/frame/api.py`.  `compress` encodes
every block of the frame in one launch, at any level 0-12: independent
blocks on kernel B (at most 64 KB) or D (larger), chained blocks on D, each
with the 64 KB of plaintext before it as its dictionary.  `decompress`
scans the frame's block table on the host and uploads the frame once; an
independent frame copies its stored blocks and decodes the compressed ones
in one batch on kernel A, a chained frame in one call of the chained
decoder (every block at once).  Every block and content checksum is
computed on the device by kernel E, over bytes that are already there: the
payload and the compressed rows on compress, the frame and the decoded
content on decompress.  An independent frame decodes as if a preset
dictionary were absent: its blocks reach none.  Frames with a dictionary
ID and multi-frame streams take the JAX package's FrameReader, which is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import NamedTuple

import torch

from ..block import LZ4Error
from ..constants import _as_bytes, compress_bound
from ..ops.common import resolve_device
from ..ops.decode_stream import decode_chain
from ..ops.xxh32 import as_uint32, xxh32_windows
from ..parallel.blocks import (
    decode_frame_blocks, encode_blocks, encode_blocks_chained_device, upload,
)
from .descriptor import DecoderSettings, EncoderSettings
from .header import LZ4FormatError, build_header, parse_header, parse_magic

__all__ = ["compress", "decompress"]

_UNCOMPRESSED_FLAG = 0x80000000


def _assemble_frame(d, data, bs, payloads, csum=None, block_sums=None) -> bytes:
    """Assemble one frame: header, per-block stored-vs-compressed framing
    (a block is STORED when its compressed payload is not smaller — the
    upstream rule), optional block checksums, EndMark, optional content
    checksum.  `payloads` are per-block compressed candidates, in frame
    order; `block_sums` their checksums, computed on the device
    (`parallel.blocks.block_checksums`) when ``d.block_checksum``."""
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
            parts.append(struct.pack("<I", block_sums[i]))
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
        f"{what} decode through FrameReader, which is not ported yet "
        "(ROADMAP.md Queue 1, item 8)"
    )


def compress(
    data,
    settings: EncoderSettings | None = None,
    store_size: bool = False,
    device="cuda",
) -> bytes:
    """Compress ``data`` into one LZ4 frame, every block encoded in one
    launch on ``device`` (the plain versions when ``device="cpu"``).

    The default settings make a chained frame with the sequential chain
    encoder's bytes (each block with the 64 KB of plaintext before it as
    its dictionary).  At levels 0-2 independent blocks take the canonical
    schedule unless ``geometry="dense"``, and a canonical chained frame of
    more than one block needs upstream's sequential continue schedule, a
    host path: it raises ValueError, as a device request does in the JAX
    package.  Levels 3-12 take the HC and OPT arms whatever the geometry.

    A declared ``content_length`` other than ``len(data)`` raises
    ValueError when the payload fits one block, as the JAX package's
    FrameWriter does at close; a larger payload is framed as declared, as
    its threaded and device routes frame it."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    settings = settings or EncoderSettings()
    if store_size and settings.content_length is None:
        settings = dataclasses.replace(settings, content_length=len(data))
    declared = settings.content_length
    if (declared is not None and declared != len(data)
            and len(data) <= settings.block_size):
        raise ValueError(
            f"content length mismatch: declared {declared}, wrote {len(data)}"
        )
    if (
        settings.chain_blocks
        and len(data) <= settings.block_size
        and (settings.compression_level >= 3 or settings.geometry == "canonical")
    ):
        # LZ4F_compressFrame's single-block rule: linkage is meaningless
        # for one block and the payload is identical
        settings = dataclasses.replace(settings, chain_blocks=False)
    if not settings.chain_blocks and len(data) <= settings.block_size:
        # upstream LZ4F_optimalBSID: the smallest standard block size that
        # holds the whole payload
        bs_opt = 65536
        while bs_opt < len(data):
            bs_opt <<= 2
        if bs_opt < settings.block_size:
            settings = dataclasses.replace(settings, block_size=bs_opt)
    if (
        settings.chain_blocks
        and settings.geometry == "canonical"
        and settings.compression_level < 3
    ):
        # (HC/OPT chains meet the canonical request with their per-block
        # window engines, as every chained frame here does)
        raise ValueError(
            "canonical chained (continue-schedule) frames are a "
            "sequential host path (ROADMAP.md Queue 1, item 8); use "
            "geometry='auto' or 'dense' on a device"
        )
    d = settings.to_descriptor()
    payload = upload(data, dev)
    if settings.chain_blocks:
        blocks = encode_blocks_chained_device(
            payload, settings.block_size, settings.compression_level,
            device=dev, checksums=d.block_checksum,
        )
    else:
        blocks = encode_blocks(
            payload,
            block_size=settings.block_size,
            level=settings.compression_level,
            geometry=_independent_geometry(settings),
            device=dev,
            checksums=d.block_checksum,
        )
    sums = None
    if d.block_checksum:
        blocks, sums = blocks
    csum = None
    if d.content_checksum:
        (csum,) = as_uint32(xxh32_windows(payload, [0], [len(data)]))
    return _assemble_frame(d, data, settings.block_size, blocks, csum, sums)


class _Scan(NamedTuple):
    """A frame's block table, scanned on the host up to its first fault."""

    descriptor: object
    blocks: list  # (offset, length, stored) of each whole block, in order
    tail: int  # the position after the EndMark
    fault: Exception | None = None
    # False for a block length over the limit, which is raised before any
    # block decodes, as the JAX package's scan raises it
    decode_first: bool = True


class _LengthOverLimit(Exception):
    """A block length word over the frame's limit (`_scan_blocks`)."""


def _scan_single_frame(data: bytes):
    """Parse one frame's block table on the host.

    Returns (descriptor, [(offset, length, stored)], tail_pos).  Raises
    LZ4FormatError on a malformed or truncated frame and
    NotImplementedError on what FrameReader alone decodes.  Block
    checksums are not verified here (`_verify_blocks` does that on the
    device)."""
    scan = _scan_frame(data)
    if scan.fault is not None:
        raise scan.fault
    return scan.descriptor, scan.blocks, scan.tail


def _scan_frame(data: bytes) -> _Scan:
    """`_scan_single_frame` that returns a fault found after the header
    instead of raising it.  ``blocks`` then holds the blocks scanned before
    the fault whose checksum field is whole, so that a checksum mismatch
    and then a malformed block among them are reported first, as a
    sequential reader would."""
    src = io.BytesIO(data)
    info = parse_header(src.read)
    if info.kind != "frame":
        raise _not_ported(f"{info.kind} frames")
    d = info.descriptor
    if d.dictionary_id is not None:
        raise _not_ported("frames with a dictionary ID")
    blocks = []
    pos = info.header_length
    try:
        pos = _scan_blocks(data, d, pos, blocks)
    except _LengthOverLimit as e:
        fault = LZ4FormatError(f"block length {e.args[0]} exceeds block size limit")
        return _Scan(d, blocks, pos, fault, decode_first=False)
    except (LZ4FormatError, NotImplementedError) as fault:
        return _Scan(d, blocks, pos, fault)
    return _Scan(d, blocks, pos)


def _scan_blocks(data: bytes, d, pos: int, blocks: list) -> int:
    """Walk the block table from ``pos``, appending each whole block's
    (offset, length, stored) to ``blocks``; returns the position after the
    EndMark, or raises on a malformed or truncated table or tail."""
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
            raise _LengthOverLimit(length)
        if pos + length > n:
            raise LZ4FormatError("truncated block data")
        if d.block_checksum and pos + length + 4 > n:
            raise LZ4FormatError("truncated block checksum")
        blocks.append((pos, length, stored))
        pos += length + (4 if d.block_checksum else 0)
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
    return pos


def _verify_blocks(frame, data: bytes, blocks) -> None:
    """Every block checksum in one launch of kernel E over the blocks'
    windows of the uploaded frame; raises on the first mismatch."""
    if not blocks:
        return
    got = as_uint32(xxh32_windows(
        frame, [off for off, _, _ in blocks], [n for _, n, _ in blocks]))
    for (off, length, _), h in zip(blocks, got):
        if struct.unpack_from("<I", data, off + length)[0] != h:
            raise LZ4FormatError("block checksum mismatch")


def _decode_chained(frame, d, blocks, dictionary, error=LZ4FormatError):
    """A chained frame's blocks, decoded in one call of the chained
    decoder (every block at once); the first block's window is the last
    64 KB of ``dictionary``.  Raises ``error`` on the first malformed
    block.  Returns the content on the frame's device."""
    preset = None
    if dictionary:
        preset = torch.frombuffer(
            bytearray(bytes(dictionary)[-65536:]), dtype=torch.uint8
        )
    table = torch.tensor(blocks, dtype=torch.int64).reshape(-1, 3)
    stream, status = decode_chain(frame, table, d.block_size, preset)
    written, bad, err = status.tolist()
    if bad >= 0:
        raise error(f"malformed chained block {bad} (err={err})")
    return stream[:written]


def _decode_blocks(frame, d, blocks, dictionary, error=LZ4FormatError):
    """The content of ``blocks``: a chained frame in one call of the
    chained decoder, an independent one in one batch on kernel A (its
    blocks reach no dictionary, so a preset one is not used).  Raises on
    the first malformed block: LZ4Error for an independent frame, ``error``
    for a chained one."""
    if d.block_chaining:
        return _decode_chained(frame, d, blocks, dictionary, error)
    return decode_frame_blocks(frame, blocks, d.block_size)


def decompress(
    data,
    settings: DecoderSettings | None = None,
    device="cuda",
) -> bytes:
    """Decompress one LZ4 frame on ``device`` (the plain versions when
    ``device="cpu"``).  The frame goes to the device once and its block
    checksums are verified there before any block decodes.  An independent
    frame's compressed blocks decode in one batch and its stored ones are
    copied, in frame order; a chained frame decodes in one call, with
    ``settings.dictionary`` as the preset dictionary.  The content checksum
    is verified on the decoded content on the device, which then comes
    back in one copy.

    A frame cut short or followed by other bytes raises in the order a
    sequential reader gives: a block checksum mismatch, then a malformed
    block before the fault (LZ4Error), then the fault itself."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    settings = settings or DecoderSettings()
    if not data:
        return b""
    scan = _scan_frame(data)
    d, blocks = scan.descriptor, scan.blocks
    frame = upload(data, dev)
    if d.block_checksum:
        _verify_blocks(frame, data, blocks)
    if scan.fault is not None:
        if scan.decode_first and blocks:
            _decode_blocks(frame, d, blocks, settings.dictionary, LZ4Error)
        raise scan.fault
    content = _decode_blocks(frame, d, blocks, settings.dictionary)
    if d.content_checksum:
        (expected,) = struct.unpack_from("<I", data, scan.tail)
        if as_uint32(xxh32_windows(content, [0], [content.numel()]))[0] != expected:
            raise LZ4FormatError("content checksum mismatch")
    if d.content_length is not None and content.numel() != d.content_length:
        raise LZ4FormatError(
            f"content length mismatch: {content.numel()} != {d.content_length}"
        )
    return content.cpu().numpy().tobytes()
