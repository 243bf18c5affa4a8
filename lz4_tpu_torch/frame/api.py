"""One-shot frame compress and decompress, and the frame facades.

The port of `lz4_tpu/frame/api.py`.  `compress` encodes
every block of the frame in one launch, at any level 0-12: independent
blocks on kernel B (at most 64 KB) or D (larger), chained blocks on D, each
with the 64 KB of plaintext before it as its dictionary.  `decompress`
scans the frame's block table on the host and uploads the frame once; an
independent frame copies its stored blocks and decodes the compressed ones
in one batch on kernel A, a chained frame in one call of the chained
decoder (every block at once).  Every block and content checksum is
computed on the device by kernel E, over bytes that are already there: the
payload and the compressed rows on compress, the frame and the decoded
content on decompress; the content checksum on E's side stream, beside the
encode on compress and beside the content's copy to the host on
decompress.  An independent frame decodes as if a preset
dictionary were absent: its blocks reach none.  A stream that is not one
whole frame (concatenated frames, skippable and legacy frames, a frame
with a dictionary ID or a preset dictionary, a frame cut short) takes the
port's `FrameReader`, which decodes each frame's blocks in one launch too,
as the JAX package's host route takes its FrameReader; the two routes'
exceptions are the JAX package's on each.  With ``mesh=`` (a
`parallel.make_mesh` list of devices) the independent blocks of a payload
of more than one block encode, and a single independent frame of only
compressed blocks decodes, on the dense codecs X1 and X2 split over the
mesh: the JAX package's mesh frames; anything else takes the route above
on the mesh's first device.  `compress_into`, `decompress_into`,
`skippable_frame`, `LZ4FrameFile` and `open` are the JAX package's
facades.
"""

from __future__ import annotations

import builtins
import dataclasses
import io
import struct
from typing import NamedTuple

import torch

from ..block import LZ4Error
from ..constants import SKIPPABLE_MAGIC_MIN, _as_bytes
from ..ops.common import resolve_device
from ..ops.decode_stream import decode_chain
from ..ops.xxh32 import as_uint32, xxh32_content, xxh32_windows
from ..parallel.blocks import (
    decode_frame_blocks, encode_blocks, encode_blocks_chained_device,
    encode_blocks_continue_device, upload,
)
from .descriptor import DecoderSettings, EncoderSettings
from .header import LZ4FormatError, build_header, parse_header
from .reader import FrameReader, read_block
from .writer import FrameWriter

__all__ = [
    "compress",
    "compress_into",
    "decompress",
    "decompress_into",
    "skippable_frame",
    "LZ4FrameFile",
    "open",
]

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


def skippable_frame(user_data, nibble: int = 0) -> bytes:
    """A skippable frame (magic 0x184D2A5n, LE u32 size, payload) carrying
    ``user_data``: every conforming decoder ignores it.  ``nibble`` picks
    one of the 16 skippable magics (0..15)."""
    if not 0 <= nibble <= 0xF:
        raise ValueError(f"skippable nibble {nibble} not in 0..15")
    payload = _as_bytes(user_data)
    if len(payload) > 0xFFFFFFFF:
        raise ValueError(
            f"skippable payload {len(payload)} bytes exceeds the frame-spec "
            "u32 size field (4294967295)"
        )
    return struct.pack("<II", SKIPPABLE_MAGIC_MIN + nibble, len(payload)) + payload


def compress(
    data,
    settings: EncoderSettings | None = None,
    store_size: bool = False,
    device="cuda",
    mesh=None,
) -> bytes:
    """Compress ``data`` into one LZ4 frame, every block encoded in one
    launch on ``device`` (the plain versions when ``device="cpu"``).

    The default settings make a chained frame with the sequential chain
    encoder's bytes (each block with the 64 KB of plaintext before it as
    its dictionary).  At levels 0-2 independent blocks take the canonical
    schedule unless ``geometry="dense"``, and a canonical chained frame of
    more than one block takes upstream's continue schedule
    (LZ4_compress_fast_continue, the bytes of liblz4's linked blocks and of
    the JAX package's host route) on kernel F: every block walked at once
    from a guessed table, in rounds that re-walk only the blocks whose
    table changed, and after `encode_continue.MAX_ROUNDS` rounds a serial
    tail; with ``mesh`` it raises ValueError, as the JAX package's device
    routes do.  Levels 3-12 take the HC and OPT arms whatever the geometry.

    A declared ``content_length`` other than ``len(data)`` raises
    ValueError when the payload fits one block, as the JAX package's
    FrameWriter does at close; a larger payload is framed as declared, as
    the JAX package's device route (``backend="tpu"``) frames it on a TPU,
    independent and chained.  A length outside [0, 2^64) raises
    struct.error at every size, as the JAX package's header packing does.

    With ``mesh``, an independent payload of more than one block is split
    over the mesh's devices and encoded by X1 (`parallel.encode_blocks`):
    the bytes of the JAX package's ``compress(..., mesh=...)``, which differ
    from this function's without a mesh.  Any other payload takes the route
    above on the mesh's first device."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    data = _as_bytes(data)
    settings = settings or EncoderSettings()
    if store_size and settings.content_length is None:
        settings = dataclasses.replace(settings, content_length=len(data))
    declared = settings.content_length
    if declared is not None:
        # the header's u64 field first: a length outside [0, 2^64) raises
        # struct.error at every size, as the JAX package's header packing does
        struct.pack("<Q", declared)
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
    # (HC/OPT chains meet the canonical request with their per-block window
    # engines, as every chained frame here does)
    continued = (settings.chain_blocks and settings.geometry == "canonical"
                 and settings.compression_level < 3)
    if continued and mesh is not None:
        raise ValueError(
            "canonical chained (continue-schedule) frames run one sequential "
            "schedule on one device; use geometry='auto'/'dense' with a mesh, "
            "or drop the mesh"
        )
    d = settings.to_descriptor()
    payload = upload(data, dev)
    # the content hash runs on kernel E's side stream beside the encode
    content = xxh32_content(payload) if d.content_checksum else None
    if continued:
        blocks = encode_blocks_continue_device(
            payload, settings.block_size, device=dev, checksums=d.block_checksum)
    elif settings.chain_blocks:
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
            mesh=mesh if len(data) > settings.block_size else None,
        )
    sums = None
    if d.block_checksum:
        blocks, sums = blocks
    csum = content.value() if content is not None else None
    return _assemble_frame(d, data, settings.block_size, blocks, csum, sums)


def compress_into(data, dst, settings: EncoderSettings | None = None,
                  device="cuda") -> int:
    """Compress ``data`` into one LZ4 frame written to the caller's buffer
    ``dst``: returns the frame's length; raises ValueError if it does not
    fit."""
    settings = settings or EncoderSettings()
    view = memoryview(dst).cast("B")
    if view.readonly:
        raise ValueError("destination buffer is read-only")
    blob = compress(data, settings=settings, device=device)
    if len(blob) > len(view):
        raise ValueError(
            f"destination {len(view)} too small for {len(blob)}-byte frame"
        )
    view[: len(blob)] = blob
    return len(blob)


class _Scan(NamedTuple):
    """A frame's block table, scanned on the host up to its first fault."""

    descriptor: object
    blocks: list  # (offset, length, stored) of each whole block, in order
    tail: int  # the position after the EndMark
    fault: Exception | None = None

    @property
    def end(self) -> int:
        """The position after the frame."""
        return self.tail + (4 if self.descriptor.content_checksum else 0)


def _scan_frame(data: bytes) -> _Scan:
    """Parse the block table of the LZ4 frame at the start of ``data`` on
    the host, with the reader's walker (`reader.read_block`).  A fault found
    after the header (a cut, a length over the limit) is returned, not
    raised: ``blocks`` then holds the blocks before it.  Block checksums are
    not verified here."""
    info = parse_header(io.BytesIO(data).read)
    if info is None or info.kind != "frame":
        raise ValueError("not an LZ4 frame")
    d = info.descriptor
    view = memoryview(data)
    pos = info.header_length

    def read(n):
        nonlocal pos
        out = view[pos:pos + n]
        pos += len(out)
        return out

    blocks = []
    try:
        while (block := read_block(read, d)) is not None:
            body, stored, checksum = block
            end = pos - (4 if checksum is not None else 0)
            blocks.append((end - len(body), len(body), stored))
        if d.content_checksum and pos + 4 > len(data):
            raise LZ4FormatError("truncated content checksum")
    except LZ4FormatError as fault:
        return _Scan(d, blocks, pos, fault)
    return _Scan(d, blocks, pos)


def _scan_single_frame(data: bytes):
    """A whole frame's (descriptor, [(offset, length, stored)], tail_pos);
    raises on a malformed or truncated frame."""
    scan = _scan_frame(data)
    if scan.fault is not None:
        raise scan.fault
    return scan.descriptor, scan.blocks, scan.tail


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


def _decode_frame(frame, data: bytes, scan: _Scan, chained_error, mesh=None) -> bytes:
    """One whole frame, uploaded as ``frame`` and its block checksums
    verified, on the one-shot route: an independent frame's compressed
    blocks decoded in one batch on kernel A (or split over ``mesh`` by X2)
    and its stored ones copied, a chained frame in one call of the chained
    decoder (raising ``chained_error`` on a malformed block).  The content
    checksum runs on the device beside the content's copy to the host and
    is verified after both, before the content length.  Returns the
    content."""
    d, blocks = scan.descriptor, scan.blocks
    if d.block_chaining:
        table = torch.tensor(blocks, dtype=torch.int64).reshape(-1, 3)
        stream, status = decode_chain(frame, table, d.block_size)
        written, bad, err = status.tolist()
        if bad >= 0:
            raise chained_error(f"malformed chained block {bad} (err={err})")
        content = stream[:written]
    else:
        content = decode_frame_blocks(frame, blocks, d.block_size, mesh=mesh)
    pending = xxh32_content(content) if d.content_checksum else None
    out = content.cpu().numpy().tobytes()
    if pending is not None:
        (expected,) = struct.unpack_from("<I", data, scan.tail)
        if pending.value() != expected:
            raise LZ4FormatError("content checksum mismatch")
    if d.content_length is not None and len(out) != d.content_length:
        raise LZ4FormatError(
            f"content length mismatch: {len(out)} != {d.content_length}"
        )
    return out


def _decompress(data: bytes, settings, dev, min_independent: int,
                chained_error, mesh=None) -> bytes:
    """The JAX package's host route, on ``dev``.  It scans a first LZ4
    frame without a dictionary ID, when no preset dictionary is given, and
    raises a block checksum mismatch (the short message) or a length over
    the limit found there before any block decodes.  It decodes that frame
    on the one-shot route when it is the whole stream and not cut short (a
    chained frame with a block, an independent one with at least
    ``min_independent``), and anything else with `FrameReader`.  With
    ``mesh``, a whole independent frame of only compressed blocks decodes
    by X2 over the mesh whatever its number of blocks, as the JAX
    package's mesh route does."""
    if not data:
        return b""
    scan = None
    if not settings.dictionary:
        try:
            scan = _scan_frame(data)
        except ValueError:  # not an LZ4 frame, or a malformed header
            pass
    if scan is not None and scan.descriptor.dictionary_id is None:
        d = scan.descriptor
        if mesh is not None and (d.block_chaining
                                 or any(st for _, _, st in scan.blocks)):
            mesh = None
        least = 1 if d.block_chaining else 0 if mesh is not None else min_independent
        whole = (scan.fault is None and scan.end == len(data)
                 and len(scan.blocks) >= least)
        frame = upload(data, dev) if whole or d.block_checksum else None
        if d.block_checksum:
            _verify_blocks(frame, data, scan.blocks)
        if scan.fault is not None and scan.fault.over_limit:
            raise scan.fault
        if whole:
            return _decode_frame(frame, data, scan, chained_error, mesh)
    reader = FrameReader(io.BytesIO(data), dictionary=settings.dictionary,
                         device=dev, extra_memory=settings.extra_memory)
    return reader.read_all()


def decompress(
    data,
    settings: DecoderSettings | None = None,
    device="cuda",
    mesh=None,
) -> bytes:
    """Decompress the LZ4 frames of ``data`` on ``device`` (the plain
    versions when ``device="cpu"``).

    One whole frame goes to the device once and its block checksums are
    verified there before any block decodes.  An independent frame's
    compressed blocks decode in one batch and its stored ones are copied,
    in frame order; a chained frame decodes in one call.  The decoded
    content comes back in one copy while its checksum runs on the device
    beside it; a mismatch raises before any byte is returned.  Any other stream (concatenated, skippable and
    legacy frames, dictionary IDs, ``settings.dictionary`` as the preset
    dictionary of chained frames, a frame cut short or followed by other
    bytes) is decoded frame by frame by `FrameReader`, each frame's blocks
    in one launch, and raises in the order a sequential reader gives: a
    block checksum mismatch, then a malformed block before the fault
    (LZ4Error), then the fault itself.

    With ``mesh``, a single whole independent frame of only compressed
    blocks decodes by X2 split over the mesh's devices
    (`parallel.decode_blocks`); any other stream takes the route above on
    the mesh's first device."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    return _decompress(_as_bytes(data), settings or DecoderSettings(), dev, 2,
                       LZ4FormatError, mesh)


def decompress_into(
    data,
    dst,
    settings: DecoderSettings | None = None,
    device="cuda",
) -> int:
    """Decompress LZ4 frames into the caller's buffer ``dst``, as
    `decompress` does, with one copy from the card: returns the decoded
    length; raises ValueError if ``dst`` is too small."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    settings = settings or DecoderSettings()
    view = memoryview(dst).cast("B")
    if view.readonly:
        raise ValueError("destination buffer is read-only")
    out = _decompress(data, settings, dev, 0, LZ4Error)
    if len(out) > len(view):
        raise ValueError(f"destination {len(view)} < decoded size {len(out)}")
    view[: len(out)] = out
    return len(out)


class LZ4FrameFile(io.RawIOBase):
    """A file-like LZ4 frame stream over ``inner``: a `FrameWriter` in a
    write mode, a `FrameReader` otherwise, on ``device``."""

    def __init__(
        self,
        inner,
        mode: str = "rb",
        settings: EncoderSettings | None = None,
        dictionary: bytes = b"",
        device="cuda",
        close_inner: bool = True,
    ):
        self._inner = inner
        self._close_inner = close_inner
        self._mode = mode
        if "w" in mode or "a" in mode or "x" in mode:
            self._writer = FrameWriter(inner, settings, device=device)
            self._reader = None
        else:
            self._reader = FrameReader(inner, dictionary=dictionary, device=device)
            self._writer = None
        self._pos = 0

    def readable(self):
        return self._reader is not None

    def writable(self):
        return self._writer is not None

    def read(self, n: int = -1) -> bytes:
        if self._reader is None:
            raise io.UnsupportedOperation("not open for reading")
        out = self._reader.read(n)
        self._pos += len(out)
        return out

    def read1(self, n: int = -1) -> bytes:
        if self._reader is None:
            raise io.UnsupportedOperation("not open for reading")
        out = self._reader.read1(n if n is not None else -1)
        self._pos += len(out)
        return out

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def write(self, data) -> int:
        if self._writer is None:
            raise io.UnsupportedOperation("not open for writing")
        n = self._writer.write(data)
        self._pos += n
        return n

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def tell(self) -> int:
        return self._pos

    @property
    def length(self) -> int | None:
        """Decoded content length when the frame header carries it."""
        if self._reader is not None:
            return self._reader.frame_length()
        return None

    def close(self):
        if self.closed:
            return
        try:
            if self._writer is not None:
                self._writer.close()
        finally:
            if self._close_inner and hasattr(self._inner, "close"):
                self._inner.close()
            super().close()


def open(
    filename,
    mode: str = "rb",
    settings: EncoderSettings | None = None,
    dictionary: bytes = b"",
    device="cuda",
):
    """Open an `.lz4` file (or a file object) for reading or writing, like
    ``gzip.open``."""
    if hasattr(filename, "read") or hasattr(filename, "write"):
        inner = filename
        close_inner = False
    else:
        resolve_device(device)  # before the file is created
        inner = builtins.open(filename, mode if "b" in mode else mode + "b")
        close_inner = True
    return LZ4FrameFile(inner, mode=mode, settings=settings,
                        dictionary=dictionary, device=device,
                        close_inner=close_inner)
