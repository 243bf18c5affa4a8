"""LZ4 frame reader: the port of `lz4_tpu/frame/reader.py`.

Decodes `.lz4` streams from a ``read(n)`` source: concatenated frames,
skippable frames, the lz4 CLI's legacy frames (magic 0x184C2102) and
frames with a dictionary ID (decoded with the preset dictionary).  Each
pull reads, block header by block header, the whole blocks that the
caller's request needs (all of a frame for `read_all`), uploads them to the
device once and decodes them in one launch: independent and legacy blocks
on kernel A, chained ones in one call of the chained decoder with the
previous 64 KB of the frame (or the preset dictionary) as their window.
Block checksums are checked by kernel E, the content hash by its
streaming form.  Faults come out in the order a reader that takes one
block at a time gives them: a block checksum mismatch, or a malformed
block before it, then the fault that ended the pull (a cut, a length over
the limit).  The exception classes and the format faults' messages are the
JAX package's FrameReader's.
"""

from __future__ import annotations

import struct

import torch

from ..block import LZ4Error
from ..constants import compress_bound
from ..ops.common import resolve_device
from ..ops.decode_stream import decode_chain
from ..ops.xxh32 import as_uint32, xxh32_windows
from ..parallel.blocks import comp_capacity, decode_frame_blocks, upload
from ..xxh32 import XXH32
from .descriptor import FrameDescriptor
from .header import LZ4FormatError, parse_header, parse_magic

__all__ = ["FrameReader", "LZ4FormatError", "read_block"]

_UNCOMPRESSED_FLAG = 0x80000000
_LEGACY_BLOCK_SIZE = 8 * 1024 * 1024
_WINDOW = 65536
# the most device memory one pull's staged rows and output take: a stream
# of many short blocks (legacy blocks stage at 8 MiB each) decodes in
# several launches
_PULL_BYTES = 1 << 30


def read_block(read, d: FrameDescriptor):
    """The next block of an LZ4 frame's block table, read through
    ``read(n)`` (short only at the end of its source): its (data, stored,
    checksum or None), or None at the EndMark.  Raises LZ4FormatError with
    the JAX package's messages on a cut, and on a length word over the
    frame's limit (with ``over_limit`` set)."""
    head = read(4)
    if len(head) < 4:
        raise LZ4FormatError("truncated block length")
    (word,) = struct.unpack("<I", head)
    if word == 0:
        return None
    stored = bool(word & _UNCOMPRESSED_FLAG)
    length = word & ~_UNCOMPRESSED_FLAG
    limit = d.block_size_limit
    if length > (limit if stored else compress_bound(limit)):
        # a crafted length word must not reach the decoder
        fault = LZ4FormatError(f"block length {length} exceeds block size limit")
        fault.over_limit = True
        raise fault
    data = read(length)
    if len(data) < length:
        raise LZ4FormatError("truncated block data")
    checksum = None
    if d.block_checksum:
        cs = read(4)
        if len(cs) < 4:
            raise LZ4FormatError("truncated block checksum")
        (checksum,) = struct.unpack("<I", cs)
    return data, stored, checksum


class _Pull:
    """The whole blocks of one pull, read from the source: their bytes end
    to end, each block's (offset, length, stored), the stored checksums,
    and how the pull ended."""

    def __init__(self):
        self.parts = []
        self.table = []
        self.sums = []
        self.size = 0
        self.fault = None  # the fault that ended the pull
        self.ended = False  # the frame ended

    def add(self, data: bytes, stored: bool = False):
        self.table.append((self.size, len(data), stored))
        self.parts.append(data)
        self.size += len(data)


class FrameReader:
    """Streaming LZ4 frame decompressor over a ``read(n)`` source, on
    ``device`` (the plain versions when ``device="cpu"``).

    ``read(n)`` returns up to n decompressed bytes (b"" at EOF); ``read_all``
    drains everything.  Concatenated and skippable frames are handled
    transparently.
    """

    def __init__(self, source, dictionary: bytes = b"", device="cuda",
                 extra_memory: int = 0):
        self._dev = resolve_device(device)
        self._source = source
        self._extra_memory = extra_memory
        self._preset_dict = bytes(dictionary)
        self._descriptor: FrameDescriptor | None = None
        self._legacy = False
        self._window = None  # a chained frame's last 64 KB, on the device
        self._content_hash: XXH32 | None = None
        self._content_length: int | None = None
        self._produced_in_frame = 0
        self._buffer = bytearray()  # decoded, not yet drained
        self._eof = False
        self._in_frame = False
        self._bytes_read = 0
        self._pushback = b""  # a magic read by a legacy frame's block loop

    # -- plumbing -----------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        out = bytearray(self._pushback[:n])
        self._pushback = self._pushback[n:]
        while len(out) < n:
            chunk = self._source.read(n - len(out))
            if not chunk:
                break
            out += chunk
        self._bytes_read += len(out)
        return bytes(out)

    @property
    def bytes_read(self) -> int:
        """Raw compressed bytes consumed."""
        return self._bytes_read

    @property
    def frame_descriptor(self) -> FrameDescriptor | None:
        return self._descriptor

    def frame_length(self) -> int | None:
        """Content size from the frame header, when present."""
        self._ensure_frame()
        return self._content_length

    # -- frame state machine --------------------------------------------------

    def _ensure_frame(self) -> bool:
        """Enter the next frame if not inside one.  False at clean EOF."""
        while not self._in_frame and not self._eof:
            info = parse_header(self._read_exact)
            if info is None:
                self._eof = True
                return False
            if info.kind == "skippable":
                skipped = self._read_exact(info.skip_length)
                if len(skipped) < info.skip_length:
                    raise LZ4FormatError("truncated skippable frame")
                continue
            self._legacy = info.kind == "legacy"
            if self._legacy:
                self._descriptor = FrameDescriptor(
                    block_chaining=False, block_size=_LEGACY_BLOCK_SIZE
                )
                self._content_length = None
            else:
                self._descriptor = info.descriptor
                self._content_length = info.descriptor.content_length
            self._in_frame = True
            self._produced_in_frame = 0
            self._window = upload(self._preset_dict[-_WINDOW:], self._dev)
            self._content_hash = (
                XXH32()
                if (not self._legacy and self._descriptor.content_checksum)
                else None
            )
        return self._in_frame

    def _finish_frame(self):
        if not self._legacy and self._descriptor.content_checksum:
            cs = self._read_exact(4)
            if len(cs) < 4:
                raise LZ4FormatError("truncated content checksum")
            (expected,) = struct.unpack("<I", cs)
            actual = self._content_hash.digest()
            if actual != expected:
                raise LZ4FormatError(
                    f"content checksum mismatch 0x{actual:08X} != 0x{expected:08X}"
                )
        if (
            self._content_length is not None
            and self._produced_in_frame != self._content_length
        ):
            raise LZ4FormatError(
                f"content length mismatch: {self._produced_in_frame} != "
                f"{self._content_length}"
            )
        self._in_frame = False

    def _full(self, pull: _Pull, want, max_blocks, bound: int) -> bool:
        """Whether the pull holds what the request needs: ``want`` bytes
        at most ``bound`` per block, or ``max_blocks`` blocks, or the
        blocks whose rows and output fill `_PULL_BYTES`."""
        n = len(pull.table)
        return ((want is not None and n * bound >= want)
                or (max_blocks is not None and n >= max_blocks)
                or n * (comp_capacity(bound) + bound) >= _PULL_BYTES)

    def _read_blocks(self, want, max_blocks) -> _Pull:
        """Read an LZ4 frame's whole blocks until the request is met, the
        EndMark, or a fault."""
        d = self._descriptor
        pull = _Pull()
        while not self._full(pull, want, max_blocks, d.block_size_limit):
            try:
                block = read_block(self._read_exact, d)
            except LZ4FormatError as fault:
                pull.fault = fault
                break
            if block is None:  # EndMark
                pull.ended = True
                break
            data, stored, checksum = block
            if checksum is not None:
                pull.sums.append(checksum)
            pull.add(data, stored)
        return pull

    def _read_legacy(self, want, max_blocks) -> _Pull:
        """Read a legacy frame's blocks until the request is met, EOF, the
        next frame's magic (legacy frames have no EndMark), or a fault."""
        pull = _Pull()
        while not self._full(pull, want, max_blocks, _LEGACY_BLOCK_SIZE):
            head = self._read_exact(4)
            if len(head) == 0:
                self._eof = True
                pull.ended = True
                break
            if len(head) < 4:
                pull.fault = LZ4FormatError("truncated legacy block header")
                break
            (word,) = struct.unpack("<I", head)
            if parse_magic(word) is not None:
                # the next frame begins: read its magic again
                self._pushback = head + self._pushback
                self._bytes_read -= 4
                pull.ended = True
                break
            if word > compress_bound(_LEGACY_BLOCK_SIZE):
                # a crafted length word must fail fast, not buffer
                # gigabytes from a slow source
                pull.fault = LZ4FormatError(
                    f"legacy block length {word} exceeds the 8 MiB "
                    "legacy block bound"
                )
                break
            data = self._read_exact(word)
            if len(data) < word:
                pull.fault = LZ4FormatError("truncated legacy block")
                break
            pull.add(data)
        return pull

    def _decode(self, blob, table) -> torch.Tensor:
        """The content of ``table``'s blocks of ``blob`` (on the device), in
        one launch; raises LZ4Error on the first malformed block."""
        d = self._descriptor
        if not table:
            return blob[:0]
        if not d.block_chaining:
            return decode_frame_blocks(blob, table, d.block_size)
        tab = torch.tensor(table, dtype=torch.int64).reshape(-1, 3)
        stream, status = decode_chain(blob, tab, d.block_size, self._window)
        written, bad, err = status.tolist()
        if bad >= 0:
            raise LZ4Error(f"malformed chained block {bad} (err={err})")
        content = stream[:written]
        keep = min(max(_WINDOW - written, 0), self._window.numel())
        self._window = torch.cat([self._window[self._window.numel() - keep:],
                                  content[-_WINDOW:]])
        return content

    def _pull(self, want: int | None = None, max_blocks: int | None = None) -> bool:
        """Decode the whole blocks that the request needs (``want`` bytes,
        ``max_blocks`` blocks, or the rest of the frame) into the buffer,
        in one launch.  False when the frame ended."""
        if self._legacy:
            pull = self._read_legacy(want, max_blocks)
        else:
            pull = self._read_blocks(want, max_blocks)
        blob = upload(b"".join(pull.parts), self._dev)
        good, got = len(pull.table), []
        if pull.sums:
            got = as_uint32(xxh32_windows(
                blob, [off for off, _, _ in pull.table],
                [n for _, n, _ in pull.table]))
            good = next((i for i, (g, e) in enumerate(zip(got, pull.sums))
                         if g != e), good)
        content = self._decode(blob, pull.table[:good])
        if self._content_hash is not None:
            self._content_hash.update(content)
        self._produced_in_frame += content.numel()
        self._buffer += content.cpu().numpy().tobytes()
        if good < len(pull.table):
            raise LZ4FormatError(
                f"block checksum mismatch 0x{got[good]:08X} != "
                f"0x{pull.sums[good]:08X}"
            )
        if pull.fault is not None:
            raise pull.fault
        if not pull.ended:
            return True
        if self._legacy:
            self._in_frame = False
        else:
            self._finish_frame()
        return False

    # -- public drain API -----------------------------------------------------

    def read(self, n: int = -1) -> bytes:
        """Read up to ``n`` decompressed bytes (all remaining if n < 0)."""
        if n is None or n < 0:
            return self.read_all()
        while len(self._buffer) < n:
            if not self._ensure_frame():
                break
            if not self._pull(want=n - len(self._buffer)):
                continue  # frame ended; maybe another frame follows
        out = bytes(self._buffer[:n])
        del self._buffer[:n]
        return out

    def read_all(self) -> bytes:
        while self._ensure_frame():
            while self._pull():
                pass
        out = bytes(self._buffer)
        self._buffer.clear()
        return out

    def read1(self, n: int = -1) -> bytes:
        """Interactive read: return available bytes as soon as any are
        ready, decoding one block when none are buffered, then
        ``extra_memory`` // block_size blocks of read-ahead in one launch.
        ``n`` is the byte budget (< 0: everything buffered); surplus stays
        buffered."""
        while not self._buffer:
            if not self._ensure_frame():
                break
            if not self._pull(max_blocks=1):
                continue
        if self._buffer and self._extra_memory and self._in_frame:
            extra = self._extra_memory // max(self._descriptor.block_size, 1)
            if extra:
                self._pull(max_blocks=extra)
        if n is None or n < 0 or n >= len(self._buffer):
            out = bytes(self._buffer)
            self._buffer.clear()
            return out
        out = bytes(self._buffer[:n])
        del self._buffer[:n]
        return out

    def peek(self, n: int = -1) -> bytes:
        """Up to ``n`` decoded bytes, not consumed.  Decodes at most one
        block when the buffer is empty."""
        if not self._buffer:
            if self._ensure_frame():
                self._pull(max_blocks=1)
        if n is None or n < 0:
            return bytes(self._buffer)
        return bytes(self._buffer[:n])

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __iter__(self):
        while True:
            chunk = self.read1()
            if not chunk:
                return
            yield chunk
