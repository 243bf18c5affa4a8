"""lz4net varint-chunk stream format: the port of
`lz4_tpu/legacy/stream.py`.

Each chunk is ``varint flags, varint originalLength, [varint
compressedLength], payload``: LSB-first 7-bit varints with a continuation
bit; flag bit 0 compressed, bit 1 the high-compression marker, bits 2-4
passes (must be 0).  An incompressible chunk is stored raw, without the
compressedLength field.  The writer encodes the whole chunks of a
`write()` in one launch (`parallel.encode_blocks`); the reader decodes
chunk by chunk on the card.
"""

from __future__ import annotations

import io

from ..block import LZ4Error
from ..block import api as block_api
from ..constants import LZ4Level, _as_bytes
from ..ops.common import resolve_device
from ..parallel.blocks import encode_blocks, upload

__all__ = ["LegacyStreamWriter", "LegacyStreamReader", "encode", "decode"]

_FLAG_COMPRESSED = 0x01
_FLAG_HC = 0x02
_FLAG_PASSES = 0x1C


def _write_varint(sink, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        sink.write(bytes([b | (0x80 if value else 0)]))
        if not value:
            return


def _read_varint(read) -> int | None:
    """None on clean EOF at a chunk boundary."""
    shift = 0
    value = 0
    first = True
    while True:
        b = read(1)
        if not b:
            if first:
                return None
            raise LZ4Error("truncated varint")
        first = False
        value |= (b[0] & 0x7F) << shift
        if not (b[0] & 0x80):
            return value
        shift += 7
        if shift > 63:
            raise LZ4Error("varint too long")


class LegacyStreamWriter:
    """Chunked lz4net-format compressor over a ``write(bytes)`` sink."""

    def __init__(self, sink, high_compression: bool = False,
                 block_size: int = 1024 * 1024, device="cuda"):
        self._dev = resolve_device(device)
        self._sink = sink
        self._level = (
            int(LZ4Level.L09_HC) if high_compression else int(LZ4Level.L00_FAST)
        )
        self._hc = high_compression
        self._block_size = block_size
        self._pending = bytearray()
        self._closed = False

    def _write_chunks(self, raw: bytes):
        """``raw`` as chunks of block_size, the last one shorter, encoded
        in one launch."""
        bs = self._block_size
        comps = encode_blocks(upload(raw, self._dev), bs, self._level,
                              device=self._dev)
        for i, comp in enumerate(comps):
            chunk = raw[i * bs:(i + 1) * bs]
            compressed = len(comp) < len(chunk)
            flags = (_FLAG_COMPRESSED if compressed else 0) | (
                _FLAG_HC if self._hc else 0
            )
            _write_varint(self._sink, flags)
            _write_varint(self._sink, len(chunk))
            if compressed:
                _write_varint(self._sink, len(comp))
                self._sink.write(comp)
            else:
                self._sink.write(chunk)

    def write(self, data) -> int:
        if self._closed:
            raise ValueError("writer is closed")
        data = _as_bytes(data)
        self._pending += data
        k = len(self._pending) // self._block_size * self._block_size
        if k:
            chunks = bytes(self._pending[:k])
            del self._pending[:k]
            self._write_chunks(chunks)
        return len(data)

    def _write_pending(self):
        if self._pending:
            chunk = bytes(self._pending)
            self._pending.clear()
            self._write_chunks(chunk)

    def flush(self):
        self._write_pending()
        if hasattr(self._sink, "flush"):
            self._sink.flush()

    def close(self):
        if self._closed:
            return
        self._write_pending()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class LegacyStreamReader:
    """Chunked lz4net-format decompressor over a ``read(n)`` source."""

    def __init__(self, source, device="cuda"):
        self._dev = resolve_device(device)
        self._source = source
        self._buffer = bytearray()
        self._eof = False

    def _read_exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = self._source.read(n - len(out))
            if not chunk:
                break
            out += chunk
        return bytes(out)

    def _next_chunk(self) -> bool:
        if self._eof:
            return False
        flags = _read_varint(self._source.read)
        if flags is None:
            self._eof = True
            return False
        if flags & _FLAG_PASSES:
            raise LZ4Error("multi-pass legacy chunks are not supported")
        compressed = bool(flags & _FLAG_COMPRESSED)
        original = _read_varint(self._source.read)
        if original is None:
            raise LZ4Error("truncated legacy chunk header")
        stored = (
            _read_varint(self._source.read) if compressed else original
        )
        if stored is None:
            raise LZ4Error("truncated legacy chunk header")
        if stored > original:
            raise LZ4Error("corrupted legacy chunk (stored > original)")
        # allocation bounds: LZ4 expands less than 256x, so a compressed
        # chunk claiming more is corrupt, and no chunk may demand a
        # multi-GB buffer from a 12-byte header
        if compressed and original > stored * 255 + 64:
            raise LZ4Error(
                "corrupted legacy chunk (impossible expansion ratio)"
            )
        if original > (1 << 30) or stored > (1 << 30):
            raise LZ4Error("legacy chunk exceeds the 1 GiB sanity bound")
        payload = self._read_exact(stored)
        if len(payload) < stored:
            raise LZ4Error("truncated legacy chunk payload")
        if compressed:
            raw = block_api.decode(payload, target_length=original,
                                   device=self._dev)
        else:
            raw = payload
        self._buffer += raw
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            while self._next_chunk():
                pass
            out = bytes(self._buffer)
            self._buffer.clear()
            return out
        while len(self._buffer) < n and self._next_chunk():
            pass
        out = bytes(self._buffer[:n])
        del self._buffer[:n]
        return out

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def encode(data, high_compression: bool = False,
           block_size: int = 1024 * 1024, device="cuda") -> bytes:
    """One-shot legacy-stream compression (reference `LZ4Legacy.Encode`)."""
    sink = io.BytesIO()
    w = LegacyStreamWriter(sink, high_compression, block_size, device)
    w.write(_as_bytes(data))
    w.close()
    return sink.getvalue()


def decode(data, device="cuda") -> bytes:
    """One-shot legacy-stream decompression (reference `LZ4Legacy.Decode`)."""
    r = LegacyStreamReader(io.BytesIO(_as_bytes(data)), device)
    return r.read()
