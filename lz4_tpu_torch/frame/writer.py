"""LZ4 frame writer: the port of `lz4_tpu/frame/writer.py`.

Writes the frame that `lz4_tpu.frame.FrameWriter` writes for the same
sequence of writes (header, blocks stored when compression does not help,
optional block checksums, EndMark, optional content checksum).  Each
`write()` goes to the device once.  The whole blocks it completes are
encoded in one launch: independent blocks through
`parallel.encode_blocks`, chained blocks through kernel D's windows, each
with the 64 KB of plaintext before it, the first one reaching the carried
64 KB tail of earlier writes or the preset dictionary.  Block checksums
come from kernel E over the compressed rows, and the content hash from its
streaming form (`XXH32.update` on the device tensor), so the host only
frames the blocks.
"""

from __future__ import annotations

import struct

import torch

from ..block.incremental import check_geometry
from ..ops.common import resolve_device
from ..parallel.blocks import encode_blocks, encode_blocks_chained_device, upload
from ..xxh32 import XXH32
from .descriptor import EncoderSettings
from .header import build_header

__all__ = ["FrameWriter"]

_UNCOMPRESSED_FLAG = 0x80000000
_END_MARK = b"\x00\x00\x00\x00"
_WINDOW = 65536


class FrameWriter:
    """Streaming LZ4 frame compressor over a ``write(bytes)`` sink, on
    ``device`` (the plain versions when ``device="cpu"``)."""

    def __init__(
        self,
        sink,
        settings: EncoderSettings | None = None,
        device="cuda",
        dictionary: bytes = b"",
    ):
        self._dev = resolve_device(device)
        self._sink = sink
        self._settings = settings or EncoderSettings()
        self._descriptor = self._settings.to_descriptor()
        self._block_size = self._descriptor.block_size
        self._level = int(self._settings.compression_level)
        chained = self._descriptor.block_chaining
        check_geometry(chained, self._level, self._settings.geometry)
        self._geometry = "dense" if self._settings.geometry == "dense" else "canonical"
        if dictionary and not chained:
            raise ValueError(
                "preset dictionaries require chained (dependent) blocks"
            )
        # the history the next chained block reaches: the last 64 KB of
        # what was framed, at first the preset dictionary
        self._tail = upload(bytes(dictionary[-_WINDOW:]), self._dev)
        self._pending = upload(b"", self._dev)  # not framed yet
        self._content_hash = XXH32() if self._descriptor.content_checksum else None
        # extra_memory buys extra buffered blocks, encoded in the same
        # launch (independent blocks only, as in the JAX package)
        self._extra_blocks = (
            0 if chained else self._settings.extra_memory // self._block_size
        )
        self._header_written = False
        self._closed = False
        self._bytes_written = 0
        self._content_bytes = 0

    # -- plumbing -----------------------------------------------------------

    def _emit(self, data: bytes):
        self._sink.write(data)
        self._bytes_written += len(data)

    def _ensure_header(self):
        if not self._header_written:
            self._emit(build_header(self._descriptor))
            self._header_written = True

    @property
    def bytes_written(self) -> int:
        """Compressed bytes emitted so far."""
        return self._bytes_written

    # -- block loop ---------------------------------------------------------

    def _write_blocks(self, content: torch.Tensor):
        """Frame ``content`` (on the device) as blocks of block_size, the
        last one shorter, all encoded in one launch."""
        self._ensure_header()
        d, bs = self._descriptor, self._block_size
        if d.block_chaining:
            comps = encode_blocks_chained_device(
                content, bs, self._level, device=self._dev,
                checksums=d.block_checksum, prefix=self._tail)
            keep = min(max(_WINDOW - content.numel(), 0), self._tail.numel())
            self._tail = torch.cat([self._tail[self._tail.numel() - keep:],
                                    content[-_WINDOW:]])
        else:
            comps = encode_blocks(content, bs, self._level,
                                  geometry=self._geometry, device=self._dev,
                                  checksums=d.block_checksum)
        sums = None
        if d.block_checksum:
            comps, sums = comps
        n = content.numel()
        for i, comp in enumerate(comps):
            raw_len = min(bs, n - i * bs)
            if len(comp) >= raw_len:  # stored: the upstream rule
                self._emit(struct.pack("<I", raw_len | _UNCOMPRESSED_FLAG))
                self._emit(content[i * bs:i * bs + raw_len].cpu().numpy().tobytes())
            else:
                self._emit(struct.pack("<I", len(comp)))
                self._emit(comp)
            if d.block_checksum:
                self._emit(struct.pack("<I", sums[i]))

    def write(self, data) -> int:
        if self._closed:
            raise ValueError("writer is closed")
        chunk = upload(data, self._dev)
        if self._content_hash is not None:
            self._content_hash.update(chunk)
        self._content_bytes += chunk.numel()
        self._pending = torch.cat([self._pending, chunk])
        bs = self._block_size
        if self._pending.numel() >= bs * (1 + self._extra_blocks):
            k = self._pending.numel() // bs * bs
            self._write_blocks(self._pending[:k])
            self._pending = self._pending[k:].clone()
        return chunk.numel()

    @property
    def closed(self) -> bool:
        return self._closed

    def _flush_pending(self):
        if self._pending.numel():
            self._write_blocks(self._pending)
            self._pending = self._pending[:0]

    def flush(self):
        """Frame any buffered partial block as a (short) block, legal in
        the frame format."""
        if self._closed:
            return
        self._flush_pending()
        if hasattr(self._sink, "flush"):
            self._sink.flush()

    def close(self):
        """Finalize the frame: flush, EndMark, optional content checksum."""
        if self._closed:
            return
        self._flush_pending()
        self._ensure_header()  # zero-length content still emits a valid frame
        declared = self._descriptor.content_length
        if declared is not None and self._content_bytes != declared:
            raise ValueError(
                f"content length mismatch: declared {declared}, "
                f"wrote {self._content_bytes}"
            )
        self._emit(_END_MARK)
        if self._content_hash is not None:
            self._emit(struct.pack("<I", self._content_hash.digest()))
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
