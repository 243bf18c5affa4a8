"""Pickler: self-contained one-shot compressed blobs, the port of
`lz4_tpu/pickler.py` over the port's `block.encode`/`decode`, with the
same blobs.

Wire format (the reference's `LZ4Pickler` V0):
- header byte: bits 0-2 the version (0), bits 6-7 the code of the width
  of the size-difference field (0, 1, 2 bytes, or code 3 for 4 bytes);
- compressed: ``diff = original_length - compressed_length``, little
  endian in that many bytes, then the LZ4 block;
- incompressible: one zero header byte, then the raw bytes.
"""

from __future__ import annotations

from .block import api as block_api
from .constants import _as_bytes
from .ops.common import resolve_device

__all__ = [
    "pickle", "pickle_into", "unpickle", "unpickle_into",
    "unpickled_size", "PickleError",
]


class PickleError(ValueError):
    """Malformed pickle blob."""


def _size_width(value: int) -> int:
    if value < 0 or value > 0xFFFF:
        return 4
    if value > 0xFF:
        return 2
    return 1


_WIDTH_TO_CODE = {0: 0, 1: 1, 2: 2, 4: 3}
_CODE_TO_WIDTH = {0: 0, 1: 1, 2: 2, 3: 4}


def pickle(data, level: int = 0, device="cuda") -> bytes:
    """Compress ``data`` into a self-describing blob, its block encoded on
    ``device`` (the plain versions when ``device="cpu"``)."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    if not data:
        return b""
    comp = block_api.encode(data, level=level, device=dev)
    if len(comp) >= len(data):
        return b"\x00" + data
    diff = len(data) - len(comp)
    width = _size_width(diff)
    header = bytes([(_WIDTH_TO_CODE[width] & 0x3) << 6])
    return header + diff.to_bytes(width, "little") + comp


def pickle_into(data, dest, level: int = 0, device="cuda") -> int:
    """Pickle ``data`` into the writable buffer ``dest``: returns the blob's
    length, or minus it when ``dest`` is too small."""
    view = memoryview(dest).cast("B")
    blob = pickle(data, level=level, device=device)
    if len(blob) > len(view):
        return -len(blob)
    view[: len(blob)] = blob
    return len(blob)


def _decode_header(blob: bytes) -> tuple[int, int, int]:
    """Returns (data_offset, data_length, result_length)."""
    if not blob:
        raise PickleError("empty pickle")
    b0 = blob[0]
    version = b0 & 0x07
    if version != 0:
        raise PickleError(f"unsupported pickle version {version}")
    width = _CODE_TO_WIDTH[(b0 >> 6) & 0x3]
    if len(blob) < 1 + width:
        raise PickleError("truncated pickle header")
    diff = int.from_bytes(blob[1 : 1 + width], "little") if width else 0
    data_offset = 1 + width
    data_length = len(blob) - data_offset
    return data_offset, data_length, data_length + diff


def unpickled_size(blob) -> int:
    """The decoded size, without decompressing."""
    blob = _as_bytes(blob)
    if not blob:
        return 0
    return _decode_header(blob)[2]


def _decode(payload: bytes, dev, **bound) -> bytes:
    """The block, decoded on ``dev``; a corrupt one raises PickleError."""
    try:
        return block_api.decode(payload, device=dev, **bound)
    except ValueError as e:  # LZ4Error, or a bound the block does not fit
        raise PickleError(f"corrupted pickle payload: {e}") from e


def unpickle(blob, device="cuda") -> bytes:
    """Decompress a pickled blob on ``device``."""
    dev = resolve_device(device)
    blob = _as_bytes(blob)
    if not blob:
        return b""
    off, dlen, rlen = _decode_header(blob)
    payload = blob[off:]
    if rlen == dlen:  # stored
        return payload
    out = _decode(payload, dev, target_length=rlen)
    if len(out) != rlen:
        raise PickleError(f"unpickled size {len(out)} != expected {rlen}")
    return out


def unpickle_into(blob, dest, device="cuda") -> int:
    """Unpickle into the writable buffer ``dest``, which needs room for the
    decoded size (`unpickled_size`): returns the decoded length."""
    dev = resolve_device(device)
    view = memoryview(dest).cast("B")
    blob = _as_bytes(blob)
    if not blob:
        return 0
    off, dlen, rlen = _decode_header(blob)
    if rlen > len(view):
        raise PickleError(
            f"unpickled size {rlen} exceeds destination {len(view)}"
        )
    payload = blob[off:]
    if rlen == dlen:  # stored
        view[:rlen] = payload
        return rlen
    out = _decode(payload, dev, capacity=rlen)
    if len(out) != rlen:
        raise PickleError(f"unpickled size {len(out)} != expected {rlen}")
    view[:rlen] = out
    return rlen
