"""lz4net "wrap" blob format: an 8-byte header [u32 originalLength][u32
storedLength], then the payload, stored when compression does not help.
The port of `lz4_tpu/legacy/wrapper.py`, its block on the card."""

from __future__ import annotations

import struct

from ..block import LZ4Error
from ..block import api as block_api
from ..constants import LZ4Level, _as_bytes
from ..ops.common import resolve_device

__all__ = ["wrap", "wrap_hc", "unwrap"]

_HEADER = 8


def _wrap(data: bytes, level: int, device) -> bytes:
    dev = resolve_device(device)
    n = len(data)
    if n == 0:
        return bytes(_HEADER)
    comp = block_api.encode(data, level=level, device=dev)
    if len(comp) >= n:
        return struct.pack("<II", n, n) + data
    return struct.pack("<II", n, len(comp)) + comp


def wrap(data, device="cuda") -> bytes:
    """Compress and wrap (reference `LZ4Legacy.Wrap`)."""
    return _wrap(_as_bytes(data), int(LZ4Level.L00_FAST), device)


def wrap_hc(data, device="cuda") -> bytes:
    """High-compression wrap (reference `LZ4Legacy.WrapHC`), level 9."""
    return _wrap(_as_bytes(data), int(LZ4Level.L09_HC), device)


def unwrap(data, device="cuda") -> bytes:
    """Unwrap and decompress (reference `LZ4Legacy.Unwrap`)."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    if len(data) < _HEADER:
        raise LZ4Error("wrapped blob too short")
    original, stored = struct.unpack_from("<II", data, 0)
    payload = data[_HEADER : _HEADER + stored]
    if len(payload) < stored:
        raise LZ4Error("wrapped blob truncated")
    if stored >= original:
        # any stored >= original was stored verbatim: tolerant producers
        # may write stored > original
        return payload
    return block_api.decode(payload, target_length=original, device=dev)
