"""xxHash32 — streaming and one-shot, host (numpy) implementation.

The LZ4 frame format needs xxHash32 for the header checksum (HC byte), the
optional per-block checksums and the optional content checksum.  A
clean-room implementation of the public xxHash32 specification; the port's
own copy of `lz4_tpu/xxh32.py` without the native hot path.
"""

from __future__ import annotations

import numpy as np

PRIME1 = 2654435761
PRIME2 = 2246822519
PRIME3 = 3266489917
PRIME4 = 668265263
PRIME5 = 374761393

_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * PRIME2) & _M32
    acc = _rotl(acc, 13)
    return (acc * PRIME1) & _M32


def _avalanche(acc: int) -> int:
    acc ^= acc >> 15
    acc = (acc * PRIME2) & _M32
    acc ^= acc >> 13
    acc = (acc * PRIME3) & _M32
    acc ^= acc >> 16
    return acc


class XXH32:
    """Streaming xxHash32 (reset / update / digest)."""

    __slots__ = ("_seed", "_acc", "_buf", "_total")

    def __init__(self, seed: int = 0):
        self._seed = seed & _M32
        self.reset()

    def reset(self, seed: int | None = None) -> "XXH32":
        if seed is not None:
            self._seed = seed & _M32
        s = self._seed
        self._acc = [
            (s + PRIME1 + PRIME2) & _M32,
            (s + PRIME2) & _M32,
            s,
            (s - PRIME1) & _M32,
        ]
        self._buf = b""
        self._total = 0
        return self

    def update(self, data) -> "XXH32":
        if type(data) is not bytes:
            data = bytes(memoryview(data).cast("B"))
        self._total += len(data)
        if self._buf:  # usually empty: skip a full-payload copy per update
            data = self._buf + data
        n_stripes = len(data) // 16
        if n_stripes:
            body = np.frombuffer(
                data[: n_stripes * 16], dtype="<u4"
            ).reshape(n_stripes, 4)
            a0, a1, a2, a3 = self._acc
            for k in range(n_stripes):
                a0 = _round(a0, int(body[k, 0]))
                a1 = _round(a1, int(body[k, 1]))
                a2 = _round(a2, int(body[k, 2]))
                a3 = _round(a3, int(body[k, 3]))
            self._acc = [a0, a1, a2, a3]
        self._buf = data[n_stripes * 16 :]
        return self

    def digest(self) -> int:
        if self._total >= 16:
            a0, a1, a2, a3 = self._acc
            acc = (_rotl(a0, 1) + _rotl(a1, 7) + _rotl(a2, 12) + _rotl(a3, 18)) & _M32
        else:
            acc = (self._seed + PRIME5) & _M32
        acc = (acc + self._total) & _M32
        buf = self._buf
        i = 0
        while i + 4 <= len(buf):
            lane = int.from_bytes(buf[i : i + 4], "little")
            acc = (acc + lane * PRIME3) & _M32
            acc = (_rotl(acc, 17) * PRIME4) & _M32
            i += 4
        while i < len(buf):
            acc = (acc + buf[i] * PRIME5) & _M32
            acc = (_rotl(acc, 11) * PRIME1) & _M32
            i += 1
        return _avalanche(acc)


def xxh32(data, seed: int = 0) -> int:
    """One-shot xxHash32."""
    if type(data) is not bytes:
        data = bytes(memoryview(data).cast("B"))
    n = len(data)
    if n >= 16:
        n_stripes = n // 16
        body = np.frombuffer(data[: n_stripes * 16], dtype="<u4").reshape(n_stripes, 4)
        accs = np.array(
            [
                (seed + PRIME1 + PRIME2) & _M32,
                (seed + PRIME2) & _M32,
                seed & _M32,
                (seed - PRIME1) & _M32,
            ],
            dtype=np.uint64,
        )
        p1 = np.uint64(PRIME1)
        p2 = np.uint64(PRIME2)
        m32 = np.uint64(_M32)
        for k in range(n_stripes):
            accs = (accs + body[k].astype(np.uint64) * p2) & m32
            accs = ((accs << np.uint64(13)) | (accs >> np.uint64(19))) & m32
            accs = (accs * p1) & m32
        a0, a1, a2, a3 = (int(x) for x in accs)
        acc = (_rotl(a0, 1) + _rotl(a1, 7) + _rotl(a2, 12) + _rotl(a3, 18)) & _M32
        tail = data[n_stripes * 16 :]
    else:
        acc = (seed + PRIME5) & _M32
        tail = data
    acc = (acc + n) & _M32
    i = 0
    while i + 4 <= len(tail):
        lane = int.from_bytes(tail[i : i + 4], "little")
        acc = (acc + lane * PRIME3) & _M32
        acc = (_rotl(acc, 17) * PRIME4) & _M32
        i += 4
    while i < len(tail):
        acc = (acc + tail[i] * PRIME5) & _M32
        acc = (_rotl(acc, 11) * PRIME1) & _M32
        i += 1
    return _avalanche(acc)
