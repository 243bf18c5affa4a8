"""xxHash32 — streaming and one-shot.

The LZ4 frame format needs xxHash32 for the header checksum (HC byte), the
optional per-block checksums and the optional content checksum.  A
clean-room implementation of the public xxHash32 specification; the port's
own copy of `lz4_tpu/xxh32.py` without the native hot path.  `XXH32.update`
on a tensor runs the stripes through kernel E's streaming form
(`ops.xxh32.stripes_update`: on the card's side stream for a CUDA tensor,
the state kept there, its plain version for a CPU one); on bytes it runs
them here, in `host_stripes`
(counted in `host_stripes.launches`, so that a run can show that a card
path never took it).
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
        """Add ``data``: bytes-like, or a 1-D uint8 tensor.  A tensor goes
        through `ops.xxh32.stripes_update`, the accumulators and the bytes
        after the last whole stripe kept as tensors on its device: a CUDA
        tensor launches kernel E's streaming form on the device's side
        stream and reads nothing back (the state is read once, by
        `digest` or by a bytes update that follows)."""
        if hasattr(data, "data_ptr"):  # a tensor
            return self._update_tensor(data)
        self._on_host()
        if type(data) is not bytes:
            data = bytes(memoryview(data).cast("B"))
        self._total += len(data)
        if self._buf:  # usually empty: skip a full-payload copy per update
            data = self._buf + data
        n_stripes = len(data) // 16
        if n_stripes:
            self._acc = host_stripes(self._acc, data, n_stripes)
        self._buf = data[n_stripes * 16 :]
        return self

    def _update_tensor(self, flat) -> "XXH32":
        import torch

        from .ops.xxh32 import stripes_state, stripes_update

        if flat.dtype != torch.uint8 or flat.dim() != 1:
            raise ValueError("a tensor must be 1-D uint8")
        if not isinstance(self._acc, list) and self._acc.device != flat.device:
            self._on_host()
        if isinstance(self._acc, list):
            self._acc, self._buf = stripes_state(self._acc, self._buf, flat.device)
        self._total += flat.numel()
        self._acc, self._buf = stripes_update(self._acc, self._buf, flat)
        return self

    def _on_host(self) -> None:
        """The state as Python ints and bytes, read back from its device if
        a tensor update left it there."""
        if not isinstance(self._acc, list):
            from .ops.xxh32 import stripes_read

            self._acc, self._buf = stripes_read(self._acc, self._buf)

    def digest(self) -> int:
        self._on_host()
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


def host_stripes(accs, data: bytes, n_stripes: int) -> list[int]:
    """The four accumulators after the first ``n_stripes`` 16-byte stripes
    of ``data``, on the host: the plain stripe loop."""
    host_stripes.launches += 1
    body = np.frombuffer(data[: n_stripes * 16], dtype="<u4").tolist()
    a0, a1, a2, a3 = accs
    it = iter(body)
    for w0, w1, w2, w3 in zip(it, it, it, it):
        a0 = _round(a0, w0)
        a1 = _round(a1, w1)
        a2 = _round(a2, w2)
        a3 = _round(a3, w3)
    return [a0, a1, a2, a3]


host_stripes.launches = 0


def xxh32(data, seed: int = 0) -> int:
    """One-shot xxHash32 (of a CUDA tensor on the card)."""
    return XXH32(seed).update(data).digest()
