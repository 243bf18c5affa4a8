"""Shared helpers for the port's kernel wrappers.

`round_up`, `align1024`, `bucket` and `LEVEL_ATTEMPTS` are the port's own
copies of `lz4_tpu/ops/common.py`, and `ceil_log2`, `shift_left`,
`word_le`, `gather`, `reverse_cummin`, `next_not_equal` and
`exclusive_cumsum` its dense helpers, each working row by row on a leading
batch dimension ([B, N]) for the dense tensor-op codecs (`chain.py`,
`decode_dense.py`, `encode_dense.py`); `resolve_device` is the port's
device rule for every public entry point; `read32`, `run_length` and
`emit` are the plain encoders' primitives.
"""

from __future__ import annotations

import math

import torch


def ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(2, n))))


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def align1024(x: int) -> int:
    """Round an extent up to a multiple of 1024.

    Kept for the buffer widths the JAX package's wrappers return (its TPU
    code generation wanted 1024-aligned extents), so that the two packages'
    outputs have the same shapes."""
    return round_up(x, 1024)


# LZ4Level -> hash-chain search depth (maxNbAttempts); levels 0-2 are the
# FAST arm (depth 0).  L10+ (optimal parse) route via the opt parameters.
LEVEL_ATTEMPTS = {
    0: 0, 1: 0, 2: 0,
    3: 4, 4: 8, 5: 16, 6: 32, 7: 64, 8: 128, 9: 256,
}


def shift_left(b: torch.Tensor, k: int) -> torch.Tensor:
    """b[..., i + k] with zero fill past the end of each row."""
    if k == 0:
        return b
    return torch.cat([b[..., k:], b.new_zeros(b.shape[:-1] + (k,))], dim=-1)


def word_le(b: torch.Tensor) -> torch.Tensor:
    """w[..., i] = the 4-byte little-endian word starting at i, as int32
    (zero fill past the end; bytes at i + 3 >= 128 wrap it negative, as in
    the JAX package: only equality and grouping read it)."""
    return (
        b
        | (shift_left(b, 1) << 8)
        | (shift_left(b, 2) << 16)
        | (shift_left(b, 3) << 24)
    )


def gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[b, idx[b, j]] with each index clamped to its row's length (JAX
    indexing clamps; torch would raise or assert)."""
    n = arr.shape[-1]
    if idx.shape[:-1] != arr.shape[:-1]:
        idx = idx.expand(arr.shape[:-1] + idx.shape[-1:])
    return torch.gather(arr, -1, idx.clamp(0, n - 1).long())


def reverse_cummin(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative minimum along the last axis."""
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def next_not_equal(flag_neq: torch.Tensor, idx: torch.Tensor,
                   sentinel: int) -> torch.Tensor:
    """For each i, the smallest j >= i with flag_neq[..., j] True (else
    sentinel): one reverse cumulative minimum over masked indices."""
    return reverse_cummin(torch.where(flag_neq, idx, sentinel))


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, in int32 as JAX's."""
    return torch.cumsum(x, dim=-1, dtype=torch.int32) - x


def read32(s, p: int) -> int:
    """Little-endian 32-bit word of s at p."""
    return s[p] | (s[p + 1] << 8) | (s[p + 2] << 16) | (s[p + 3] << 24)


def run_length(s, a: int, b: int, limit: int) -> int:
    """Common run of s[a..] and s[b..], clipped at limit - b."""
    k = 0
    while b + k < limit and s[a + k] == s[b + k]:
        k += 1
    return k


def emit(out: bytearray, s, anchor: int, ll: int, off: int, ml: int):
    """The plain encoders' sequence writer: literals s[anchor, anchor + ll),
    then a match of ``ml`` bytes at offset ``off`` (ml == 0: the final
    literals, no match)."""
    mlc = ml - 4 if ml else 0
    out.append((min(ll, 15) << 4) | min(mlc, 15))
    if ll >= 15:
        v = ll - 15
        out += b"\xff" * (v // 255)
        out.append(v % 255)
    out += s[anchor:anchor + ll]
    if ml:
        out.append(off & 0xFF)
        out.append(off >> 8)
        if mlc >= 15:
            v = mlc - 15
            out += b"\xff" * (v // 255)
            out.append(v % 255)


def bucket(n: int, floor: int = 1 << 12) -> int:
    """Round ``n`` up to a power of two (>= ``floor``)."""
    cap = floor
    while cap < n:
        cap <<= 1
    return cap


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  A CUDA request without a card raises; it never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
