"""Shared helpers for the port's kernel wrappers.

`round_up`, `align1024`, `bucket` and `LEVEL_ATTEMPTS` are the port's own
copies of `lz4_tpu/ops/common.py`; `resolve_device` is the port's device
rule for every public entry point.
"""

from __future__ import annotations

import torch


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
