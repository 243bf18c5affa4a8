"""LZ4 format constants.

Numerology mirrors the canonical LZ4 block format (lz4 v1.9.2) as re-exposed by
the reference implementation (see reference `Engine/LL.types.cs:14-27` and
`Engine/LL.tools.cs:39-40` for the same values).  These are *format* constants,
not implementation details, so they must match bit-for-bit.
"""

from __future__ import annotations

import enum

MIN_MATCH = 4  # minimum match length
LAST_LITERALS = 5  # last 5 bytes of a block are always literals
MF_LIMIT = 12  # a match must not start within the last 12 bytes
DISTANCE_MAX = 65535  # maximum match offset (16-bit, 0 is invalid)
ML_BITS = 4
ML_MASK = (1 << ML_BITS) - 1  # 15
RUN_BITS = 8 - ML_BITS
RUN_MASK = (1 << RUN_BITS) - 1  # 15

MAX_INPUT_SIZE = 0x7E000000  # 2 113 929 216 bytes

# LZ4 frame format
FRAME_MAGIC = 0x184D2204
SKIPPABLE_MAGIC_MIN = 0x184D2A50
SKIPPABLE_MAGIC_MAX = 0x184D2A5F
FRAME_VERSION = 1

# legacy frame (lz4 CLI v1.x "legacy" format) magic, for completeness
LEGACY_FRAME_MAGIC = 0x184C2102


def compress_bound(input_size: int) -> int:
    """Maximum compressed size for ``input_size`` bytes of input.

    Same formula as the canonical ``LZ4_compressBound`` (reference
    `Engine/LL.tools.cs:39-40`): worst case is all-literals plus VLE and
    end-of-block overhead.
    """
    if input_size < 0 or input_size > MAX_INPUT_SIZE:
        return 0
    return input_size + input_size // 255 + 16


class LZ4Level(enum.IntEnum):
    """Compression levels, mirroring the reference `LZ4Level.cs:6-40`."""

    L00_FAST = 0
    L03_HC = 3
    L04_HC = 4
    L05_HC = 5
    L06_HC = 6
    L07_HC = 7
    L08_HC = 8
    L09_HC = 9
    L10_OPT = 10
    L11_OPT = 11
    L12_MAX = 12


# Hash-chain search depth per HC level, mirroring the canonical clTable
# (reference `x64/LL64.high.cs:1124-1138`): (nbSearches, targetLength) pairs;
# levels 10..12 use the optimal parser.
HC_LEVEL_TABLE = {
    3: (4, 0),
    4: (8, 0),
    5: (16, 0),
    6: (32, 0),
    7: (64, 0),
    8: (128, 0),
    9: (256, 0),
    10: (96, 64),
    11: (512, 128),
    12: (16384, 4096),
}

# Frame block-size codes (BD byte, bits 6-4): code -> max block size.
BLOCK_SIZE_CODES = {
    4: 64 * 1024,
    5: 256 * 1024,
    6: 1024 * 1024,
    7: 4 * 1024 * 1024,
}


def block_size_code(block_size: int) -> int:
    """Smallest frame block-size code whose limit is >= block_size."""
    for code in (4, 5, 6, 7):
        if block_size <= BLOCK_SIZE_CODES[code]:
            return code
    return 7


def _as_bytes(data) -> bytes:
    """bytes view of any 1-D bytes-like, without copying actual ``bytes``
    (a copy of a large payload would tax every one-shot facade call)."""
    if type(data) is bytes:
        return data
    return bytes(memoryview(data).cast("B"))
