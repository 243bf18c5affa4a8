"""Frame descriptor and encoder/decoder settings.

Capability analog of the reference's `ILZ4Descriptor`/`LZ4Descriptor`
(`LZ4Descriptor.cs:8-59`), `LZ4EncoderSettings` (`LZ4EncoderSettings.cs:8-48`)
and `LZ4DecoderSettings`.  Unlike the reference (which throws
NotImplementedException for content-size-on-write and dictionary ID,
`Frames/LZ4FrameWriter.cs:89-95`), both are fully supported here.
"""

from __future__ import annotations

import dataclasses

from ..constants import BLOCK_SIZE_CODES, LZ4Level, block_size_code

__all__ = ["FrameDescriptor", "EncoderSettings", "DecoderSettings"]


@dataclasses.dataclass(frozen=True)
class FrameDescriptor:
    """Parsed/emitted LZ4 frame descriptor (FLG + BD + optional fields)."""

    content_length: int | None = None
    content_checksum: bool = False
    block_chaining: bool = True
    block_checksum: bool = False
    dictionary_id: int | None = None
    block_size: int = 65536

    @property
    def block_size_code(self) -> int:
        return block_size_code(self.block_size)

    @property
    def block_size_limit(self) -> int:
        return BLOCK_SIZE_CODES[self.block_size_code]


@dataclasses.dataclass
class EncoderSettings:
    """Frame compression settings (defaults mirror the reference's)."""

    content_length: int | None = None
    chain_blocks: bool = True
    block_size: int = 65536
    content_checksum: bool = False
    block_checksum: bool = False
    dictionary_id: int | None = None
    compression_level: int = int(LZ4Level.L00_FAST)
    extra_memory: int = 0
    # FAST-level match-finder schedule family:
    # - "auto" (default): independent blocks use the canonical schedule
    #   (byte-parity with upstream one-shot compression); chained frames
    #   use the dense family (parallel window encode, and the schedule the
    #   device chain kernels implement).
    # - "canonical": independent blocks as above; CHAINED frames use the
    #   canonical continue-schedule (byte-parity with upstream
    #   LZ4_compress_fast_continue / the lz4 frame API's linked blocks) —
    #   one-shot `frame.compress` only (the sequential stream state needs
    #   the whole buffer; the streaming FrameWriter raises).
    # - "dense": this library's 15-bit finder everywhere (~1-3% smaller,
    #   slower).
    geometry: str = "auto"

    def __post_init__(self):
        if self.geometry not in ("auto", "canonical", "dense"):
            raise ValueError(
                f"unknown FAST geometry {self.geometry!r}; "
                "expected 'auto', 'canonical' or 'dense'"
            )

    def to_descriptor(self) -> FrameDescriptor:
        return FrameDescriptor(
            content_length=self.content_length,
            content_checksum=self.content_checksum,
            block_chaining=self.chain_blocks,
            block_checksum=self.block_checksum,
            dictionary_id=self.dictionary_id,
            block_size=self.block_size,
        )


@dataclasses.dataclass
class DecoderSettings:
    extra_memory: int = 0
    dictionary: bytes = b""
