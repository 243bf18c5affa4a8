"""LZ4 frame format (`.lz4`): one-shot compress and decompress of
chained and independent frames, with the descriptor, settings and header
codec."""

from .api import compress, decompress  # noqa: F401
from .descriptor import (  # noqa: F401
    DecoderSettings,
    EncoderSettings,
    FrameDescriptor,
)
from .header import LZ4FormatError, build_header, parse_header  # noqa: F401
