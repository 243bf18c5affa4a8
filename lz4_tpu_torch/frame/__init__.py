"""LZ4 frame format (`.lz4`): one-shot compress and decompress, the
streaming reader and writer, the file-like stream and the buffer-target
facades, with the descriptor, settings and header codec."""

from .api import (  # noqa: F401
    LZ4FrameFile,
    compress,
    compress_into,
    decompress,
    decompress_into,
    open,
    skippable_frame,
)
from .descriptor import (  # noqa: F401
    DecoderSettings,
    EncoderSettings,
    FrameDescriptor,
)
from .header import LZ4FormatError, build_header, parse_header  # noqa: F401
from .reader import FrameReader  # noqa: F401
from .writer import FrameWriter  # noqa: F401
