"""lz4net-compatible legacy formats: the port of `lz4_tpu/legacy/` (the
reference's `K4os.Compression.LZ4.Legacy`): the varint-chunk stream format
and the 8-byte-header "wrap" blob format, over the port's block codec."""

from .stream import LegacyStreamReader, LegacyStreamWriter, decode, encode  # noqa: F401
from .wrapper import unwrap, wrap, wrap_hc  # noqa: F401
