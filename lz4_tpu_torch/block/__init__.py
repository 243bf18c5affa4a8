"""Block-level names of the port: the error class, one-block
`encode`/`decode` on a device with preset dictionaries, the buffer-target
forms, `partial_decode`, and the incremental encoders and decoders."""


class LZ4Error(ValueError):
    """Malformed LZ4 data."""


from .api import (  # noqa: E402  (api imports LZ4Error)
    compress_bound,
    decode,
    decode_into,
    encode,
    encode_into,
    maximum_output_size,
    partial_decode,
)

__all__ = [
    "LZ4Error",
    "compress_bound",
    "maximum_output_size",
    "encode",
    "decode",
    "encode_into",
    "decode_into",
    "partial_decode",
]
