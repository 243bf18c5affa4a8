from .blocks import (  # noqa: F401
    decode_blocks,
    encode_blocks,
    split_blocks,
)
