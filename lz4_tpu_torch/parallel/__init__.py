from .blocks import (  # noqa: F401
    batched_decode,
    batched_encode,
    decode_blocks,
    encode_blocks,
    make_mesh,
    sharded_decode_fn,
    sharded_encode_fn,
    split_blocks,
    warmup_device,
)
