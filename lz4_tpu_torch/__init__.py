"""lz4_tpu_torch — the PyTorch / CUDA port of `lz4_tpu` for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports `torch`, never
`jax`, and nothing of `lz4_tpu`.  Each Pallas kernel of the reference
becomes a CUDA kernel written by hand for `sm_90a` (`ops/csrc/`), with a
plain PyTorch version beside it that the CPU runs.  Entry points run on
the card unless the caller passes ``device="cpu"``.

Layer map:
- `lz4_tpu_torch.constants` — format constants
- `lz4_tpu_torch.xxh32`     — xxHash32, streaming (a tensor's stripes on
  kernel E's streaming form) and one-shot
- `lz4_tpu_torch.ops`       — kernels A (decode, with an output limit for
  partial decodes), B (encode <= 64 KB) and D (encode at any size, with
  dictionaries), each with its FAST (levels 0-2), HC (3-9) and OPT (10-12)
  arms, the chained decoder, and kernel E (xxHash32 of byte windows, and
  its streaming form)
- `lz4_tpu_torch.ops`       — also the dense codecs X1-X3 (the JAX
  package's XLA encoder, decoder and chain), as PyTorch tensor ops
- `lz4_tpu_torch.parallel`  — batched encode/decode, chained encode, the
  dense codecs' batches and meshes (`mesh=`), multi-process frames
  (`parallel.multihost`, torch.distributed over gloo)
- `lz4_tpu_torch.block`     — one-block codec, buffer targets, partial
  decode, incremental encoders and decoders
- `lz4_tpu_torch.pickler`   — self-contained compressed blobs
- `lz4_tpu_torch.frame`     — the frame format: one-shot, streaming
  reader and writer, file-like streams, async facades
- `lz4_tpu_torch.legacy`    — lz4net-compatible stream and wrap formats
- `lz4_tpu_torch.cli`       — `python -m lz4_tpu_torch`
"""

from .block import LZ4Error
from .block.api import (decode, decode_into, encode, encode_into,
                        maximum_output_size, partial_decode)
from .constants import LZ4Level, compress_bound
from .pickler import pickle, pickle_into, unpickle, unpickle_into
from .pickler import unpickled_size
from .xxh32 import XXH32, xxh32

__version__ = "0.5.0"

__all__ = [
    "LZ4Level",
    "LZ4Error",
    "compress_bound",
    "maximum_output_size",
    "encode",
    "decode",
    "encode_into",
    "decode_into",
    "partial_decode",
    "pickle",
    "pickle_into",
    "unpickle",
    "unpickle_into",
    "unpickled_size",
    "XXH32",
    "xxh32",
]
