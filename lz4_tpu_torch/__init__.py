"""lz4_tpu_torch — the PyTorch / CUDA port of `lz4_tpu` for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports `torch`, never
`jax`, and nothing of `lz4_tpu`.  Each Pallas kernel of the reference
becomes a CUDA kernel written by hand for `sm_90a` (`ops/csrc/`), with a
plain PyTorch version beside it that the CPU runs.  Entry points run on
the card unless the caller passes ``device="cpu"``.

Layer map (the slice ported so far):
- `lz4_tpu_torch.constants` — format constants
- `lz4_tpu_torch.xxh32`     — xxHash32 on the host (the frame descriptor's
  checksum byte)
- `lz4_tpu_torch.ops`       — kernels A (decode), B (encode <= 64 KB) and D
  (encode at any size, with dictionaries), each with its FAST (levels 0-2),
  HC (3-9) and OPT (10-12) arms, the chained decoder, and kernel E
  (xxHash32 of byte windows: every block and content checksum)
- `lz4_tpu_torch.parallel`  — batched encode/decode, chained encode
- `lz4_tpu_torch.block`     — one-block encode/decode with dictionaries
- `lz4_tpu_torch.frame`     — one-shot frame compress/decompress
"""

from .block import LZ4Error
from .constants import LZ4Level, compress_bound
from .xxh32 import XXH32, xxh32

__version__ = "0.4.0"

__all__ = [
    "LZ4Level",
    "LZ4Error",
    "compress_bound",
    "XXH32",
    "xxh32",
]
