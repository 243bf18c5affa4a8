"""Block-parallel LZ4 over independent blocks, on one CUDA device.

The port of `lz4_tpu/parallel/blocks.py`'s batched path: a payload splits
into fixed-size independent blocks (frame descriptor
``block_independence=True``), one kernel launch encodes or decodes the
whole batch, and only the compressed lengths decide the frame layout on
the host.

The JAX package pads each batch to a power-of-two bucket to bound its
compiles, and routes dictionary batches to a streaming decoder to fit the
TPU's scalar memory; neither applies here: every call launches exactly B
rows, and dictionary rows run the same decode kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..block import LZ4Error
from ..constants import compress_bound
from ..ops import decode as _decode
from ..ops import encode as _encode
from ..ops.common import align1024, resolve_device

__all__ = [
    "comp_capacity",
    "split_blocks",
    "pack_blocks",
    "encode_blocks_device",
    "decode_blocks_device",
    "encode_blocks",
    "decode_blocks",
    "decode_block_parts",
]

# zero tail of every staged source row (the JAX package's `_PAD_TAIL`):
# kept so that both packages stage identical rows
_PAD_TAIL = 1024


def comp_capacity(block_size: int) -> int:
    """Aligned compressed-buffer width for decode inputs."""
    return align1024(compress_bound(block_size) + 8)


def split_blocks(data: bytes, block_size: int, pad_to: int | None = None):
    """Split ``data`` into fixed-capacity padded blocks.

    Returns (bufs uint8 [B, block_size + 1024], lens int32 [B]) on the CPU.
    If ``pad_to`` is given, B is rounded up to a multiple of it (extra
    blocks have length 0)."""
    n = len(data)
    nb = max(1, -(-n // block_size))
    if pad_to:
        nb = -(-nb // pad_to) * pad_to
    bufs = np.zeros((nb, block_size + _PAD_TAIL), np.uint8)
    lens = np.zeros((nb,), np.int32)
    view = np.frombuffer(data, np.uint8)
    full = n // block_size
    bufs[:full, :block_size] = view[: full * block_size].reshape(full, block_size)
    lens[:full] = block_size
    if n % block_size:
        bufs[full, : n - full * block_size] = view[full * block_size :]
        lens[full] = n - full * block_size
    return torch.from_numpy(bufs), torch.from_numpy(lens)


def pack_blocks(outs, out_lens) -> list[bytes]:
    """Variable-length compressed blocks back to host byte strings, in frame
    order."""
    outs = np.asarray(torch.as_tensor(outs).cpu())
    lens = torch.as_tensor(out_lens).tolist()
    return [outs[b, : lens[b]].tobytes() for b in range(outs.shape[0])]


def encode_blocks_device(bufs, lens, bcap: int, level: int = 0,
                         acceleration: int = 1, geometry: str = "canonical",
                         device="cuda"):
    """Encode a batch with kernel B on ``device`` (the plain version when
    ``device="cpu"``).

    Returns (out uint8 [B, OCAP], out_lens int32 [B]) on ``device``."""
    dev = resolve_device(device)
    out, out_lens, errs = _encode.encode_blocks(
        torch.as_tensor(bufs).to(dev), torch.as_tensor(lens).to(dev), bcap,
        int(level), acceleration, fast_schedule=geometry,
    )
    if bool(errs.any()):
        raise RuntimeError("encoder overflow")
    return out, out_lens


def decode_blocks_device(comps, clens, out_cap: int, dicts=None,
                         dict_lens=None, mode: str | None = None,
                         device="cuda"):
    """Decode a batch with kernel A on ``device`` (the plain version when
    ``device="cpu"``), optionally with per-row right-aligned 64 KB
    dictionaries (uint8 [B, 65536]) and their lengths.

    ``mode`` ("full", "full2", "full2v") is validated and otherwise
    changes nothing: kernel A has one fast path.  Returns
    (out uint8 [B, out_cap], lens int32 [B], errs int32 [B]) on ``device``.
    """
    dev = resolve_device(device)
    if dicts is not None:
        dicts = torch.as_tensor(dicts).to(dev)
        dict_lens = torch.as_tensor(dict_lens).to(dev)
    return _decode.decode_blocks(
        torch.as_tensor(comps).to(dev), torch.as_tensor(clens).to(dev),
        out_cap, dicts, dict_lens, mode=mode or "full2",
    )


def encode_blocks(
    data: bytes,
    block_size: int = 1 << 20,
    level: int = 0,
    mesh=None,
    geometry: str = "canonical",
    device="cuda",
) -> list[bytes]:
    """One-shot: split ``data`` into independent blocks, encode them in one
    batch on ``device``, return the compressed blocks in frame order."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: multi-GPU block sharding is not ported yet (ROADMAP.md "
            "Queue 1, multi-GPU mesh)"
        )
    dev = resolve_device(device)
    if not data:
        return []
    bufs, lens = split_blocks(data, block_size)
    outs, out_lens = encode_blocks_device(
        bufs, lens, block_size, level, geometry=geometry, device=dev
    )
    return pack_blocks(outs, out_lens)


def decode_block_parts(blocks: list[bytes], block_size: int,
                       device="cuda") -> list[np.ndarray]:
    """Decode independent compressed blocks in one batch on ``device``;
    returns each block's decoded bytes, in order.  Raises LZ4Error on the
    first malformed block."""
    dev = resolve_device(device)
    if not blocks:
        return []
    nb = len(blocks)
    comps = np.zeros((nb, comp_capacity(block_size)), np.uint8)
    clens = np.zeros((nb,), np.int32)
    for b, blk in enumerate(blocks):
        if len(blk) > comps.shape[1] - 20:
            raise LZ4Error(
                f"compressed block {b} of {len(blk)} bytes exceeds the "
                f"bound for {block_size}-byte blocks"
            )
        comps[b, : len(blk)] = np.frombuffer(blk, np.uint8)
        clens[b] = len(blk)
    outs, out_lens, errs = decode_blocks_device(
        torch.from_numpy(comps), torch.from_numpy(clens), block_size,
        device=dev,
    )
    errs = errs.cpu().numpy()
    if errs.any():
        bad = int(np.nonzero(errs)[0][0])
        raise LZ4Error(f"malformed LZ4 block {bad} (err={int(errs[bad])})")
    outs = outs.cpu().numpy()
    return [outs[b, :n] for b, n in enumerate(out_lens.tolist())]


def decode_blocks(
    blocks: list[bytes],
    block_size: int,
    total_length: int | None = None,
    mesh=None,
    device="cuda",
) -> bytes:
    """Decode independent compressed blocks in one batch and concatenate."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: multi-GPU block sharding is not ported yet (ROADMAP.md "
            "Queue 1, multi-GPU mesh)"
        )
    parts = decode_block_parts(blocks, block_size, device)
    if not parts:
        return b""
    result = b"".join(p.tobytes() for p in parts)
    if total_length is not None and len(result) != total_length:
        raise LZ4Error(
            f"decoded length {len(result)} != expected {total_length}"
        )
    return result
