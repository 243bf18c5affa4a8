"""Block-parallel LZ4 on one CUDA device.

The port of `lz4_tpu/parallel/blocks.py`'s batched path: a payload splits
into fixed-size independent blocks (frame descriptor
``block_independence=True``), one kernel launch encodes or decodes the
whole batch, and only the compressed lengths decide the frame layout on
the host.  Blocks of at most 64 KB encode on kernel B, larger ones on
kernel D.  Chained blocks encode in one launch of kernel D too: block k's
dictionary is the 64 KB of plaintext before it, known up front.

The JAX package pads each batch to a power-of-two bucket to bound its
compiles; that does not apply here: every call launches exactly B rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..block import LZ4Error
from ..constants import compress_bound
from ..ops import decode as _decode
from ..ops import decode_stream as _decode_stream
from ..ops import encode as _encode
from ..ops import encode_stream as _encode_stream
from ..ops.common import align1024, resolve_device

__all__ = [
    "comp_capacity",
    "split_blocks",
    "pack_blocks",
    "encode_blocks_device",
    "encode_blocks_chained_device",
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
    """Encode a batch on ``device`` (the plain versions when
    ``device="cpu"``): kernel B for blocks of at most 64 KB, kernel D above.

    Returns (out uint8 [B, OCAP], out_lens int32 [B]) on ``device``."""
    dev = resolve_device(device)
    kernel = (_encode.encode_blocks if bcap <= _encode.MAX_BLOCK
              else _encode_stream.encode_blocks_stream)
    out, out_lens, errs = kernel(
        torch.as_tensor(bufs).to(dev), torch.as_tensor(lens).to(dev), bcap,
        int(level), acceleration, fast_schedule=geometry,
    )
    if bool(errs.any()):
        raise RuntimeError("encoder overflow")
    return out, out_lens


def encode_blocks_chained_device(data: bytes, block_size: int,
                                 level: int = 0, acceleration: int = 1,
                                 device="cuda") -> list[bytes]:
    """Encode the blocks of a chained frame in one launch of kernel D on
    ``device`` (the plain version when ``device="cpu"``).

    Block k's dictionary is the 64 KB of plaintext before it, so the
    payload goes to the device once and row k is the window
    [k * block_size - dl, (k + 1) * block_size) of it, dl = min(k *
    block_size, 65536), with the dense schedule at levels 0-2 and the
    prefix in the chain at levels 3-12: the bytes of the sequential chain
    encoder.  Returns each block's compressed payload, in
    frame order (the caller stores a block whose payload is not smaller)."""
    dev = resolve_device(device)
    n = len(data)
    nb = -(-n // block_size)
    if nb == 0:
        return []
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    block_starts = torch.arange(nb, dtype=torch.int64) * block_size
    dls = block_starts.clamp(max=_encode_stream.WINDOW)
    ends = (block_starts + block_size).clamp(max=n)
    out, out_lens, errs = _encode_stream.encode_windows(
        payload, block_starts - dls, dls, ends - block_starts + dls,
        block_size, int(level), acceleration, fast_schedule="dense",
    )
    if bool(errs.any()):
        raise RuntimeError("chained encoder overflow")
    return pack_blocks(out, out_lens)


def decode_blocks_device(comps, clens, out_cap: int, dicts=None,
                         dict_lens=None, mode: str | None = None,
                         device="cuda"):
    """Decode a batch with kernel A on ``device`` (the plain version when
    ``device="cpu"``), optionally with per-row right-aligned 64 KB
    dictionaries (uint8 [B, 65536]) and their lengths, which take kernel
    C's batch form as in the JAX package (it launches kernel A too).

    ``mode`` ("full", "full2", "full2v") is validated and otherwise
    changes nothing: kernel A has one fast path.  Returns
    (out uint8 [B, out_cap], lens int32 [B], errs int32 [B]) on ``device``.
    """
    dev = resolve_device(device)
    if dicts is not None:
        return _decode_stream.decode_blocks_stream(
            torch.as_tensor(comps).to(dev), torch.as_tensor(clens).to(dev),
            out_cap, torch.as_tensor(dicts).to(dev),
            torch.as_tensor(dict_lens).to(dev),
            mode="full" if mode == "full2" else "full2v",
        )
    return _decode.decode_blocks(
        torch.as_tensor(comps).to(dev), torch.as_tensor(clens).to(dev),
        out_cap, mode=mode or "full2",
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
