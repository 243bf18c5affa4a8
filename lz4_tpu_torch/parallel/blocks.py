"""Block-parallel LZ4 on one CUDA device.

The port of `lz4_tpu/parallel/blocks.py`'s batched path: a payload splits
into fixed-size independent blocks (frame descriptor
``block_independence=True``), one kernel launch encodes or decodes the
whole batch, and only the compressed lengths decide the frame layout on
the host.  Blocks of at most 64 KB encode on kernel B, larger ones on
kernel D.  Chained blocks encode in one launch of kernel D too: block k's
dictionary is the 64 KB of plaintext before it, known up front.  The
payload goes to the device once; the block checksums a frame carries are
hashed there by kernel E (`block_checksums`), over the compressed rows
before they leave the device and over the payload where a block is
stored.

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
from ..ops import xxh32 as _xxh32
from ..ops.common import align1024, resolve_device

__all__ = [
    "comp_capacity",
    "upload",
    "split_blocks",
    "block_checksums",
    "pack_blocks",
    "encode_blocks_device",
    "encode_blocks_chained_device",
    "decode_blocks_device",
    "encode_blocks",
    "decode_blocks",
    "decode_frame_blocks",
]

# zero tail of every staged source row (the JAX package's `_PAD_TAIL`):
# kept so that both packages stage identical rows
_PAD_TAIL = 1024


def comp_capacity(block_size: int) -> int:
    """Aligned compressed-buffer width for decode inputs."""
    return align1024(compress_bound(block_size) + 8)


def upload(data, device) -> torch.Tensor:
    """``data`` (bytes-like, or a 1-D uint8 tensor) as a 1-D uint8 tensor
    on ``device``: one copy to the device."""
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8 or data.dim() != 1:
            raise ValueError("a payload tensor must be 1-D uint8")
        return data.to(device)
    if not len(data):
        return torch.zeros((0,), dtype=torch.uint8, device=device)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)


def split_blocks(data, block_size: int, pad_to: int | None = None):
    """Split ``data`` into fixed-capacity padded blocks.

    Returns (bufs uint8 [B, block_size + 1024], lens int32 [B]): on the CPU
    for bytes, on the payload's device (lens on the CPU) for a 1-D uint8
    tensor.  If ``pad_to`` is given, B is rounded up to a multiple of it
    (extra blocks have length 0)."""
    payload = upload(data, data.device if isinstance(data, torch.Tensor) else "cpu")
    n = payload.numel()
    nb = max(1, -(-n // block_size))
    if pad_to:
        nb = -(-nb // pad_to) * pad_to
    bufs = torch.zeros((nb, block_size + _PAD_TAIL), dtype=torch.uint8,
                       device=payload.device)
    full = n // block_size
    bufs[:full, :block_size] = payload[: full * block_size].view(full, block_size)
    if n % block_size:
        bufs[full, : n - full * block_size] = payload[full * block_size :]
    lens = (n - torch.arange(nb) * block_size).clamp(0, block_size)
    return bufs, lens.to(torch.int32)


def block_checksums(out, out_lens, raw, raw_starts, raw_lens) -> list[int]:
    """Each block's xxHash32 as its frame stores it, with kernel E on the
    device of ``out`` and ``raw`` (the plain version on the CPU): over the
    compressed row out[b, :out_lens[b]] where it is shorter than the raw
    block, else over the raw block raw[raw_starts[b] : + raw_lens[b]],
    which the frame then stores (the upstream rule, `frame.api.
    _assemble_frame`).  One launch for the compressed blocks, and one more
    only if a block is stored."""
    clens = torch.as_tensor(out_lens).cpu().to(torch.int64)
    rlens = torch.as_tensor(raw_lens).cpu().to(torch.int64)
    starts = torch.as_tensor(raw_starts).cpu().to(torch.int64)
    stored = clens >= rlens
    sums = torch.zeros(clens.shape, dtype=torch.int32)
    comp = (~stored).nonzero().flatten()
    if comp.numel():
        sums[comp] = _xxh32.xxh32_windows(
            out.reshape(-1), comp * out.shape[1], clens[comp]).cpu()
    if bool(stored.any()):
        sums[stored] = _xxh32.xxh32_windows(
            raw, starts[stored], rlens[stored]).cpu()
    return _xxh32.as_uint32(sums)


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


def encode_blocks_chained_device(data, block_size: int, level: int = 0,
                                 acceleration: int = 1, device="cuda",
                                 checksums: bool = False, prefix=None):
    """Encode the blocks of a chained frame in one launch of kernel D on
    ``device`` (the plain version when ``device="cpu"``).

    Block k's dictionary is the 64 KB of plaintext before it, so the
    payload (bytes, or a 1-D uint8 tensor) goes to the device once and row
    k is the window [k * block_size - dl, (k + 1) * block_size) of it,
    dl = min(k * block_size, 65536), with the dense schedule at levels 0-2
    and the prefix in the chain at levels 3-12: the bytes of the sequential
    chain encoder.  ``prefix`` (a 1-D uint8 tensor on ``device``, at most
    64 KB) is the history before the first block, which then reaches it:
    a stream's carried tail or a preset dictionary.  Returns each block's
    compressed payload, in frame order (the caller stores a block whose
    payload is not smaller), and with ``checksums=True`` the list of
    payloads and each block's checksum (`block_checksums`)."""
    dev = resolve_device(device)
    payload = upload(data, dev)
    p0 = 0
    if prefix is not None and prefix.numel():
        p0 = prefix.numel()
        payload = torch.cat([prefix.to(dev), payload])
    n = payload.numel()
    nb = -(-(n - p0) // block_size)
    if nb == 0:
        return ([], []) if checksums else []
    block_starts = p0 + torch.arange(nb, dtype=torch.int64) * block_size
    dls = block_starts.clamp(max=_encode_stream.WINDOW)
    ends = (block_starts + block_size).clamp(max=n)
    out, out_lens, errs = _encode_stream.encode_windows(
        payload, block_starts - dls, dls, ends - block_starts + dls,
        block_size, int(level), acceleration, fast_schedule="dense",
    )
    if bool(errs.any()):
        raise RuntimeError("chained encoder overflow")
    blocks = pack_blocks(out, out_lens)
    if not checksums:
        return blocks
    return blocks, block_checksums(out, out_lens, payload, block_starts,
                                   ends - block_starts)


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
    data,
    block_size: int = 1 << 20,
    level: int = 0,
    mesh=None,
    geometry: str = "canonical",
    device="cuda",
    checksums: bool = False,
):
    """One-shot: split ``data`` (bytes, or a 1-D uint8 tensor) into
    independent blocks, encode them in one batch on ``device``, return the
    compressed blocks in frame order, and with ``checksums=True`` the list
    of blocks and each block's checksum (`block_checksums`)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: multi-GPU block sharding is not ported yet (ROADMAP.md "
            "Queue 1, multi-GPU mesh)"
        )
    dev = resolve_device(device)
    payload = upload(data, dev)
    if not payload.numel():
        return ([], []) if checksums else []
    bufs, lens = split_blocks(payload, block_size)
    outs, out_lens = encode_blocks_device(
        bufs, lens, block_size, level, geometry=geometry, device=dev
    )
    blocks = pack_blocks(outs, out_lens)
    if not checksums:
        return blocks
    starts = torch.arange(len(blocks), dtype=torch.int64) * block_size
    return blocks, block_checksums(outs, out_lens, payload, starts, lens)


def decode_frame_blocks(frame_u8, table, block_size: int) -> torch.Tensor:
    """Decode the independent blocks of one frame in one batch on the
    device of ``frame_u8`` (kernel A; the plain version on the CPU) and put
    the content together there.

    ``table`` holds each block's (offset in frame_u8, length, stored), in
    frame order: a stored block is copied as it is.  The compressed blocks
    become zero-padded rows by one concatenation on the device.  Raises
    LZ4Error on the first malformed block.  Returns the content, uint8
    [N], on the device of ``frame_u8``."""
    cap = comp_capacity(block_size)
    comp = [(off, length) for off, length, stored in table if not stored]
    for b, (_, length) in enumerate(comp):
        if length > cap - 20:
            raise LZ4Error(
                f"compressed block {b} of {length} bytes exceeds the "
                f"bound for {block_size}-byte blocks"
            )
    decoded = iter(())
    if comp:
        pad = frame_u8.new_zeros((cap,))
        rows = []
        for off, length in comp:
            rows += [frame_u8[off:off + length], pad[:cap - length]]
        outs, out_lens, errs = decode_blocks_device(
            torch.cat(rows).view(len(comp), cap),
            [length for _, length in comp], block_size,
            device=frame_u8.device,
        )
        errs = errs.cpu()
        if bool(errs.any()):
            bad = int(errs.nonzero()[0, 0])
            raise LZ4Error(f"malformed LZ4 block {bad} (err={int(errs[bad])})")
        decoded = (outs[b, :n] for b, n in enumerate(out_lens.tolist()))
    parts = [frame_u8[off:off + length] if stored else next(decoded)
             for off, length, stored in table]
    return torch.cat(parts) if parts else frame_u8.new_zeros((0,))


def decode_blocks(
    blocks: list[bytes],
    block_size: int,
    total_length: int | None = None,
    mesh=None,
    device="cuda",
) -> bytes:
    """Decode independent compressed blocks in one batch and concatenate
    (`decode_frame_blocks` over the blocks laid end to end).  Raises
    LZ4Error on the first malformed block."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: multi-GPU block sharding is not ported yet (ROADMAP.md "
            "Queue 1, multi-GPU mesh)"
        )
    dev = resolve_device(device)
    if not blocks:
        return b""
    offs = np.cumsum([0] + [len(b) for b in blocks]).tolist()
    table = [(off, len(b), False) for off, b in zip(offs, blocks)]
    content = decode_frame_blocks(
        upload(b"".join(blocks), dev), table, block_size)
    result = content.cpu().numpy().tobytes()
    if total_length is not None and len(result) != total_length:
        raise LZ4Error(
            f"decoded length {len(result)} != expected {total_length}"
        )
    return result
