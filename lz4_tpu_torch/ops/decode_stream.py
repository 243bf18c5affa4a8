"""Kernel C, the streaming decoder, in its two jobs.

The port of `lz4_tpu/ops/decode_pallas_stream.py` (`pallas_decode_stream`,
wrapper `decode_blocks_pallas_stream`):

- `decode_blocks_stream`, the batch form: one block per row at any
  ``out_cap``, with optional dictionaries.  That is exactly kernel A's
  function (`ops/decode.py`), which takes any ``out_cap`` and dictionary
  rows, so it launches kernel A.  The TPU kernel exists because staged
  rows above 64 KB do not fit the TPU's scalar memory; nothing on the card
  needs it.
- `decode_chain`, the chained form: every block of one chained frame in
  one launch of `csrc/decode_stream.cu`, where the JAX package launches C
  once per block and carries the 64 KB window through the host; and its
  plain version `decode_chain_plain`.  The kernel's source says what bounds
  it on the card and what its design does about that.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check, load
from .decode import _decode_row, decode_blocks

STREAM_MODES = ("full", "full2v")
WINDOW = 65536
# the most a compressed block of L bytes can decode to is 255 L: a
# sequence of 3 + k bytes (token, offset, k length extensions) gives at
# most 19 + 255 k
MAX_EXPANSION = 255

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("decode_stream")
        lib.lz4t_decode_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.lz4t_decode_chain.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode_blocks_stream(comps_u8, comp_lens, out_cap: int, dicts_u8=None,
                         dict_lens=None, mode: str = "full"):
    """Decode B independent LZ4 blocks at any ``out_cap``, optionally with
    right-aligned 64 KB dictionaries: kernel A's contract
    (`ops.decode.decode_blocks`), which it launches.  ``mode`` is "full" or
    "full2v" (the TPU kernel's fast-arm variants; the same bytes)."""
    if mode not in STREAM_MODES:
        raise ValueError(
            f"unknown streaming decode mode {mode!r}; "
            "expected 'full' or 'full2v'"
        )
    return decode_blocks(comps_u8, comp_lens, out_cap, dicts_u8, dict_lens,
                         mode=mode)


def _validate_chain(frame_u8, table, block_size, dict_u8):
    frame = torch.as_tensor(frame_u8)
    if frame.dtype != torch.uint8 or frame.dim() != 1:
        raise ValueError("frame_u8 must be a 1-D uint8 tensor")
    tab = torch.as_tensor(table, dtype=torch.int64).cpu().reshape(-1, 3)
    if not 0 < block_size < 1 << 31:
        raise ValueError("block_size must lie in [1, 2**31)")
    off, length, stored = tab.unbind(1)
    if tab.shape[0] and (
        int(off.min()) < 0 or int(length.min()) < 0
        or int(length.max()) >= 1 << 31
        or int((off + length).max()) > frame.numel()
    ):
        raise ValueError("a block reaches outside the frame")
    if bool(((stored != 0) & (length > block_size)).any()):
        raise ValueError("a stored block exceeds block_size")
    # each block's slot of the output: a compressed block decodes with the
    # slot as its cap (both versions), so one that broke the bound above
    # would fail, not write past its slot
    caps = torch.where(
        stored != 0, length,
        (length * MAX_EXPANSION).clamp(max=block_size),
    )
    preset = b""
    if dict_u8 is not None:
        d = torch.as_tensor(dict_u8)
        if d.dtype != torch.uint8 or d.dim() != 1:
            raise ValueError("dict_u8 must be a 1-D uint8 tensor")
        preset = d[-WINDOW:].cpu().numpy().tobytes()
    return frame, tab, int(caps.sum()), preset


def decode_chain_plain(frame_u8, table, block_size: int, dict_u8=None):
    """The plain PyTorch version of `decode_chain`: a host loop over the
    blocks that carries the 64 KB window from block to block."""
    frame, tab, cap, preset = _validate_chain(
        frame_u8, table, block_size, dict_u8
    )
    raw = frame.cpu().numpy()
    stream = bytearray()
    bad, err = -1, 0
    for k, (off, length, stored) in enumerate(tab.tolist()):
        chunk = raw[off:off + length].tobytes()
        if stored:
            stream += chunk
            continue
        need = WINDOW - len(stream)
        if need > 0:
            window = preset[max(len(preset) - need, 0):] + bytes(stream)
        else:
            window = bytes(stream[-WINDOW:])
        data, err = _decode_row(
            chunk, length, min(length * MAX_EXPANSION, block_size), window
        )
        stream += data
        if err:
            bad = k
            break
    out = torch.zeros((cap,), dtype=torch.uint8)
    if stream:
        out[: len(stream)] = torch.frombuffer(stream, dtype=torch.uint8)
    status = torch.tensor([len(stream), bad, err], dtype=torch.int64)
    return out.to(frame.device), status.to(frame.device)


def decode_chain(frame_u8, table, block_size: int, dict_u8=None):
    """Decode every block of one chained LZ4 frame, in order.

    frame_u8: uint8 [N], the frame's bytes.  table: int64 [nb, 3], each
    block's (offset in frame_u8, length, stored) as the host scan of the
    block table found them.  dict_u8: optional uint8 [D], a preset
    dictionary (its last 64 KB is the first block's window).  Each block
    decodes into at most ``block_size`` bytes, its matches reaching the
    64 KB before it, across block boundaries and into the dictionary.

    Returns (stream uint8 [CAP], status int64 [3]) on the input's device:
    stream[:written] is the decoded content and status is (written, bad,
    err): bad is -1, or the index of the first malformed block, where the
    decode stopped, and err its code (1 malformed, 2 trailing garbage);
    written then counts that block's bytes up to its failing sequence.  A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel
    once, whatever the number of blocks.
    """
    frame, tab, cap, preset = _validate_chain(
        frame_u8, table, block_size, dict_u8
    )
    if frame.device.type != "cuda":
        return decode_chain_plain(frame, tab, block_size, dict_u8)
    frame = frame.contiguous()
    dev = frame.device
    out = torch.zeros((WINDOW + cap,), dtype=torch.uint8, device=dev)
    if preset:
        out[WINDOW - len(preset): WINDOW] = torch.frombuffer(
            bytearray(preset), dtype=torch.uint8
        ).to(dev)
    status = torch.tensor([0, -1, 0], dtype=torch.int64, device=dev)
    nb = tab.shape[0]
    if nb == 0:
        return out[WINDOW:], status
    tab_d = tab.contiguous().to(dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        rc = lib.lz4t_decode_chain(
            frame.data_ptr(), tab_d.data_ptr(), nb, block_size,
            out.data_ptr(), len(preset), status.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, "decode_chain")
    decode_chain.launches += 1
    return out[WINDOW:], status


decode_chain.launches = 0
