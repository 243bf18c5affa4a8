"""Multi-process block-parallel LZ4 over `torch.distributed`.

The port of `lz4_tpu/parallel/multihost.py`.  An LZ4 frame's blocks are
independent (and a chained frame's windows are plaintext every process
holds), so the frame's block axis splits across processes, each owning a
contiguous range, with three small exchanges:

1. the preset dictionary, broadcast from process 0 (`broadcast_dictionary`);
2. each range's compressed or decoded lengths, all-gathered;
3. each range's payloads, all-gathered in frame order over fixed-width
   lanes, so that every process assembles the same result.

The exchanges run on the ``gloo`` backend over CPU tensors (NCCL refuses two
ranks on one card, and the exchanged bytes are small); each process encodes
or decodes its own range on ``device`` in one batch.  `init_from_env` reads
the JAX package's ``LZ4TPU_COORDINATOR`` (host:port), ``LZ4TPU_NUM_PROCESSES``
and ``LZ4TPU_PROCESS_ID``.
"""

from __future__ import annotations

import os
import struct

import torch
import torch.distributed as dist

from ..block import LZ4Error
from ..constants import _as_bytes, compress_bound
from ..frame.api import _scan_frame, _verify_blocks
from ..frame.descriptor import EncoderSettings
from ..frame.header import LZ4FormatError, build_header
from ..ops.common import resolve_device
from ..ops.encode_stream import WINDOW
from ..ops.xxh32 import as_uint32, xxh32_windows
from .blocks import (
    decode_frame_blocks, encode_blocks, encode_blocks_chained_device, upload,
)

__all__ = [
    "init_from_env",
    "broadcast_dictionary",
    "compress_distributed",
    "decompress_distributed",
    "local_block_range",
]

def init_from_env(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the process group (gloo) from the arguments or the LZ4TPU_*
    environment variables.  Returns False, doing nothing, when no
    coordinator is given: a single process takes the local paths."""
    coordinator_address = coordinator_address or os.environ.get(
        "LZ4TPU_COORDINATOR")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("LZ4TPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("LZ4TPU_PROCESS_ID", "0"))
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group("gloo", init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def _world() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (a CPU tensor of one shape), stacked in rank
    order."""
    parts = [torch.empty_like(t) for _ in range(_world()[1])]
    dist.all_gather(parts, t)
    return torch.stack(parts)


def broadcast_dictionary(dictionary: bytes | None, max_len: int = 65536) -> bytes:
    """Process 0's preset dictionary (its last ``max_len`` bytes), on every
    process."""
    if _world()[1] == 1:
        return bytes(dictionary or b"")
    buf = torch.zeros(max_len + 4, dtype=torch.uint8)
    if _world()[0] == 0 and dictionary:
        d = bytes(dictionary[-max_len:])
        buf[:4] = torch.frombuffer(bytearray(struct.pack("<I", len(d))),
                                   dtype=torch.uint8)
        buf[4:4 + len(d)] = torch.frombuffer(bytearray(d), dtype=torch.uint8)
    dist.broadcast(buf, src=0)
    (n,) = struct.unpack("<I", buf[:4].numpy().tobytes())
    return buf[4:4 + n].numpy().tobytes()


def local_block_range(n_blocks: int, process_id: int, n_processes: int):
    """The contiguous block range [start, stop) a process owns (contiguous
    ownership keeps frame order)."""
    per = -(-n_blocks // n_processes)
    start = min(process_id * per, n_blocks)
    stop = min(start + per, n_blocks)
    return start, stop


def compress_distributed(
    data: bytes,
    block_size: int = 1 << 20,
    level: int = 0,
    settings=None,
    device="cuda",
) -> bytes:
    """Compress ``data`` (the same on every process) into one LZ4 frame,
    the block axis split across the processes; every process returns the
    same frame.

    Each process encodes its own block range in one batch on ``device``:
    independent blocks canonical (`parallel.encode_blocks`), chained blocks
    each with the 64 KB of plaintext before it as its dictionary
    (`parallel.encode_blocks_chained_device`, the dense family), and a
    block whose payload is not smaller is stored.  The frame equals the
    JAX package's single-process host frame."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    settings = settings or EncoderSettings(
        chain_blocks=False, block_size=block_size, compression_level=level)
    chained = settings.chain_blocks
    block_size = settings.block_size
    level = settings.compression_level
    d = settings.to_descriptor()

    n = len(data)
    n_blocks = max(1, -(-n // block_size))
    pid, nproc = _world()
    start, stop = local_block_range(n_blocks, pid, nproc)
    per = -(-n_blocks // nproc)  # lanes per process

    # ---- this process's blocks, in one batch ---------------------------
    payload = upload(data, dev)
    mine = payload[start * block_size:stop * block_size]
    if stop == start:
        comps = []
    elif chained:
        lo = max(0, start * block_size - WINDOW)
        comps = encode_blocks_chained_device(
            mine, block_size, level, device=dev,
            prefix=payload[lo:start * block_size])
    else:
        comps = encode_blocks(mine, block_size, level, device=dev)
    cap = compress_bound(block_size)
    lanes = torch.zeros((per, cap), dtype=torch.uint8)
    lane_lens = torch.zeros((per,), dtype=torch.int32)
    stored = torch.zeros((per,), dtype=torch.int32)
    for i, comp in enumerate(comps):
        off = (start + i) * block_size
        raw_len = min(block_size, n - off)
        if len(comp) >= raw_len:
            comp, stored[i] = data[off:off + raw_len], 1
        if comp:
            lanes[i, :len(comp)] = torch.frombuffer(bytearray(comp), dtype=torch.uint8)
        lane_lens[i] = len(comp)

    # ---- exchanges ------------------------------------------------------
    if nproc > 1:
        lane_lens = _all_gather(lane_lens).reshape(nproc * per)
        stored = _all_gather(stored).reshape(nproc * per)
        lanes = _all_gather(lanes).reshape(nproc * per, cap)

    # ---- the frame, the same on every process ---------------------------
    # empty content: the header and the EndMark only
    nb = n_blocks if n else 0
    lens = lane_lens[:nb].tolist()
    flags = stored[:nb].tolist()
    bodies = [lanes[b, :lens[b]].numpy().tobytes() for b in range(nb)]
    sums = []
    if d.block_checksum and nb:
        flat = upload(b"".join(bodies), dev)
        starts = torch.tensor([0] + lens[:-1], dtype=torch.int64).cumsum(0)
        sums = as_uint32(xxh32_windows(flat, starts, lens))
    parts = [build_header(d)]
    for b in range(nb):
        parts.append(struct.pack("<I", lens[b] | (0x80000000 if flags[b] else 0)))
        parts.append(bodies[b])
        if d.block_checksum:
            parts.append(struct.pack("<I", sums[b]))
    parts.append(b"\x00\x00\x00\x00")
    if d.content_checksum:
        (csum,) = as_uint32(xxh32_windows(payload, [0], [n]))
        parts.append(struct.pack("<I", csum))
    return b"".join(parts)


def decompress_distributed(frame: bytes, device="cuda") -> bytes:
    """Decompress one independent-block LZ4 frame (the same on every
    process), the block axis split across the processes; every process
    returns the same content.

    Every process scans the block table and verifies the block checksums,
    then decodes its own range in one batch on ``device``; the ranges'
    contents are all-gathered in frame order.  A chained frame raises
    LZ4FormatError (its blocks decode in order: use the local paths), and
    a malformed block raises LZ4Error on every process."""
    dev = resolve_device(device)
    frame = _as_bytes(frame)
    try:
        scan = _scan_frame(frame)
    except ValueError:  # not an LZ4 frame, or a malformed header
        scan = None
    if (scan is None or scan.descriptor.block_chaining
            or scan.descriptor.dictionary_id is not None):
        raise LZ4FormatError(
            "distributed decode needs a single independent-block frame")
    frame_u8 = upload(frame, dev)
    d = scan.descriptor
    if d.block_checksum:  # in a sequential scan's order: before the fault
        _verify_blocks(frame_u8, frame, scan.blocks)
    if scan.fault is not None and scan.fault.over_limit:
        raise scan.fault
    if scan.fault is not None or scan.end != len(frame):
        raise LZ4FormatError(
            "distributed decode needs a single independent-block frame")
    pid, nproc = _world()
    start, stop = local_block_range(len(scan.blocks), pid, nproc)
    status = 0
    try:
        mine = decode_frame_blocks(frame_u8, scan.blocks[start:stop], d.block_size)
    except LZ4Error:
        status, mine = 1, frame_u8.new_zeros((0,))
    if nproc > 1:
        # lengths and faults first, so that a fault in one range raises on
        # every process, not only on its owner
        got = _all_gather(torch.tensor([mine.numel(), status], dtype=torch.int64))
        sizes, status = got[:, 0].tolist(), int(got[:, 1].max())
        if not status:
            lane = torch.zeros((max(1, *sizes),), dtype=torch.uint8)
            lane[:mine.numel()] = mine.cpu()
            lanes = _all_gather(lane)
            mine = torch.cat([lanes[r, :sizes[r]] for r in range(nproc)]).to(dev)
    if status:
        raise LZ4Error("malformed LZ4 block in a distributed decode")
    if d.content_checksum:
        (expected,) = struct.unpack_from("<I", frame, scan.tail)
        if as_uint32(xxh32_windows(mine, [0], [mine.numel()]))[0] != expected:
            raise LZ4FormatError("content checksum mismatch")
    if d.content_length is not None and mine.numel() != d.content_length:
        raise LZ4FormatError("content length mismatch")
    return mine.cpu().numpy().tobytes()
