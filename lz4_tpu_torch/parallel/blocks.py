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

The dense codecs X1 (`ops/encode_dense.py`) and X2 (`ops/decode_dense.py`),
PyTorch tensor ops with their own bytes, run the batched API
(`batched_encode`, `batched_decode`, `encode_chunked`, `decode_chunked`)
and every ``mesh=`` path, as the JAX package's XLA kernels do: a `Mesh` is
a list of torch devices, and `sharded_encode_fn` / `sharded_decode_fn`
split a batch into one equal shard of rows per device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..block import LZ4Error
from ..constants import compress_bound
from ..ops import decode as _decode
from ..ops import decode_dense as _decode_dense
from ..ops import decode_stream as _decode_stream
from ..ops import encode as _encode
from ..ops import encode_dense as _encode_dense
from ..ops import encode_stream as _encode_stream
from ..ops import xxh32 as _xxh32
from ..ops.common import align1024, resolve_device
from ..ops.encode_dense import _PAD_TAIL, level_to_depth

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
    "batched_encode",
    "batched_decode",
    "batched_encode_fn",
    "batched_decode_fn",
    "encode_chunked",
    "decode_chunked",
    "warmup_device",
    "Mesh",
    "make_mesh",
    "sharded_encode_fn",
    "sharded_decode_fn",
]

# The scratch one row group of X1 or X2 may take on its device: the dense
# codecs' intermediates are whole-row int32 and int64 arrays, so a group's
# rows are counted from each row's estimated scratch (`_encode_row_bytes`,
# `_decode_row_bytes`), not from the TPU's 32-block VMEM cap.
DENSE_GROUP_BYTES = 2 << 30


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


# ---------------------------------------------------------------------------
# The dense codecs over batches: X1 and X2 in row groups
# ---------------------------------------------------------------------------


def batched_encode(bufs, lens, bcap: int, k_depth: int = 1):
    """Encode B independent blocks with X1 on the device of ``bufs``.

    bufs: uint8 [B, bcap + 1024] (block bytes at [0, lens[b]), zeros after);
    lens: int32 [B].  Returns (out uint8 [B, OCAP], out_lens int32 [B])."""
    lens = torch.as_tensor(lens).to(bufs.device, torch.int32)
    return _encode_dense.encode_block_fixed(
        bufs, lens, torch.zeros_like(lens), 0, bcap, k_depth)


def batched_decode(comps, comp_lens, out_cap: int):
    """Decode B independent blocks with X2 on the device of ``comps``.

    comps: uint8 [B, CAP], zero-padded.  Returns (out uint8 [B, out_cap],
    out_lens int32 [B], errs int32 [B])."""
    comp_lens = torch.as_tensor(comp_lens).to(comps.device, torch.int32)
    nodict = torch.zeros((comps.shape[0], 8), dtype=torch.uint8, device=comps.device)
    return _decode_dense.decode_block_fixed(
        comps, comp_lens, nodict, torch.zeros_like(comp_lens), out_cap)


def batched_encode_fn(bcap: int, k_depth: int = 1):
    """`batched_encode` at one shape, as a function of (bufs, lens)."""
    return functools.partial(batched_encode, bcap=bcap, k_depth=k_depth)


def batched_decode_fn(out_cap: int):
    """`batched_decode` at one shape, as a function of (comps, comp_lens)."""
    return functools.partial(batched_decode, out_cap=out_cap)


def _encode_row_bytes(bcap: int, k_depth: int) -> int:
    """X1's estimated scratch for one row: ~256 bytes a source position
    (words, the sort's int64 order, the 8 periodic tables, the length
    compares' gathers) and 4 more a candidate, and ~128 bytes an output
    byte (the emitter's gathered sequence fields and int64 indices)."""
    ocap = align1024(compress_bound(bcap))
    return (256 + 4 * k_depth) * (bcap + _PAD_TAIL) + 128 * ocap


def _decode_row_bytes(cap: int, out_cap: int) -> int:
    """X2's estimated scratch for one row: ~160 bytes an input position
    (the speculative parse and the sequence table) and ~64 an output byte
    (markers, source map, pointer doubling)."""
    return 160 * cap + 64 * out_cap


def group_rows(row_bytes: int) -> int:
    """The rows of one group: at most DENSE_GROUP_BYTES of estimated
    scratch, and at least one row."""
    return max(1, DENSE_GROUP_BYTES // row_bytes)


def _groups(rows: int, row_bytes: int):
    step = group_rows(row_bytes)
    return [(a, min(a + step, rows)) for a in range(0, rows, step)]


def encode_chunked(bufs, lens, bcap: int, k_depth: int = 1, device="cuda"):
    """Encode any number of blocks with X1 on ``device``, in row groups of
    at most `DENSE_GROUP_BYTES` (2 GiB) of estimated scratch each
    (`_encode_row_bytes`).  Returns (out uint8 [B, OCAP], out_lens int32
    [B]) on ``device``."""
    dev = resolve_device(device)
    bufs = torch.as_tensor(bufs)
    lens = torch.as_tensor(lens)
    outs = [batched_encode(bufs[a:b].to(dev), lens[a:b], bcap, k_depth)
            for a, b in _groups(bufs.shape[0], _encode_row_bytes(bcap, k_depth))]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def decode_chunked(comps, comp_lens, out_cap: int, device="cuda"):
    """Decode any number of blocks with X2 on ``device``, in row groups of
    at most `DENSE_GROUP_BYTES` (2 GiB) of estimated scratch each
    (`_decode_row_bytes`).  Returns (out uint8 [B, out_cap], out_lens int32
    [B], errs int32 [B]) on ``device``."""
    dev = resolve_device(device)
    comps = torch.as_tensor(comps)
    clens = torch.as_tensor(comp_lens)
    outs = [batched_decode(comps[a:b].to(dev), clens[a:b], out_cap)
            for a, b in _groups(comps.shape[0],
                                _decode_row_bytes(comps.shape[1], out_cap))]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def warmup_device(block_size: int = 65536, levels=(0,), device="cuda") -> int:
    """Build and load the CUDA kernels, and launch the batch encode and
    decode of ``block_size`` blocks once per level on ``device``, so that a
    first real call pays for neither.  Returns the number of levels warmed:
    0 for ``device="cpu"``, which has nothing to build."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return 0
    for level in levels:
        bufs, lens = split_blocks(b"warmup payload " * 8, block_size)
        out, out_lens = encode_blocks_device(bufs, lens, block_size, int(level),
                                             device=dev)
        comps = torch.zeros((1, comp_capacity(block_size)), dtype=torch.uint8,
                            device=dev)
        n = int(out_lens[0])
        comps[0, :n] = out[0, :n]
        decode_blocks_device(comps, out_lens, block_size, device=dev)
    torch.cuda.synchronize(dev)
    return len(levels)


# ---------------------------------------------------------------------------
# The mesh: shards of rows on a list of devices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: the devices an LZ4 frame's block axis is
    split over, in order, and the axis' name.  A device may appear more
    than once (the shards then run one after another on it)."""

    devices: tuple
    axis: str = "block"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = "block") -> Mesh:
    """A mesh over ``devices`` (torch devices or their names), by default
    every CUDA device.  A CUDA device without a card raises, as does the
    default; it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass devices=['cpu', ...] for a "
                "mesh of CPU devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis)


def _shards(mesh: Mesh, axis: str, rows: int):
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    if rows % mesh.size:
        raise ValueError(
            f"a batch of {rows} rows does not split evenly over "
            f"{mesh.size} devices")
    per = rows // mesh.size
    return [(dev, k * per, (k + 1) * per) for k, dev in enumerate(mesh.devices)]


def sharded_encode_fn(mesh: Mesh, bcap: int, k_depth: int = 1, axis: str = "block"):
    """X1 over ``mesh``: a function of (bufs, lens) that splits the batch
    into one equal shard of rows per device, encodes each on its device
    (`encode_chunked`) and joins the results in frame order on the mesh's
    first device.  No collective: the blocks are independent."""

    def run(bufs, lens):
        bufs, lens = torch.as_tensor(bufs), torch.as_tensor(lens)
        parts = [encode_chunked(bufs[a:b], lens[a:b], bcap, k_depth, device=dev)
                 for dev, a, b in _shards(mesh, axis, bufs.shape[0])]
        home = mesh.devices[0]
        return tuple(torch.cat([p[i].to(home) for p in parts]) for i in range(2))

    return run


def sharded_decode_fn(mesh: Mesh, out_cap: int, axis: str = "block"):
    """X2 over ``mesh``: a function of (comps, comp_lens) that splits the
    batch into one equal shard of rows per device, decodes each on its
    device (`decode_chunked`) and joins (out, out_lens, errs) in frame order
    on the mesh's first device."""

    def run(comps, comp_lens):
        comps, clens = torch.as_tensor(comps), torch.as_tensor(comp_lens)
        parts = [decode_chunked(comps[a:b], clens[a:b], out_cap, device=dev)
                 for dev, a, b in _shards(mesh, axis, comps.shape[0])]
        home = mesh.devices[0]
        return tuple(torch.cat([p[i].to(home) for p in parts]) for i in range(3))

    return run


def _decode_rows_mesh(rows, lens, block_size: int, mesh: Mesh):
    """X2 over ``mesh`` on compressed rows, padded to a multiple of the
    mesh's size with the 1-byte empty block (0x00: length 0, no error)."""
    nb = rows.shape[0]
    nb_pad = -(-nb // mesh.size) * mesh.size
    comps = torch.cat([rows, rows.new_zeros((nb_pad - nb, rows.shape[1]))])
    clens = torch.ones((nb_pad,), dtype=torch.int32)
    clens[:nb] = torch.as_tensor(lens, dtype=torch.int32)
    outs, out_lens, errs = sharded_decode_fn(mesh, block_size, mesh.axis)(comps, clens)
    return outs[:nb], out_lens[:nb], errs[:nb]


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
    of blocks and each block's checksum (`block_checksums`).

    With ``mesh`` the blocks are split over its devices and encoded by X1,
    the JAX package's mesh bytes (``geometry`` does not apply, and
    ``device`` gives way to the mesh's first device, which joins the
    results); the batch is padded with empty rows to a multiple of the
    mesh's size."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    payload = upload(data, dev)
    if not payload.numel():
        return ([], []) if checksums else []
    if mesh is not None:
        nb = -(-payload.numel() // block_size)
        bufs, lens = split_blocks(payload, block_size, pad_to=mesh.size)
        fn = sharded_encode_fn(mesh, block_size, level_to_depth(level), mesh.axis)
        outs, out_lens = (t[:nb] for t in fn(bufs, lens))
        lens = lens[:nb]
    else:
        bufs, lens = split_blocks(payload, block_size)
        outs, out_lens = encode_blocks_device(
            bufs, lens, block_size, level, geometry=geometry, device=dev
        )
    blocks = pack_blocks(outs, out_lens)
    if not checksums:
        return blocks
    starts = torch.arange(len(blocks), dtype=torch.int64) * block_size
    return blocks, block_checksums(outs, out_lens, payload, starts, lens)


def decode_frame_blocks(frame_u8, table, block_size: int,
                        mesh=None) -> torch.Tensor:
    """Decode the independent blocks of one frame in one batch on the
    device of ``frame_u8`` (kernel A; the plain version on the CPU), or
    split over ``mesh`` by X2, and put the content together on the device
    of ``frame_u8``.

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
        rows = torch.cat(rows).view(len(comp), cap)
        lens = [length for _, length in comp]
        if mesh is not None:
            outs, out_lens, errs = _decode_rows_mesh(rows, lens, block_size, mesh)
            outs = outs.to(frame_u8.device)
        else:
            outs, out_lens, errs = decode_blocks_device(
                rows, lens, block_size, device=frame_u8.device)
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
    (`decode_frame_blocks` over the blocks laid end to end), on ``device``
    or, with ``mesh``, by X2 split over its devices.  Raises LZ4Error on
    the first malformed block."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    if not blocks:
        return b""
    offs = np.cumsum([0] + [len(b) for b in blocks]).tolist()
    table = [(off, len(b), False) for off, b in zip(offs, blocks)]
    content = decode_frame_blocks(
        upload(b"".join(blocks), dev), table, block_size, mesh=mesh)
    result = content.cpu().numpy().tobytes()
    if total_length is not None and len(result) != total_length:
        raise LZ4Error(
            f"decoded length {len(result)} != expected {total_length}"
        )
    return result
