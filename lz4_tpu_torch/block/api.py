"""One-block encode and decode on a device, with preset dictionaries.

The port of `lz4_tpu/block/api.py`: one block goes through the batch
kernels as a batch of one, its width rounded up to a power of two.  A
block of at most 64 KB with no dictionary encodes on kernel B, anything
else on kernel D; decode takes kernel A, or C's batch form with a
dictionary, and `partial_decode` kernel A's one-warp route with an output
limit.  A decode with no output bound runs the dense decoder X2
(`ops/decode_dense.py`), which sizes its output as it goes, as the JAX
package's device route does.  `encode_into` and `decode_into` copy the
result once from the card into the caller's buffer.
"""

from __future__ import annotations

import torch

from . import LZ4Error
from ..constants import _as_bytes, compress_bound
from ..ops import decode as _decode
from ..ops import decode_dense as _decode_dense
from ..ops import decode_stream as _decode_stream
from ..ops import encode as _encode
from ..ops import encode_stream as _encode_stream
from ..ops.common import align1024, bucket, resolve_device

__all__ = [
    "compress_bound",
    "maximum_output_size",
    "encode",
    "decode",
    "encode_into",
    "decode_into",
    "partial_decode",
]

_GEOMETRIES = ("canonical", "dense")


def _stage_dict_window(dictionary, dev):
    """Right-align the last 64 KB of a preset dictionary into the kernels'
    uint8 [1, 65536] window layout.  Returns (dicts, dict_lens)."""
    win = bytes(dictionary)[-65536:]
    dicts = torch.zeros((1, 65536), dtype=torch.uint8)
    if win:
        dicts[0, 65536 - len(win):] = torch.frombuffer(
            bytearray(win), dtype=torch.uint8
        )
    return dicts.to(dev), torch.tensor([len(win)], dtype=torch.int32, device=dev)


def maximum_output_size(length: int) -> int:
    """The most one block of ``length`` bytes compresses to (reference
    `LZ4Codec.MaximumOutputSize`)."""
    return compress_bound(length)


def _row(data: bytes, width: int, dev) -> torch.Tensor:
    row = torch.zeros((1, width), dtype=torch.uint8)
    if data:
        row[0, : len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return row.to(dev)


def encode(
    data,
    level: int = 0,
    dictionary: bytes = b"",
    acceleration: int = 1,
    geometry: str = "canonical",
    device="cuda",
    target_capacity: int | None = None,
) -> bytes | None:
    """Compress one block on ``device`` (the plain versions when
    ``device="cpu"``).  Returns None when ``target_capacity`` is given and
    the result does not fit it.

    ``geometry`` (FAST levels, no dictionary): "canonical" reproduces
    LZ4_compress_default byte for byte; "dense" is the 15-bit finder.  A
    dictionary always takes the dense schedule, byte-identical to the host
    engines' ``encode(..., dictionary=...)``.  Levels 3-12 run the HC and
    OPT arms, with or without a dictionary."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    if geometry not in _GEOMETRIES:
        raise ValueError(
            f"unknown FAST geometry {geometry!r}; expected one of {_GEOMETRIES}"
        )
    n = len(data)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    bcap = bucket(max(n, 16))
    if not dictionary and bcap <= _encode.MAX_BLOCK:
        out, clens, errs = _encode.encode_blocks(
            _row(data, bcap + 1024, dev), lens, bcap, int(level),
            acceleration, fast_schedule=geometry,
        )
    else:
        dicts = dict_lens = None
        if dictionary:
            dicts, dict_lens = _stage_dict_window(dictionary, dev)
        out, clens, errs = _encode_stream.encode_blocks_stream(
            _row(data, bcap, dev), lens, bcap, int(level), acceleration,
            dicts=dicts, dict_lens=dict_lens, fast_schedule=geometry,
        )
    if int(errs[0]):
        raise LZ4Error("device encoder overflow")
    clen = int(clens[0])
    if target_capacity is not None and clen > target_capacity:
        return None
    return out[0, :clen].cpu().numpy().tobytes()


def decode(
    data,
    target_length: int | None = None,
    dictionary: bytes = b"",
    capacity: int | None = None,
    device="cuda",
) -> bytes:
    """Decompress one block on ``device`` (the plain versions when
    ``device="cpu"``) into at most ``target_length`` bytes, which it must
    fill exactly, or at most ``capacity`` bytes.  With neither, the dense
    decoder X2 tries outputs of 4, 32 and 255 times the block's length in
    turn (`decode_dense.decode_block_bytes`).  Matches may reach the last
    64 KB of ``dictionary``."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    bound = target_length if target_length is not None else capacity
    if bound is None:
        return _decode_dense.decode_block_bytes(data, dictionary=dictionary,
                                                device=dev)
    out_cap = bucket(max(int(bound), 16))
    # a valid block for this bound cannot be longer (LZ4's length codings
    # have no redundant forms)
    cap = align1024(compress_bound(out_cap))
    if len(data) > cap:
        raise LZ4Error(
            f"compressed block of {len(data)} bytes is longer than any "
            f"valid block of at most {int(bound)} bytes"
        )
    comps = _row(data, cap, dev)
    clens = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    if dictionary:
        dicts, dlens = _stage_dict_window(dictionary, dev)
        out, olens, errs = _decode_stream.decode_blocks_stream(
            comps, clens, out_cap, dicts, dlens, mode="full2v"
        )
    else:
        out, olens, errs = _decode.decode_blocks(comps, clens, out_cap)
    if int(errs[0]):
        # the error flag also fires for a well-formed block whose decoded
        # size exceeds the bucketed out_cap
        raise LZ4Error(
            f"malformed block, or decoded output exceeds the "
            f"{int(bound)}-byte bound (device decoder)"
        )
    olen = int(olens[0])
    if target_length is not None and olen != target_length:
        raise LZ4Error(f"decoded {olen} bytes, expected {target_length}")
    if target_length is None and olen > capacity:
        # `capacity` is a hard safety bound, not just an allocation hint
        raise LZ4Error(f"decoded {olen} bytes exceeds capacity {capacity}")
    return out[0, :olen].cpu().numpy().tobytes()


def _writable(dest):
    view = memoryview(dest).cast("B")
    if view.readonly:
        raise LZ4Error("destination buffer is read-only")
    return view


def encode_into(
    data,
    dest,
    level: int = 0,
    dictionary: bytes = b"",
    acceleration: int = 1,
    geometry: str = "canonical",
    device="cuda",
) -> int:
    """Compress one block into the writable buffer ``dest``: returns the
    bytes written, or minus the compressed length when ``dest`` is too
    small (the reference's negative-length convention)."""
    view = _writable(dest)
    comp = encode(data, level=level, dictionary=dictionary,
                  acceleration=acceleration, geometry=geometry, device=device)
    if len(comp) > len(view):
        return -len(comp)
    view[: len(comp)] = comp
    return len(comp)


def decode_into(data, dest, dictionary: bytes = b"", device="cuda") -> int:
    """Decompress one block into the writable buffer ``dest``, which bounds
    its output: returns the decoded length; raises LZ4Error on a malformed
    block or one that does not fit."""
    view = _writable(dest)
    raw = decode(data, dictionary=dictionary, capacity=len(view),
                 device=device)
    view[: len(raw)] = raw
    return len(raw)


def partial_decode(data, target_length: int, dictionary: bytes = b"",
                   device="cuda") -> bytes:
    """Decompress only the first ``target_length`` bytes of one block
    (reference `LZ4Codec.PartialDecode`) on ``device`` (the plain version
    when ``device="cpu"``): kernel A's one-warp route with an output limit,
    whatever the block's size.  What follows the limit is not parsed, so a
    block malformed past it decodes; one that ends first returns what it
    decoded."""
    dev = resolve_device(device)
    data = _as_bytes(data)
    target = int(target_length)
    if target < 0:
        raise ValueError("target_length must be >= 0")
    out_cap = bucket(max(target, 16))
    comps = _row(data, align1024(len(data) + 20), dev)
    clens = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    dicts = dlens = None
    if dictionary:
        dicts, dlens = _stage_dict_window(dictionary, dev)
    out, olens, errs = _decode.decode_blocks(
        comps, clens, out_cap, dicts, dlens, limits=[target])
    if int(errs[0]):
        raise LZ4Error("malformed block before the partial decode's limit "
                       "(device decoder)")
    return out[0, : int(olens[0])].cpu().numpy().tobytes()
