"""xxHash32 (seed 0) of byte windows: kernel E (`csrc/xxh32.cu`) and its
plain versions.

The port of `lz4_tpu/ops/xxh32_pallas.py` (`pallas_xxh32`, wrapper
`xxh32_blocks`), with the same hashes.  The frame layer takes every block
and content checksum from here, over bytes that already lie on the device:
`xxh32_windows` hashes windows of one flat tensor (a batch's rows at
b * stride, a frame's blocks in place), on the caller's stream;
`xxh32_blocks` is the counterpart of the TPU wrapper, its rows as windows.
Both return the uint32 bits of each hash in an int32 tensor (`as_uint32`
reads them back as Python ints).

Content hashes run beside the caller's work: `xxh32_content` (a frame's
content as one window) and `stripes_update` (the content hash of a stream,
`lz4_tpu_torch.xxh32.XXH32.update` on a CUDA tensor, its accumulators and
carried tail kept on the device: kernel E's streaming form, a window's whole
stripes from four given accumulators) launch kernel E on the device's side
stream (`side_stream`, created on first use), after the work enqueued so
far on the caller's stream, and read nothing back; `ContentHash.value` and
`stripes_read` make the caller's stream wait for them.  On the CPU they run
the plain versions in the same order.  The kernel's source says what bounds
it on the card and what its design does about that.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import check, load

PRIME1 = 2654435761
PRIME2 = 2246822519
PRIME3 = 3266489917
PRIME4 = 668265263
PRIME5 = 374761393
_M32 = 0xFFFFFFFF
# stripes per Python-int pass over the last window standing
_ONE_CHUNK = 1 << 16
# the accumulators before the first stripe, seed 0
_SEEDED = ((PRIME1 + PRIME2) & _M32, PRIME2, 0, -PRIME1 & _M32)

_lib = None
_side: dict[int, "torch.cuda.Stream"] = {}


def _kernel():
    global _lib
    if _lib is None:
        lib = load("xxh32")
        lib.lz4t_xxh32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lz4t_xxh32_stripes.argtypes = list(lib.lz4t_xxh32.argtypes)
        lib.lz4t_xxh32.restype = ctypes.c_int
        lib.lz4t_xxh32_stripes.restype = ctypes.c_int
        _lib = lib
    return _lib


def side_stream(device) -> "torch.cuda.Stream":
    """The stream kernel E's content hashes run on, one per device, created
    on first use."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = _side.get(index)
    if stream is None:
        stream = _side[index] = torch.cuda.Stream(index)
    return stream


def _launch(entry: str, flat, starts, lens, out, nwin: int, stream) -> None:
    """One launch of a C entry point of `csrc/xxh32.cu` on ``stream``;
    raises if it was refused."""
    with torch.cuda.device(flat.device):
        rc = getattr(_kernel(), entry)(
            flat.data_ptr(), starts.data_ptr(), lens.data_ptr(), out.data_ptr(), nwin,
            stream.cuda_stream)
    check(rc, entry)


def as_uint32(hashes) -> list[int]:
    """The hashes of an int32 tensor of uint32 bits, as Python ints."""
    return [h & _M32 for h in torch.as_tensor(hashes).tolist()]


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _stripes_one(words: list[int], accs) -> tuple[int, int, int, int]:
    """One window's stripes (a flat list of LE words, four per stripe) in
    Python ints: the chain is sequential, and ints beat numpy calls here."""
    a0, a1, a2, a3 = accs
    it = iter(words)
    for w0, w1, w2, w3 in zip(it, it, it, it):
        a0 = _rotl((a0 + w0 * PRIME2) & _M32, 13) * PRIME1 & _M32
        a1 = _rotl((a1 + w1 * PRIME2) & _M32, 13) * PRIME1 & _M32
        a2 = _rotl((a2 + w2 * PRIME2) & _M32, 13) * PRIME1 & _M32
        a3 = _rotl((a3 + w3 * PRIME2) & _M32, 13) * PRIME1 & _M32
    return a0, a1, a2, a3


def _finish(accs, n: int, tail: bytes) -> int:
    """The merge, ``+ n``, the 4-byte and 1-byte tails and the avalanche."""
    if n >= 16:
        a0, a1, a2, a3 = accs
        acc = (_rotl(a0, 1) + _rotl(a1, 7) + _rotl(a2, 12) + _rotl(a3, 18)) & _M32
    else:
        acc = PRIME5
    acc = (acc + n) & _M32
    i = 0
    while i + 4 <= len(tail):
        lane = int.from_bytes(tail[i:i + 4], "little")
        acc = _rotl((acc + lane * PRIME3) & _M32, 17) * PRIME4 & _M32
        i += 4
    for b in tail[i:]:
        acc = _rotl((acc + b * PRIME5) & _M32, 11) * PRIME1 & _M32
    acc ^= acc >> 15
    acc = acc * PRIME2 & _M32
    acc ^= acc >> 13
    acc = acc * PRIME3 & _M32
    return acc ^ (acc >> 16)


def _validate_windows(flat_u8, starts, lens):
    flat = torch.as_tensor(flat_u8)
    if flat.dtype != torch.uint8 or flat.dim() != 1:
        raise ValueError("flat_u8 must be a 1-D uint8 tensor")
    st = torch.as_tensor(starts, dtype=torch.int64).cpu()
    ln = torch.as_tensor(lens, dtype=torch.int32).cpu()
    if st.dim() != 1 or ln.shape != st.shape:
        raise ValueError("starts and lens must hold one value per window")
    if st.numel():
        if int(ln.min()) < 0:
            raise ValueError("window lengths must be >= 0")
        if int(st.min()) < 0 or int((st + ln).max()) > flat.numel():
            raise ValueError("a window reaches outside flat_u8")
    return flat, st, ln


def xxh32_windows_plain(flat_u8, starts, lens):
    """The plain PyTorch version of `xxh32_windows`: the same checks and
    hashes.  The stripes run in numpy over all windows that still have one
    at once; the last window standing finishes its chain in Python ints."""
    flat, st, ln = _validate_windows(flat_u8, starts, lens)
    raw = flat.cpu().numpy()
    starts_l, lens_l = st.tolist(), ln.tolist()
    nst = np.asarray([n // 16 for n in lens_l], np.int64)
    order = np.argsort(-nst, kind="stable")
    # every window's stripes, longest window first: [sum(nst), 4] LE words
    offs = np.concatenate([[0], np.cumsum(nst[order])])
    words = np.concatenate(
        [raw[starts_l[b]:starts_l[b] + 16 * int(nst[b])] for b in order]
        + [np.zeros(0, np.uint8)]
    ).view("<u4").reshape(-1, 4)
    accs = np.tile(np.asarray(_SEEDED, np.uint32), (len(order), 1))
    k, active = 0, int((nst > 0).sum())
    while active > 1:
        rows = offs[:active] + k
        a = accs[:active] + words[rows] * np.uint32(PRIME2)
        a = (a << np.uint32(13)) | (a >> np.uint32(19))
        accs[:active] = a * np.uint32(PRIME1)
        k += 1
        while active and nst[order[active - 1]] <= k:
            active -= 1
    if active == 1:
        a = accs[0].tolist()
        for c in range(offs[0] + k, offs[1], _ONE_CHUNK):
            a = _stripes_one(words[c:min(c + _ONE_CHUNK, offs[1])].ravel().tolist(), a)
        accs[0] = a
    hashes = np.zeros(len(order), np.uint32)
    for i, b in enumerate(order.tolist()):
        a, n = starts_l[b], lens_l[b]
        tail = raw[a + 16 * (n // 16):a + n].tobytes()
        hashes[b] = _finish(accs[i].tolist(), n, tail)
    return torch.from_numpy(hashes.view(np.int32)).to(flat.device)


def xxh32_windows(flat_u8, starts, lens):
    """xxHash32 (seed 0) of B windows of one flat byte tensor.

    Window w is flat_u8[starts[w] : starts[w] + lens[w]] (starts int64,
    lens int32; windows may overlap and start at any byte).  Returns int32
    [B] on the input's device: each hash's uint32 bits.  A CPU tensor runs
    the plain version; a CUDA tensor launches kernel E once (counted in
    `xxh32_windows.launches`)."""
    flat, st, ln = _validate_windows(flat_u8, starts, lens)
    if flat.device.type != "cuda":
        return xxh32_windows_plain(flat, st, ln)
    flat = flat.contiguous()
    dev = flat.device
    nw = st.numel()
    out = torch.empty((nw,), dtype=torch.int32, device=dev)
    if nw == 0:
        return out
    _launch("lz4t_xxh32", flat, st.to(dev), ln.to(dev), out, nw,
            torch.cuda.current_stream(dev))
    xxh32_windows.launches += 1
    return out


class ContentHash:
    """A content hash launched by `xxh32_content`: `value()` gives it."""

    __slots__ = ("_out", "_done")

    def __init__(self, out, done=None):
        self._out = out
        self._done = done  # the side stream's event after the launch

    def value(self) -> int:
        """The hash as a uint32: on the card the caller's stream waits for
        the launch, then reads its result."""
        if self._done is not None:
            torch.cuda.current_stream(self._out.device).wait_event(self._done)
        return as_uint32(self._out)[0]


def xxh32_content(flat_u8) -> ContentHash:
    """xxHash32 (seed 0) of the whole of flat_u8 (a 1-D uint8 tensor).  A
    CUDA tensor launches kernel E once on its device's side stream, after
    the work enqueued so far on the caller's stream, and returns at once
    (counted in `xxh32_windows.launches`; the tensor recorded on the side
    stream); a CPU tensor runs the plain version."""
    flat = torch.as_tensor(flat_u8)
    if flat.dtype != torch.uint8 or flat.dim() != 1:
        raise ValueError("flat_u8 must be a 1-D uint8 tensor")
    n = flat.numel()
    if n >= 1 << 31:  # the kernel's lengths are int32
        raise ValueError("a content hash takes fewer than 2^31 bytes")
    if flat.device.type != "cuda":
        return ContentHash(xxh32_windows_plain(flat, [0], [n]))
    flat = flat.contiguous()
    dev = flat.device
    side = side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        flat.record_stream(side)
        out = torch.empty((1,), dtype=torch.int32, device=dev)
        _launch("lz4t_xxh32", flat, torch.zeros((1,), dtype=torch.int64, device=dev),
                torch.full((1,), n, dtype=torch.int32, device=dev), out, 1, side)
        xxh32_windows.launches += 1
        done = side.record_event()
    return ContentHash(out, done)


def _rows(bufs_u8, lens):
    """A batch of rows as windows of one flat tensor: (flat, starts, lens)."""
    bufs = torch.as_tensor(bufs_u8)
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError("bufs_u8 must be a 2-D uint8 tensor")
    nb, cap = bufs.shape
    ln = torch.as_tensor(lens, dtype=torch.int32).cpu()
    if ln.shape != (nb,):
        raise ValueError("lens must hold one length per row")
    if nb and (int(ln.min()) < 0 or int(ln.max()) > cap):
        raise ValueError(f"lens must lie in [0, CAP={cap}]")
    starts = torch.arange(nb, dtype=torch.int64) * cap
    return bufs.contiguous().reshape(-1), starts, ln


def xxh32_blocks_plain(bufs_u8, lens):
    """The plain PyTorch version of `xxh32_blocks`."""
    return xxh32_windows_plain(*_rows(bufs_u8, lens))


def xxh32_blocks(bufs_u8, lens):
    """xxHash32 (seed 0) of the first lens[b] bytes of each row of bufs_u8
    (uint8 [B, CAP]), as `pallas_xxh32`; its rows are windows of kernel E.
    Returns int32 [B] of uint32 bits on the input's device."""
    return xxh32_windows(*_rows(bufs_u8, lens))


# the most bytes one launch of the streaming form takes (its lengths are
# int32); a longer update takes one launch per piece
STRIPES_MAX = 1 << 30


def _validate_stripes(flat_u8, start, nbytes, accs):
    flat, st, ln = _validate_windows(flat_u8, [start], [nbytes])
    if int(ln[0]) > STRIPES_MAX:
        raise ValueError(f"nbytes must be at most {STRIPES_MAX}")
    acc = torch.as_tensor(accs, dtype=torch.int64).cpu()
    if acc.shape != (4,):
        raise ValueError("accs must hold four accumulators")
    return flat, int(st[0]), int(ln[0]), [a & _M32 for a in acc.tolist()]


def _as_int32(values) -> list[int]:
    """uint32 values as the int32 values of the same bits."""
    return [v - (1 << 32) if v >= 1 << 31 else v for v in values]


def xxh32_stripes_plain(flat_u8, start, nbytes, accs):
    """The plain PyTorch version of kernel E's streaming form: the four
    xxHash32 accumulators ``accs`` (uint32 values) after the whole 16-byte
    stripes of flat_u8[start : start + nbytes], the stripes in Python ints
    (`_stripes_one`); the bytes after the last whole stripe are left to the
    caller.  Returns int32 [4] of uint32 bits on the input's device."""
    flat, a, n, acc = _validate_stripes(flat_u8, start, nbytes, accs)
    raw = flat[a:a + n // 16 * 16].cpu().numpy()
    for c in range(0, raw.size // 16, _ONE_CHUNK):
        words = raw[16 * c:16 * (c + _ONE_CHUNK)].view("<u4").tolist()
        acc = _stripes_one(words, acc)
    return torch.tensor(_as_int32(acc), dtype=torch.int32).to(flat.device)


def stripes_state(accs, tail: bytes, device):
    """A stream's content-hash state on ``device``: the four accumulators
    (uint32 values) as an int32 tensor of their bits, and the bytes after
    the last whole stripe (fewer than 16) as a uint8 tensor; on the card
    made on the side stream, which `stripes_update` runs on."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (torch.tensor(_as_int32(accs), dtype=torch.int32),
                torch.tensor(list(tail), dtype=torch.uint8))
    with torch.cuda.stream(side_stream(dev)):
        return (torch.tensor(_as_int32(accs), dtype=torch.int32, device=dev),
                torch.tensor(list(tail), dtype=torch.uint8, device=dev))


def _validate_update(accs, tail, flat):
    if flat.dtype != torch.uint8 or flat.dim() != 1:
        raise ValueError("flat must be a 1-D uint8 tensor")
    if accs.dtype != torch.int32 or accs.shape != (4,):
        raise ValueError("accs must hold four accumulators in an int32 tensor")
    if tail.dtype != torch.uint8 or tail.dim() != 1 or tail.numel() >= 16:
        raise ValueError("tail must be a 1-D uint8 tensor of fewer than 16 bytes")
    if accs.device != flat.device or tail.device != flat.device:
        raise ValueError("accs, tail and flat must lie on one device")


def stripes_update(accs, tail, flat):
    """A stream's content hash after the 1-D uint8 tensor ``flat``: the
    accumulators ``accs`` (int32 [4], updated in place) and ``tail`` (the
    bytes after the last whole stripe), both on flat's device, become those
    after the bytes tail | flat.  Returns (accs, the new tail).  A CUDA
    tensor: every step on the side stream after the work enqueued so far
    on the caller's stream, the streaming form of kernel E once per
    `STRIPES_MAX` bytes (counted in `stripes_update.launches`), nothing read
    back; a CPU tensor: the plain version, in the same order."""
    _validate_update(accs, tail, flat)
    dev = flat.device
    if dev.type != "cuda":
        data = torch.cat([tail, flat]) if tail.numel() else flat
        whole = data.numel() // 16 * 16
        for a in range(0, whole, STRIPES_MAX):
            accs.copy_(xxh32_stripes_plain(data, a, min(STRIPES_MAX, whole - a), accs))
        return accs, data[whole:].clone()
    side = side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        flat.record_stream(side)
        data = torch.cat([tail, flat]) if tail.numel() else flat.contiguous()
        whole = data.numel() // 16 * 16
        for a in range(0, whole, STRIPES_MAX):
            n = min(STRIPES_MAX, whole - a)
            _launch("lz4t_xxh32_stripes", data,
                    torch.full((1,), a, dtype=torch.int64, device=dev),
                    torch.full((1,), n, dtype=torch.int32, device=dev), accs, 1, side)
            stripes_update.launches += 1
        return accs, data[whole:].clone()


def stripes_read(accs, tail):
    """A stream's content-hash state read back once: (the four
    accumulators as uint32 values, the tail's bytes); on the card after the
    side stream's updates."""
    if accs.device.type == "cuda":
        torch.cuda.current_stream(accs.device).wait_stream(side_stream(accs.device))
    return as_uint32(accs), tail.cpu().numpy().tobytes()


xxh32_windows.launches = 0
stripes_update.launches = 0
