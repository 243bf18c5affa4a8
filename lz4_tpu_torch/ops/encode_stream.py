"""Batched LZ4 block encode at any block size and with dictionaries, at
every level: kernel D (`csrc/encode_stream.cu`) and its plain versions.

The port of `lz4_tpu/ops/encode_pallas_stream.py` (`pallas_encode_stream`,
wrapper `encode_blocks_pallas_stream`), with the same bytes.  At levels 0-2
(`encode_windows`, one warp per row) rows without a dictionary take the
canonical schedule (LZ4_compress_default: byU16 below 65,547 bytes, byU32
at and above) or the dense one; rows of a batch with dictionaries all take
the dense one.  Kernel B's FAST rows (`ops.encode.encode_blocks`) run on
the same launcher (`launch_fast`).
Levels 3-9 run the HC arm and 10-12 the OPT arm (`encode_windows_hc`, plain
versions in `ops/encode_hc.py`), every prefix inserted into the chain; on
the card levels 3-9 run as the three passes of `ops/encode_hc_passes.py`
and level 12 as those of `ops/encode_opt.py`.
The kernel reads each row as a window of one flat byte tensor, so the
chained-frame path (`parallel.blocks.encode_blocks_chained_device`) hands
it the payload itself, each block's 64 KB window in place before it.  The
kernel's source says what bounds it on the card and what its design does
about that.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import compress_bound
from .build import check, load
from .common import align1024
from .encode import (
    _encode_canonical, _encode_dense, _outputs, clip_acceleration, pack_rows,
)
from .encode_hc import encode_row, level_arm
from .encode_hc_passes import encode_windows_hc_passes
from .encode_opt import encode_windows_opt_passes

WINDOW = 65536  # the most a prefix can hold: LZ4's farthest match offset + 1

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("encode_stream")
        lib.lz4t_encode_stream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lz4t_encode_stream_hc.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lz4t_encode_stream_hc_slots.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.lz4t_encode_stream_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.lz4t_encode_stream_hc_shared_bytes.argtypes = [ctypes.c_int]
        for fn in (lib.lz4t_encode_stream, lib.lz4t_encode_stream_hc,
                   lib.lz4t_encode_stream_hc_slots,
                   lib.lz4t_encode_stream_shared_bytes,
                   lib.lz4t_encode_stream_hc_shared_bytes):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def shared_bytes(fast_schedule: str, level: int = 0,
                 longest: int = 2 * WINDOW) -> int:
    """Dynamic shared memory of one CTA of kernel D: a FAST geometry's
    largest table for windows of at most ``longest`` bytes (the dense
    table's entries are 16-bit up to 64 KB) or, at levels 3 and up, the HC
    or OPT arm's delta ring and price table."""
    arm = level_arm(level)[0]
    if arm != "fast":
        return _kernel().lz4t_encode_stream_hc_shared_bytes(int(arm == "opt"))
    return _kernel().lz4t_encode_stream_shared_bytes(
        int(fast_schedule == "dense"), longest
    )


def _validate_windows(base_u8, starts, src_offs, lens, bcap, level,
                      acceleration, fast_schedule):
    accel = clip_acceleration(acceleration, fast_schedule)
    base = torch.as_tensor(base_u8)
    if base.dtype != torch.uint8 or base.dim() != 1:
        raise ValueError("base_u8 must be a 1-D uint8 tensor")
    st = torch.as_tensor(starts, dtype=torch.int64).cpu()
    so = torch.as_tensor(src_offs, dtype=torch.int32).cpu()
    ln = torch.as_tensor(lens, dtype=torch.int32).cpu()
    if st.dim() != 1 or so.shape != st.shape or ln.shape != st.shape:
        raise ValueError("starts, src_offs and lens must hold one value per row")
    if st.numel():
        blk = ln - so
        if int(so.min()) < 0 or int(so.max()) > WINDOW:
            raise ValueError(f"src_offs must lie in [0, {WINDOW}]")
        if int(blk.min()) < 0 or int(blk.max()) > bcap:
            raise ValueError(f"block lengths must lie in [0, bcap={bcap}]")
        if int(st.min()) < 0 or int((st + ln).max()) > base.numel():
            raise ValueError("a window reaches outside base_u8")
        if (fast_schedule == "canonical" and level_arm(level)[0] == "fast"
                and bool(so.any())):
            raise ValueError(
                "the canonical schedule takes no prefix: FAST rows with a "
                "dictionary need fast_schedule='dense'"
            )
    dev = base.device
    longest = int(ln.max()) if ln.numel() else 0
    return base, st.to(dev), so.to(dev), ln.to(dev), accel, longest


def encode_windows_plain(base_u8, starts, src_offs, lens, bcap: int,
                         level: int = 0, acceleration: int = 1,
                         fast_schedule: str = "canonical"):
    """The plain PyTorch version of `encode_windows`: the same checks, the
    same outputs, one scalar parse per row on the host."""
    base, st, so, ln, accel, _ = _validate_windows(
        base_u8, starts, src_offs, lens, bcap, level, acceleration,
        fast_schedule,
    )
    raw = base.cpu().numpy()
    hc = level_arm(level)[0] != "fast"
    comps = []
    for a, off, n in zip(st.tolist(), so.tolist(), ln.tolist()):
        s = raw[a:a + n].tobytes()
        if hc:
            comps.append(encode_row(s, off, level))
        elif fast_schedule == "dense":
            comps.append(_encode_dense(s, accel, off))
        else:
            comps.append(_encode_canonical(s, accel))
    return pack_rows(comps, align1024(compress_bound(bcap)), base.device)


def encode_windows(base_u8, starts, src_offs, lens, bcap: int,
                   level: int = 0, acceleration: int = 1,
                   fast_schedule: str = "canonical"):
    """Encode B windows of one flat byte tensor with kernel D.

    Row r is base_u8[starts[r] : starts[r] + lens[r]]: its first
    src_offs[r] <= 65536 bytes are a prefix that matches may reach, the
    rest, at most ``bcap`` bytes, is the block.  Rows may overlap.  Levels
    0-2 run the FAST arm, where rows with a prefix need
    ``fast_schedule="dense"``; levels 3-9 the HC arm and 10 and up the OPT
    arm (`encode_windows_hc`, `encode_windows_opt`), at any geometry.

    Returns (out uint8 [B, OCAP], clens int32 [B], errs int32 [B]) on the
    input's device, OCAP = align1024(compress_bound(bcap)); errs is 1 where a
    row's output exceeds OCAP.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel, one warp per row (counted in
    `encode_blocks_stream.launches`).
    """
    arm = level_arm(level)[0]
    if arm != "fast":
        launch = encode_windows_opt if arm == "opt" else encode_windows_hc
        return launch(base_u8, starts, src_offs, lens, bcap, level)
    base, st, so, ln, accel, longest = _validate_windows(
        base_u8, starts, src_offs, lens, bcap, level, acceleration,
        fast_schedule,
    )
    if base.device.type != "cuda":
        return encode_windows_plain(
            base, st, so, ln, bcap, level, acceleration, fast_schedule
        )
    if st.shape[0] == 0:
        return _outputs(0, bcap, base.device)
    got = _launch_fast(base, st, so, ln, bcap, accel, fast_schedule, longest)
    encode_blocks_stream.launches += 1
    return got


def _launch_fast(base, st, so, ln, bcap, accel, fast_schedule, longest):
    """One launch of the FAST scan (`encode_windows` in
    `csrc/encode_stream.cu`) over checked windows on the card, the longest
    ``longest`` bytes; the caller counts it."""
    base = base.contiguous()
    nb = st.shape[0]
    out, clens, errs = _outputs(nb, bcap, base.device)
    lib = _kernel()
    with torch.cuda.device(base.device):
        rc = lib.lz4t_encode_stream(
            base.data_ptr(), st.data_ptr(), so.data_ptr(), ln.data_ptr(),
            out.data_ptr(), out.shape[1], out.shape[1], accel,
            int(fast_schedule == "dense"), longest, clens.data_ptr(), errs.data_ptr(),
            nb, torch.cuda.current_stream(base.device).cuda_stream,
        )
    check(rc, "encode_stream")
    return out, clens, errs


def launch_fast(base_u8, starts, src_offs, lens, bcap: int, accel: int,
                fast_schedule: str = "canonical"):
    """The FAST scan over a CUDA tensor's windows (no prefix on canonical
    rows), checked as `encode_windows` checks them: kernel B's launch
    (`ops.encode.encode_blocks`, which counts it)."""
    base, st, so, ln, accel, longest = _validate_windows(
        base_u8, starts, src_offs, lens, bcap, 0, accel, fast_schedule
    )
    return _launch_fast(base, st, so, ln, bcap, accel, fast_schedule, longest)


def _encode_windows_arm(base_u8, starts, src_offs, lens, bcap, level, arm,
                        passes=True):
    """Kernel D's HC or OPT arm (``arm``) on a batch of windows, levels 3-9
    as `encode_windows_hc_passes`' passes and 10 and up as
    `encode_windows_opt_passes`' unless ``passes`` is False; the plain
    version on the CPU."""
    if level_arm(level)[0] != arm:
        raise ValueError(f"level {level} does not run the {arm.upper()} arm")
    base, st, so, ln, _, _ = _validate_windows(
        base_u8, starts, src_offs, lens, bcap, level, 1, "dense"
    )
    if base.device.type != "cuda":
        return encode_windows_plain(base, st, so, ln, bcap, level)
    if passes:
        launch = encode_windows_hc_passes if arm == "hc" else encode_windows_opt_passes
        return launch(base, st, so, ln, bcap, level)
    _, depth, sufficient, full = level_arm(level)
    base = base.contiguous()
    nb, dev = st.shape[0], base.device
    out, clens, errs = _outputs(nb, bcap, dev)
    if nb == 0:
        return out, clens, errs
    lib = _kernel()
    opt = arm == "opt"
    with torch.cuda.device(dev):
        # the head tables of min(nb, resident CTAs) slots, 2^15 int32 (128
        # KB) each, and the row counter
        slots = ctypes.c_int(0)
        check(lib.lz4t_encode_stream_hc_slots(int(opt), ctypes.byref(slots)),
              "HC/OPT occupancy query")
        nslots = min(nb, slots.value)
        if nslots < 1:
            raise RuntimeError("the HC/OPT arm does not fit on this device")
        heads = torch.empty((nslots << 15,), dtype=torch.int32, device=dev)
        next_row = torch.zeros((1,), dtype=torch.int32, device=dev)
        rc = lib.lz4t_encode_stream_hc(
            base.data_ptr(), st.data_ptr(), so.data_ptr(), ln.data_ptr(),
            out.data_ptr(), out.shape[1], out.shape[1], int(opt), depth,
            sufficient, int(full), heads.data_ptr(), nslots,
            next_row.data_ptr(), clens.data_ptr(), errs.data_ptr(), nb,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, f"encode_stream {arm}")
    (encode_windows_opt if opt else encode_windows_hc).launches += 1
    return out, clens, errs


def encode_windows_hc(base_u8, starts, src_offs, lens, bcap: int,
                      level: int = 9):
    """`encode_windows` at levels 3-9: on a CUDA tensor the three passes of
    `encode_hc_passes.encode_windows_hc_passes` (counted there); a CPU
    tensor runs the plain version, the serial parse of
    `encode_hc.encode_hc`, which gives the passes' bytes (the tests
    compose the plain passes directly)."""
    return _encode_windows_arm(base_u8, starts, src_offs, lens, bcap, level, "hc")


def encode_windows_hc_serial(base_u8, starts, src_offs, lens, bcap: int,
                             level: int = 9):
    """Kernel D's serial HC arm at levels 3-9: the card's reference for the
    HC passes (one launch, counted in `encode_windows_hc.launches`); the
    plain version on a CPU tensor."""
    return _encode_windows_arm(base_u8, starts, src_offs, lens, bcap, level,
                               "hc", passes=False)


def encode_windows_opt(base_u8, starts, src_offs, lens, bcap: int,
                       level: int = 12):
    """`encode_windows` at levels 10 and up: on a CUDA tensor the three
    passes of `encode_opt.encode_windows_opt_passes` (counted there); a CPU
    tensor runs the plain version, the serial parse of
    `encode_hc.encode_opt`, which gives the passes' bytes (the plain match
    pass would make a Python search at every position, where the parse
    makes one at the positions it does not skip; the tests compose the
    plain passes directly)."""
    return _encode_windows_arm(base_u8, starts, src_offs, lens, bcap, level, "opt")


def encode_windows_opt_serial(base_u8, starts, src_offs, lens, bcap: int,
                              level: int = 12):
    """Kernel D's serial OPT arm at any level from 10: the card's reference
    for the OPT passes (one launch, counted in `encode_windows_opt.launches`);
    the plain version on a CPU tensor."""
    return _encode_windows_arm(base_u8, starts, src_offs, lens, bcap, level,
                               "opt", passes=False)


def _stage(bufs_u8, lens, bcap, dicts, dict_lens, fast_schedule):
    """A batch of rows, with optional right-aligned dictionaries, as the
    windows of one flat tensor: (base, starts, src_offs, lens, schedule)."""
    bufs = torch.as_tensor(bufs_u8)
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError("bufs_u8 must be a 2-D uint8 tensor")
    if bufs.shape[1] < bcap:
        raise ValueError(f"rows of {bufs.shape[1]} bytes < bcap {bcap}")
    nb, width = bufs.shape
    lens_t = torch.as_tensor(lens, dtype=torch.int32).cpu()
    if lens_t.shape != (nb,):
        raise ValueError("lens must hold one length per row")
    rows = torch.arange(nb, dtype=torch.int64)
    if dicts is None:
        return (bufs.contiguous().reshape(-1), rows * width,
                torch.zeros((nb,), dtype=torch.int32), lens_t, fast_schedule)
    dicts_t = torch.as_tensor(dicts).to(bufs.device)
    if dicts_t.dtype != torch.uint8 or dicts_t.dim() != 2 or dicts_t.shape[0] != nb:
        raise ValueError("dicts must be uint8 [B, DW], right-aligned")
    dw = dicts_t.shape[1]
    dl = torch.as_tensor(dict_lens, dtype=torch.int32).cpu()
    if dl.shape != (nb,):
        raise ValueError("dict_lens must hold one length per row")
    if nb and (int(dl.min()) < 0 or int(dl.max()) > dw):
        raise ValueError(f"dict_lens must lie in [0, {dw}]")
    dl = dl.clamp(max=WINDOW)  # only the last 64 KB is reachable
    # row k of [dicts | bufs]: its dictionary ends where its block starts
    flat = torch.cat([dicts_t, bufs], dim=1).reshape(-1)
    starts = rows * (dw + width) + dw - dl.to(torch.int64)
    return flat, starts, dl, dl + lens_t, "dense"


def encode_blocks_stream_plain(bufs_u8, lens, bcap: int, level: int = 0,
                               acceleration: int = 1, dicts=None,
                               dict_lens=None,
                               fast_schedule: str = "canonical"):
    """The plain PyTorch version of `encode_blocks_stream`."""
    clip_acceleration(acceleration, fast_schedule)
    base, st, so, ln, schedule = _stage(
        bufs_u8, lens, bcap, dicts, dict_lens, fast_schedule
    )
    return encode_windows_plain(
        base.cpu(), st, so, ln, bcap, level, acceleration, schedule
    )


def encode_blocks_stream(bufs_u8, lens, bcap: int, level: int = 0,
                         acceleration: int = 1, dicts=None, dict_lens=None,
                         fast_schedule: str = "canonical"):
    """Encode B independent blocks of at most ``bcap`` bytes, any size.

    bufs_u8: uint8 [B, CAP >= bcap], row b's bytes at [0, lens[b]).
    dicts: optional uint8 [B, DW], each row's preset dictionary
    right-aligned (its last dict_lens[b] bytes; only the last 64 KB is
    reachable).  Levels 0-2 run the FAST arm: "canonical" (byte-identical
    to LZ4_compress_default) or "dense" (the 15-bit finder); a batch with
    dictionaries runs the dense one, byte-identical to the host engines'
    ``encode(..., dictionary=...)``.  Levels 3-9 run the HC arm and 10 and
    up the OPT arm, with or without dictionaries.

    Returns (out uint8 [B, OCAP], clens int32 [B], errs int32 [B]) on the
    input's device, OCAP = align1024(compress_bound(bcap)).  A CPU tensor
    runs the plain version; a CUDA tensor launches kernel D once.
    """
    clip_acceleration(acceleration, fast_schedule)
    base, st, so, ln, schedule = _stage(
        bufs_u8, lens, bcap, dicts, dict_lens, fast_schedule
    )
    return encode_windows(
        base, st, so, ln, bcap, level, acceleration, schedule
    )


encode_blocks_stream.launches = 0
encode_windows_hc.launches = 0
encode_windows_opt.launches = 0
