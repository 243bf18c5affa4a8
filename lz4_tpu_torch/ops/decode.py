"""Batched LZ4 block decode: kernel A (`csrc/decode.cu`) and its plain
version.

The port of `lz4_tpu/ops/decode_pallas6.py` (`pallas_decode6`, wrapper
`decode_blocks_pallas6`), with the same outputs.  The kernel's source
says what bounds it on the card and what its design does about that.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check, load

MIN_MATCH = 4
DICT_CAP = 65536
MODES = ("full", "full2", "full2v")

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("decode")
        lib.lz4t_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lz4t_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def _decode_row(src: bytes, clen: int, out_cap: int, window: bytes):
    """One row, byte for byte as the kernel decodes it.  Returns
    (decoded bytes, err); on error the bytes stop where the failing
    sequence began."""
    dlen = len(window)
    buf = bytearray(window)
    cap = dlen + out_cap
    ip, err = 0, 0
    while True:
        if ip >= clen:
            err = 1
            break
        token = src[ip]
        q = ip + 1
        ll = token >> 4
        if ll == 15:
            b = 255
            while b == 255 and q < clen:
                b = src[q]
                q += 1
                ll += b
        op = len(buf)
        if q + ll > clen or op + ll > cap:
            err = 1
            break
        lit_at = q
        q += ll
        if q >= clen:  # the last sequence: literals only
            buf += src[lit_at:q]
            ip = q
            break
        if q + 2 > clen:
            err = 1
            break
        off = src[q] | (src[q + 1] << 8)
        q += 2
        ml = (token & 15) + MIN_MATCH
        if (token & 15) == 15:
            b = 255
            while b == 255 and q < clen:
                b = src[q]
                q += 1
                ml += b
        # buf holds the window first, so op already counts dlen
        if off == 0 or off > op + ll or op + ll + ml > cap:
            err = 1
            break
        buf += src[lit_at:lit_at + ll]
        base = len(buf) - off
        if off >= ml:
            buf += buf[base:base + ml]
        else:
            buf += (buf[base:] * (ml // off + 1))[:ml]
        ip = q
    if err == 0 and ip != clen:
        err = 2
    return bytes(buf[dlen:]), err


def decode_blocks_plain(comps_u8, comp_lens, out_cap: int, dicts_u8=None,
                        dict_lens=None, mode: str = "full2"):
    """The plain PyTorch version of `decode_blocks`: the same checks, the
    same outputs, one scalar parse per row on the host."""
    comps, clens, dicts, dls = _validate(
        comps_u8, comp_lens, out_cap, dicts_u8, dict_lens, mode
    )
    nb = comps.shape[0]
    out = torch.zeros((nb, out_cap), dtype=torch.uint8)
    lens = torch.zeros((nb,), dtype=torch.int32)
    errs = torch.zeros((nb,), dtype=torch.int32)
    rows = comps.cpu()
    windows = dicts.cpu() if dicts is not None else None
    clen_list = clens.tolist()
    dl_list = dls.tolist() if dls is not None else [0] * nb
    for b in range(nb):
        clen = clen_list[b]
        src = bytes(rows[b, : max(clen, 0)].tolist())
        window = b""
        if dl_list[b]:
            window = bytes(windows[b, DICT_CAP - dl_list[b]:].tolist())
        data, err = _decode_row(src, clen, out_cap, window)
        if data:
            out[b, : len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        lens[b] = len(data)
        errs[b] = err
    dev = comps.device
    return out.to(dev), lens.to(dev), errs.to(dev)


def _validate(comps_u8, comp_lens, out_cap, dicts_u8, dict_lens, mode):
    if mode not in MODES:
        raise ValueError(
            f"unknown decode mode {mode!r}; expected one of {MODES}"
        )
    comps = torch.as_tensor(comps_u8)
    if comps.dtype != torch.uint8 or comps.dim() != 2:
        raise ValueError("comps_u8 must be a 2-D uint8 tensor")
    dev = comps.device
    clens = torch.as_tensor(comp_lens, dtype=torch.int32, device=dev).contiguous()
    if clens.shape != (comps.shape[0],):
        raise ValueError("comp_lens must hold one length per row")
    if clens.numel() and int(clens.max()) + 20 > comps.shape[1]:
        # API contract of the TPU kernel, whose parse reads speculatively
        # up to ~clen + 16; this kernel reads exactly, but keeps the check
        raise ValueError(
            "compressed rows need >= 20 bytes of padding past the "
            "largest comp_len (stage at comp_capacity(out_cap))"
        )
    if out_cap < 0:
        raise ValueError("out_cap must be >= 0")
    dicts = dls = None
    if dicts_u8 is not None:
        dicts = torch.as_tensor(dicts_u8, device=dev)
        if dicts.dtype != torch.uint8 or dicts.shape != (comps.shape[0], DICT_CAP):
            raise ValueError("dicts_u8 must be uint8 [B, 65536], right-aligned")
        dls = torch.as_tensor(dict_lens, dtype=torch.int32, device=dev).contiguous()
        if dls.shape != clens.shape:
            raise ValueError("dict_lens must hold one length per row")
        if dls.numel() and (int(dls.min()) < 0 or int(dls.max()) > DICT_CAP):
            raise ValueError("dict_lens must lie in [0, 65536]")
    return comps, clens, dicts, dls


def decode_blocks(comps_u8, comp_lens, out_cap: int, dicts_u8=None,
                  dict_lens=None, mode: str = "full2"):
    """Decode B independent LZ4 blocks.

    comps_u8: uint8 [B, CAP], row b's compressed bytes at [0, comp_lens[b])
    with >= 20 bytes of padding past the largest length.  dicts_u8: optional
    uint8 [B, 65536] right-aligned dictionaries of dict_lens[b] bytes.
    ``mode`` is one of "full", "full2", "full2v": the TPU kernel's fast-arm
    variants, which give the same bytes; here they all run the same kernel.

    Returns (out uint8 [B, out_cap], lens int32 [B], errs int32 [B]) on the
    input's device: errs is 0, 1 (malformed) or 2 (trailing garbage).  A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    comps, clens, dicts, dls = _validate(
        comps_u8, comp_lens, out_cap, dicts_u8, dict_lens, mode
    )
    if comps.device.type != "cuda":
        return decode_blocks_plain(comps, clens, out_cap, dicts, dls, mode)
    comps = comps.contiguous()
    nb = comps.shape[0]
    dev = comps.device
    out = torch.zeros((nb, out_cap), dtype=torch.uint8, device=dev)
    lens = torch.empty((nb,), dtype=torch.int32, device=dev)
    errs = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return out, lens, errs
    if dicts is not None:
        dicts = dicts.contiguous()
    lib = _kernel()
    with torch.cuda.device(dev):
        rc = lib.lz4t_decode(
            comps.data_ptr(), comps.stride(0), clens.data_ptr(),
            out.data_ptr(), out_cap,
            dicts.data_ptr() if dicts is not None else None,
            dls.data_ptr() if dls is not None else None,
            lens.data_ptr(), errs.data_ptr(), nb,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, "decode")
    decode_blocks.launches += 1
    return out, lens, errs


decode_blocks.launches = 0
