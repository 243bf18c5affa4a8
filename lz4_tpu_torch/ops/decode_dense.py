"""X2: the dense LZ4 block decoder, as PyTorch tensor ops over rows.

The port of `lz4_tpu/ops/decode_jax.py`, which the JAX package runs on
CPU meshes, on every `mesh=` path and for a `block.decode` without an
output bound.  It decodes with no sequential scan:

1. a speculative parse at every input position (literal length, offset,
   match length and the next token's position), the length extensions
   resolved by one reverse cumulative minimum over the next byte that is
   not 255;
2. the true token chain, the orbit of 0 by binary lifting (`chain.py`);
3. each output byte's source by boundary markers and one prefix sum;
4. match chains resolved by pointer doubling, until no row has a byte left
   that points into the output.

Every function works on a batch of rows ([B, CAP]) where the JAX package
works on one row under `vmap`; the doubling loop runs while any row has
work, and rows that are done stay as they are, as the vmapped
`while_loop` leaves them.  The same code runs on the CPU and on the card.
Out bytes, lengths and error counts equal the JAX function's.
"""

from __future__ import annotations

import torch

from ..block import LZ4Error
from ..constants import MIN_MATCH
from .chain import materialize_chain
from .common import (
    bucket,
    ceil_log2,
    exclusive_cumsum,
    gather,
    next_not_equal,
    resolve_device,
    shift_left,
    word_le,
)

_PAD = 8  # trailing zero pad so speculative parses never read past a row


def _isum(x: torch.Tensor) -> torch.Tensor:
    """Row sums in int32 (JAX's sum of int32 stays int32), kept as [B, 1]."""
    return x.sum(dim=-1, keepdim=True, dtype=torch.int32)


def _parse_and_decode(comp, comp_len, dictionary, dict_len, out_cap: int):
    """comp: int32 [B, CAP] (zero padded); comp_len, dict_len: int32 [B];
    dictionary: int32 [B, DCAP], right-aligned (a row's dictionary bytes
    are its last dict_len).  Returns (out uint8 [B, out_cap], out_len int32
    [B], err int32 [B])."""
    rows, cap = comp.shape
    dcap = dictionary.shape[1]
    dev = comp.device
    comp_len = comp_len.to(torch.int32).view(rows, 1)
    dict_len = dict_len.to(torch.int32).view(rows, 1)
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    b = comp

    # ---- phase 1: speculative per-position parse -------------------------
    # the length extension's state packed into one array: the distance to
    # the next byte that is not 255, and that byte
    nn255 = next_not_equal(b != 255, idx, cap - 1)
    pk = ((nn255 - idx) << 8) | gather(b, nn255)

    def unpack_ext(pk_v):
        delta = pk_v >> 8
        return 255 * delta + (pk_v & 0xFF), delta + 1  # (value, bytes)

    w = word_le(b)
    ll_nib = b >> 4
    ml_nib = b & 15
    has_ll_ext = ll_nib == 15
    ev1, eb1 = unpack_ext(shift_left(pk, 1))
    ll = torch.where(has_ll_ext, 15 + ev1, ll_nib)
    llb = torch.where(has_ll_ext, eb1, 0)
    lit_start = idx + 1 + llb
    lit_end = lit_start + ll  # position of the offset field
    is_last = lit_end >= comp_len
    off = gather(w, lit_end) & 0xFFFF
    has_ml_ext = ml_nib == 15
    ev2, eb2 = unpack_ext(gather(pk, lit_end + 2))
    ml = torch.where(has_ml_ext, MIN_MATCH + 15 + ev2, ml_nib + MIN_MATCH)
    mlb = torch.where(has_ml_ext, eb2, 0)
    ml = torch.where(is_last, 0, ml)

    dead = cap - 1
    nxt = lit_end + 2 + mlb
    nxt = torch.where(is_last, dead, nxt.clamp(max=dead))
    nxt = torch.maximum(nxt, idx + 1)  # strict progress
    nxt[:, dead] = dead

    # ---- phase 2: the true token chain -----------------------------------
    # every sequence takes at least 3 input bytes (token and offset)
    p_tab = materialize_chain(nxt, cap // 3 + 2)
    valid = p_tab < comp_len

    ps = torch.where(valid, p_tab, 0)
    ll_s = torch.where(valid, gather(ll, ps), 0)
    ml_s = torch.where(valid, gather(ml, ps), 0)
    off_s = torch.where(valid, gather(off, ps), 1)
    lit_start_s = torch.where(valid, gather(lit_start, ps), 0)
    lit_end_s = torch.where(valid, gather(lit_end, ps), 0)
    is_last_s = valid & gather(is_last.to(torch.uint8), ps).bool()

    contrib = ll_s + ml_s
    out_start_s = exclusive_cumsum(contrib)
    out_len = _isum(contrib)

    # ---- error detection (safe decode) -----------------------------------
    match_at = out_start_s + ll_s
    bad = valid & ~is_last_s & (
        (off_s == 0)
        | (off_s > match_at + dict_len)  # window underflow
        | (lit_end_s > comp_len)  # literal run past the end of the input
    )
    bad_last = is_last_s & (lit_end_s != comp_len)
    has_term = is_last_s.any(dim=-1, keepdim=True)
    err = (
        _isum(bad.to(torch.int32))
        + _isum(bad_last.to(torch.int32))
        + (out_len > out_cap).to(torch.int32)
        + (comp_len <= 0).to(torch.int32)
        + (~has_term).to(torch.int32)
    )

    # ---- phase 3: each output byte's source ------------------------------
    big = out_cap + 1
    bnd = torch.stack(
        [torch.where(valid, out_start_s, big), torch.where(valid, match_at, big)],
        dim=-1,
    ).reshape(rows, -1)  # non-decreasing
    bases = torch.stack(
        [out_cap + lit_start_s - out_start_s, -off_s], dim=-1
    ).reshape(rows, -1)

    # JAX's `.at[i].add(1, mode="drop")`: a negative index counts from the
    # end, and an index still outside [0, out_cap] is dropped, here into a
    # spare column
    at = bnd.clamp(max=out_cap + 1)
    at = torch.where(at < 0, at + (out_cap + 1), at)
    at = torch.where((at < 0) | (at > out_cap), out_cap + 1, at)
    marker = torch.zeros((rows, out_cap + 2), dtype=torch.int32, device=dev)
    marker.scatter_add_(1, at.long(), torch.ones_like(at))
    sid = torch.cumsum(marker[:, :out_cap + 1], dim=-1, dtype=torch.int32)[:, :out_cap]

    j = torch.arange(out_cap, dtype=torch.int32, device=dev)
    src_map = gather(bases, torch.clamp(sid - 1, min=0)) + j

    # ---- phase 4: resolve match chains by pointer doubling ---------------
    max_rounds = ceil_log2(out_cap) + 1
    for _ in range(max_rounds):
        inside = (src_map >= 0) & (src_map < out_cap)
        if not bool(inside.any()):
            break
        src_map = torch.where(inside, gather(src_map, src_map), src_map)

    # negative: a dictionary byte; >= out_cap: a literal byte of the input
    err = err + _isum(((j < out_len) & (src_map + dict_len < 0)).to(torch.int32))
    from_dict = src_map < 0
    lit = gather(comp, src_map - out_cap)
    if dcap > 0:
        from_d = gather(dictionary, dcap + src_map)
    else:
        from_d = torch.zeros_like(src_map)
    out = torch.where(from_dict, from_d, lit)
    return out.to(torch.uint8), out_len.view(rows), err.view(rows)


def decode_block_fixed(comp_u8, comp_len, dict_u8, dict_len, out_cap: int):
    """Decode rows of one fixed shape on their device.

    comp_u8: uint8 [B, CAP], zero-padded (CAP >= comp_len + 8); comp_len:
    int32 [B]; dict_u8: uint8 [B, DCAP], right-aligned (DCAP may be 0);
    dict_len: int32 [B].  Returns (out uint8 [B, out_cap], out_len int32
    [B], err int32 [B]), err 0 where a row decoded cleanly.  Counted in
    ``decode_block_fixed.launches``, once a call."""
    decode_block_fixed.launches += 1
    return _parse_and_decode(comp_u8.to(torch.int32), comp_len,
                             dict_u8.to(torch.int32), dict_len, out_cap)


decode_block_fixed.launches = 0


def decode_block_bytes(
    data: bytes,
    target_length: int | None = None,
    dictionary: bytes = b"",
    capacity: int | None = None,
    device="cuda",
) -> bytes:
    """Decode one block on ``device`` (the JAX package's
    `decode_jax.decode_block_bytes`): the output bounded by
    ``target_length`` or ``capacity``, or with neither, tried at caps of
    4, 32 and 255 times the block's length in turn, until one decodes
    cleanly.  Raises LZ4Error on a malformed block."""
    dev = resolve_device(device)
    n = len(data)
    if n == 0:
        raise LZ4Error("empty input")
    cap = bucket(n + _PAD)
    comp = torch.zeros((1, cap), dtype=torch.uint8)
    comp[0, :n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    if target_length is not None:
        caps = [bucket(max(64, target_length))]
    elif capacity is not None:
        caps = [bucket(max(64, capacity))]
    else:
        # grow toward the worst case (~255x) only on failure, so that an
        # unhinted 1 MB block does not allocate ~256 MB up front
        caps = sorted({bucket(max(64, n * f)) for f in (4, 32, 255)})
    dlen = min(len(dictionary), 65536)
    dcap = bucket(dlen, floor=1 << 8) if dlen else 1 << 8
    d = torch.zeros((1, dcap), dtype=torch.uint8)
    if dlen:
        d[0, dcap - dlen:] = torch.frombuffer(
            bytearray(dictionary[-dlen:]), dtype=torch.uint8)
    comp, d = comp.to(dev), d.to(dev)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    dlens = torch.tensor([dlen], dtype=torch.int32, device=dev)
    for out_cap in caps:
        out, out_len, err = decode_block_fixed(comp, lens, d, dlens, out_cap)
        err, out_len = int(err[0]), int(out_len[0])
        if not err:
            break
    if err:
        raise LZ4Error(f"malformed LZ4 block (err={err})")
    if target_length is not None and out_len != target_length:
        raise LZ4Error(f"decoded length {out_len} != expected {target_length}")
    return out[0, :out_len].cpu().numpy().tobytes()
