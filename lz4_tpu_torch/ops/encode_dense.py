"""X1: the dense greedy LZ4 block encoder, as PyTorch tensor ops over rows.

The port of `lz4_tpu/ops/encode_jax.py`, which the JAX package runs on CPU
meshes and on every `mesh=` path.  It parses greedily with no sequential
scan:

1. match candidates: the 4-byte word at every position, grouped by one
   stable sort; a position's candidates are the nearest earlier positions
   with the same word (K of them at the HC levels);
2. match lengths: exact for offsets of at most 8 from one reverse
   cumulative minimum per period, a 68-byte word compare for the others,
   and a masked loop, 64 bytes a round, for the rare longer ones;
3. the greedy parse: the anchors are the orbit of 0 under "next match at
   or after the anchor, then past it", by binary lifting (`chain.py`);
4. emission: each sequence's output offset by a prefix sum, and each
   output byte's value from its sequence, found by `searchsorted`.

Every function works on a batch of rows where the JAX package works on one
row under `vmap`; the extension loop runs while any row has a live match,
and rows that are done stay as they are.  The same code runs on the CPU
and on the card.  Its bytes are the JAX function's, not liblz4's.
"""

from __future__ import annotations

import torch

from ..constants import LAST_LITERALS, MF_LIMIT, MIN_MATCH, compress_bound
from .chain import materialize_chain
from .common import align1024, bucket, gather, resolve_device, reverse_cummin, word_le

_PAD_TAIL = 1024  # the word compares read up to ~72 bytes past a position
_STATIC_SCAN_WORDS = 16  # 4 + 16 * 4 = 68 bytes without the loop
_ANALYTIC_MAX_OFF = 8  # exact lengths for periodic offsets 1..8


def _vle_extra_bytes(v):
    """Number of length-extension bytes for the value v = len - 15."""
    return torch.div(v, 255, rounding_mode="floor") + 1


def _compare_step(wp, wc, ml, alive):
    """One 4-byte compare of the words at each live match's end: ml grows
    by 4 where they are equal, else by the equal low bytes of the first
    that differs (little-endian), and that match dies."""
    eq = wp == wc
    x = wp ^ wc
    extra = (
        ((x & 0xFF) == 0).to(torch.int32)
        + ((x & 0xFFFF) == 0).to(torch.int32)
        + ((x & 0xFFFFFF) == 0).to(torch.int32)
    )
    ml = ml + (alive & eq).to(torch.int32) * 4 + (alive & ~eq).to(torch.int32) * extra
    return ml, alive & eq


def _match_lengths_static(w, p, c, alive_mask):
    """Matched length from MIN_MATCH, compared 4 bytes at a time up to 68
    bytes.  Returns (length int32, still alive bool) per position."""
    ml = torch.full_like(c, MIN_MATCH)
    alive = alive_mask
    for k in range(1, _STATIC_SCAN_WORDS + 1):
        ml, alive = _compare_step(gather(w, p + 4 * k), gather(w, c + 4 * k),
                                  ml, alive)
    return ml, alive


def _extend_matches_loop(w, p, c, ml, alive):
    """Extend the matches still alive past the static window, 64 bytes a
    round, masked, while any row has one (the rare long matches at offsets
    above 8)."""
    full = w.shape[-1]
    while bool(alive.any()):
        for _ in range(16):
            ml, alive = _compare_step(gather(w, p + ml), gather(w, c + ml),
                                      ml, alive)
        alive = alive & (p + ml < full - 8)  # lengths are clamped later
    return ml


def _find_candidates(w, k_depth: int):
    """The nearest earlier positions with the same 4-byte word, by one
    stable sort of each row: a list of k_depth int32 [B, FULL] arrays, -1
    where there is none."""
    rows, full = w.shape
    order = torch.sort(w, dim=-1, stable=True).indices
    w_sorted = torch.gather(w, -1, order)
    neq = torch.ones_like(w_sorted, dtype=torch.bool)
    neq[:, 1:] = w_sorted[:, 1:] != w_sorted[:, :-1]
    rid = torch.cumsum(neq, dim=-1, dtype=torch.int32)  # run id per sorted slot
    order32 = order.to(torch.int32)
    cands = []
    for k in range(1, k_depth + 1):
        none = torch.full((rows, k), -1, dtype=torch.int32, device=w.device)
        prev_order = torch.cat([none, order32[:, :-k]], dim=-1)
        prev_rid = torch.cat([none, rid[:, :-k]], dim=-1)
        cand_sorted = torch.where(prev_rid == rid, prev_order, -1)
        cands.append(torch.zeros_like(order32).scatter_(1, order, cand_sorted))
    return cands


def _analytic_periodic_lengths(b, full: int):
    """nxtdiff[:, k - 1, i] = the first j >= i with b[j] != b[j - k], for
    k = 1..8: the exact match length at offset k is nxtdiff - p."""
    rows = b.shape[0]
    idx = torch.arange(full, dtype=torch.int32, device=b.device)
    per = []
    for k in range(1, _ANALYTIC_MAX_OFF + 1):
        prev = torch.cat([torch.full((rows, k), -1, dtype=torch.int32, device=b.device),
                          b[:, :-k]], dim=-1)
        per.append(torch.where(b != prev, idx, full - 1))
    return reverse_cummin(torch.stack(per, dim=1))  # [B, 8, FULL]


def _encode_core(buf_u8, n, dict_len, dcap: int, bcap: int, k_depth: int):
    """buf_u8: uint8 [B, FULL] = [dictionary region dcap][block bcap][pad],
    a row's dictionary bytes right-aligned in its region, its block at
    [dcap, dcap + n).  n, dict_len: int32 [B].  Returns (out uint8
    [B, OCAP], out_len int32 [B])."""
    rows, full = buf_u8.shape
    dev = buf_u8.device
    ocap = align1024(compress_bound(bcap))
    d0 = dcap  # the block's start
    n = n.to(torch.int32).view(rows, 1)
    b = buf_u8.to(torch.int32)
    w = word_le(b)
    idx = torch.arange(full, dtype=torch.int32, device=dev)

    mf_limit = d0 + n - MF_LIMIT  # matches start strictly before this
    match_limit = d0 + n - LAST_LITERALS
    lo = d0 - dict_len.to(torch.int32).view(rows, 1)  # first valid history position

    # ---- candidates and match lengths ------------------------------------
    cands = _find_candidates(w, k_depth)
    nxtdiff = _analytic_periodic_lengths(b, full).reshape(rows, -1)

    best_ml = torch.zeros((rows, full), dtype=torch.int32, device=dev)
    best_off = torch.zeros_like(best_ml)
    p = idx
    for cand in cands:
        off = p - cand
        valid = (
            (cand >= lo) & (cand >= 0) & (off >= 1) & (off <= 65535)
            & (p >= d0) & (p < mf_limit)
        )
        small_off = valid & (off <= _ANALYTIC_MAX_OFF)
        # the row's own 8 x FULL table: index (offset - 1) * FULL + p
        ml_a = gather(nxtdiff, (off - 1).clamp(0, 7) * full + p) - p
        c = cand.clamp(min=0)
        ml_s, alive = _match_lengths_static(w, p, c, valid & ~small_off)
        ml_s = _extend_matches_loop(w, p, c, ml_s, alive)
        ml = torch.where(small_off, ml_a, ml_s)
        ml = torch.minimum(ml, match_limit - p)
        better = valid & (ml >= MIN_MATCH) & (ml > best_ml)
        best_ml = torch.where(better, ml, best_ml)
        best_off = torch.where(better, off, best_off)
    has_match = best_ml >= MIN_MATCH

    # ---- greedy parse by the anchor chain --------------------------------
    # block-relative arrays with a terminal "dead" slot
    m_sz = bcap + 1024
    dead = m_sz - 1
    pad_m = m_sz - bcap
    rel = torch.arange(m_sz, dtype=torch.int32, device=dev)
    ml_rel = torch.nn.functional.pad(best_ml[:, d0:d0 + bcap], (0, pad_m))
    off_rel = torch.nn.functional.pad(best_off[:, d0:d0 + bcap], (0, pad_m))
    hm_rel = torch.nn.functional.pad(
        has_match[:, d0:d0 + bcap].to(torch.uint8), (0, pad_m)).bool() & (rel < n)

    # the first match position at or after each position
    next_match = reverse_cummin(torch.where(hm_rel, rel, dead))
    s_of = next_match
    jump_tgt = gather(rel + ml_rel, s_of.clamp(max=dead)).clamp(max=dead)
    jump = torch.where(s_of < dead, jump_tgt, dead)
    jump[:, dead] = dead

    anchors = materialize_chain(jump, bcap // 4 + 3 + 1)  # ascending, sticks at dead
    s_cap = anchors.shape[1]
    s_idx = torch.arange(s_cap, dtype=torch.int32, device=dev)

    a_cl = anchors.clamp(max=dead)
    seq_at = gather(next_match, a_cl)  # each anchor's sequence (dead: none)
    s_real = (anchors < dead) & (seq_at < dead)
    n_seq = s_real.sum(dim=-1, keepdim=True, dtype=torch.int32)
    s_used = s_idx <= n_seq  # the real sequences and the tail

    pos_s = torch.where(s_real, seq_at, n)  # the tail's literals end at n
    prev_end = torch.where(s_used, torch.minimum(a_cl, n), 0)
    lit_len = torch.where(s_used, pos_s - prev_end, 0)
    ml_s = torch.where(s_real, gather(ml_rel, pos_s.clamp(max=dead)), 0)
    off_s = torch.where(s_real, gather(off_rel, pos_s.clamp(max=dead)), 1)

    mlv = (ml_s - MIN_MATCH).clamp(min=0)
    ll_ext = torch.where(lit_len >= 15, _vle_extra_bytes(lit_len - 15), 0)
    ml_ext = torch.where(s_real & (mlv >= 15), _vle_extra_bytes(mlv - 15), 0)
    size_s = torch.where(
        s_used, 1 + ll_ext + lit_len + torch.where(s_real, 2 + ml_ext, 0), 0)
    out_pos = torch.cumsum(size_s, dim=-1, dtype=torch.int32) - size_s
    total = size_s.sum(dim=-1, dtype=torch.int32)

    # ---- emission: each output byte from its sequence --------------------
    bnd = torch.where(s_used, out_pos, ocap + 1)
    o = torch.arange(ocap, dtype=torch.int32, device=dev)
    sid = torch.searchsorted(bnd, o.expand(rows, ocap).contiguous(), right=True)
    sg = (sid - 1).clamp(0, s_cap - 1)

    op_g = torch.gather(out_pos, 1, sg)
    ll_g = torch.gather(lit_len, 1, sg)
    lx_g = torch.gather(ll_ext, 1, sg)
    mx_g = torch.gather(ml_ext, 1, sg)
    mv_g = torch.gather(mlv, 1, sg)
    of_g = torch.gather(off_s, 1, sg)
    pe_g = torch.gather(prev_end, 1, sg)
    real_g = torch.gather(s_real, 1, sg)

    r = o - op_g
    tok = (ll_g.clamp(max=15) << 4) | torch.where(real_g, mv_g.clamp(max=15), 0)
    ll_v = (ll_g - 15).clamp(min=0)
    ml_v = (mv_g - 15).clamp(min=0)
    lit_off = 1 + lx_g  # the literals' offset in the sequence
    mo = lit_off + ll_g  # the offset field's position in the sequence

    lit_byte = gather(b, d0 + pe_g + (r - lit_off))
    val = torch.where(
        r == 0,
        tok,
        torch.where(
            r <= lx_g,  # the literal length's extension [1, lx]
            torch.where(r == lx_g, ll_v % 255, 255),
            torch.where(
                r < mo,  # literal bytes
                lit_byte,
                torch.where(
                    r == mo,
                    of_g & 0xFF,
                    torch.where(
                        r == mo + 1,
                        of_g >> 8,
                        # the match length's extension [mo + 2, mo + 1 + mx]
                        torch.where(r == mo + 1 + mx_g, ml_v % 255, 255),
                    ),
                ),
            ),
        ),
    )
    return val.to(torch.uint8), total


def encode_block_fixed(buf_u8, n, dict_len, dcap: int, bcap: int, k_depth: int):
    """Encode rows of one fixed shape on their device (`_encode_core`).
    Counted in ``encode_block_fixed.launches``, once a call."""
    encode_block_fixed.launches += 1
    return _encode_core(buf_u8, n, dict_len, dcap, bcap, k_depth)


encode_block_fixed.launches = 0


def level_to_depth(level: int) -> int:
    """Candidate-search depth per level."""
    if level < 3:
        return 1
    return min(1 << (level - 2), 16)


def encode_block_bytes(data: bytes, level: int = 0, dictionary: bytes = b"",
                       device="cuda") -> bytes:
    """Encode one block on ``device`` (the JAX package's
    `encode_jax.encode_block_bytes`), with the last 64 KB of
    ``dictionary`` as its history."""
    dev = resolve_device(device)
    n = len(data)
    if n == 0:
        return b"\x00"
    bcap = bucket(n)
    dlen = min(len(dictionary), 65536)
    dcap = 65536 if dlen else 0
    buf = torch.zeros((1, dcap + bcap + _PAD_TAIL), dtype=torch.uint8)
    if dlen:
        buf[0, dcap - dlen:dcap] = torch.frombuffer(
            bytearray(dictionary[-dlen:]), dtype=torch.uint8)
    buf[0, dcap:dcap + n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out, total = encode_block_fixed(
        buf.to(dev), torch.tensor([n], dtype=torch.int32, device=dev),
        torch.tensor([dlen], dtype=torch.int32, device=dev),
        dcap, bcap, level_to_depth(level))
    return out[0, :int(total[0])].cpu().numpy().tobytes()
