"""Batched LZ4 block decode: kernel A (`csrc/decode.cu`) and its plain
versions.

The port of `lz4_tpu/ops/decode_pallas6.py` (`pallas_decode6`, wrapper
`decode_blocks_pallas6`), with the same outputs, on two routes that
`route` picks by the batch's rows and out_cap.  The one-warp route
(`decode_rows`: a parse warp and a copy warp per row, the output in shared
memory up to 64 KB; its schedule's plain model `decode_rows_model`) takes
every batch of rows of at most 64 KB, large batches of rows up to 256 KB,
and rows with an output limit (a partial decode, `block.partial_decode`)
at any size.  Any other batch decodes through a parallel parse: every
position parsed speculatively, the true sequences the orbit of position
0, then the literal copies and the match bytes resolved by pointer
jumping (the passes of `rows_passes`), on groups of rows whose scratch
fits `GROUP_SCRATCH_BYTES` (`row_groups`).
Beside it: `decode_blocks_plain`, the serial reference (one scalar parse
per row, `_decode_row`); one plain version per pass (`rows_nn_plain`,
`rows_spans_plain`, `rows_hops_plain`, `rows_table_plain`,
`rows_literals_plain`, `rows_resolve_plain`); and `rows_passes`, every
pass's output of one decode (the plain passes chained on the CPU), for
holding each pass to its plain version.
The kernel's source says what bounds it on the card and what its design
does about that.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .build import check, load

MIN_MATCH = 4
DICT_CAP = 65536
MODES = ("full", "full2", "full2v")
# positions of one segment of the parallel parse (the kernel's kSeg)
SEG = 4096
# successor of a chain's last sequence, and the cap of every saturated sum
END = (1 << 31) - 1
# columns of the sequence table: literal source, literal length, output
# position, offset, match length (0: the literal-only last sequence, -1: a
# sequence that fails a structural check)
SEQ_COLUMNS = 5
# the most a row of L compressed bytes decodes to is 255 L
MAX_EXPANSION = 255
# batches of rows of at most this out_cap take the one-warp route whatever
# their number (rows with limits take it at any size)
WARP_ROUTE_MAX = 65536
# `route`'s rule: (out_cap, the fewest rows) at and above which a batch of
# rows of at most that out_cap takes the one-warp route; anything else
# takes the passes, which spread each row over the card.  From
# `decodebench.py --routes` on the H100 (ms per wrapper call, the one-warp
# route / the passes; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6):
#   64 KB: 1 row 0.94 / 1.05, 4 rows 1.03 / 1.47, 16 rows 0.97 / 1.28,
#          256 rows 1.00 / 2.43, 1,024 rows 2.33 / 6.71
#   128 KB: 1 row 2.07 / 1.13, 16 rows 2.18 / 1.42, 64 rows 2.18 / 2.27,
#           128 rows 2.19 / 2.92, 512 rows 2.63 / 5.74
#   256 KB: 16 rows 4.23 / 2.42, 128 rows 4.78 / 3.92, 256 rows 4.84 / 5.88
#   1 MiB: 1 row 16.04 / 1.53, 64 rows 18.77 / 6.94
# The one-warp route's time is its slowest row's, which grows with out_cap;
# the passes' grows with the bytes of the whole batch.
WARP_ROUTE_ROWS = ((WARP_ROUTE_MAX, 1), (131072, 128), (262144, 256))
# the one-warp route's schedule (`csrc/decode.cu` `decode_rows`, its plain
# model `decode_rows_model`): a ring of RING_STAGES stages of RING_STAGE
# bytes of the compressed row (a 16-byte chunk a lane), a read keeping at
# most RING_HOLD bytes behind it; the matches handed to the copy warp in
# QUEUE_SLOTS batches of QUEUE_BATCH; the output in shared memory for
# out_cap up to SHARED_OUT
RING_STAGE = 512
RING_STAGES = 16
RING_HOLD = RING_STAGE * (RING_STAGES - 1)
QUEUE_BATCH = 32
QUEUE_SLOTS = 2
# the longest match the copy warp lets one lane copy alone
ALONE_MATCH = 64
SHARED_OUT = 65536
# bytes of scratch of the parallel passes per position (nn, exits, counts,
# sums), segment (entry, seq_at, op_at), sequence-table row and index entry
# of `rows_layout`: about 23 bytes per compressed byte and 4 per output byte
SCRATCH_BYTES = (16, 12, 4 * SEQ_COLUMNS, 4)
# the scratch of one group of rows (`row_groups`): a frame of any size
# decodes in groups of this much, reused from group to group
GROUP_SCRATCH_BYTES = 1 << 31

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("decode")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lz4t_rows_parse.argtypes = [p, ll, p, i, p, i, i] + [p] * 15
        lib.lz4t_rows_literals.argtypes = [p, ll, i, i, i] + [p] * 11
        lib.lz4t_rows_resolve.argtypes = [p, p, p, i, p, p, p, i, i, i, p]
        lib.lz4t_decode_warp.argtypes = [p, ll, p, p, i, p, p, p, p, p, i, p]
        lib.lz4t_decode_warp_shared.argtypes = [i]
        for fn in (lib.lz4t_rows_parse, lib.lz4t_rows_literals,
                   lib.lz4t_rows_resolve, lib.lz4t_decode_warp,
                   lib.lz4t_rows_segment, lib.lz4t_decode_warp_shared,
                   lib.lz4t_decode_warp_shared_out):
            fn.restype = ctypes.c_int
        if lib.lz4t_rows_segment() != SEG:
            raise RuntimeError("csrc/decode.cu's kSeg differs from SEG")
        _lib = lib
    return _lib


def _decode_row(src: bytes, clen: int, out_cap: int, window: bytes,
                limit: int = -1):
    """One row, byte for byte as the kernel decodes it.  Returns
    (decoded bytes, err); on error the bytes stop where the failing
    sequence began.  ``limit`` >= 0 is a partial decode: the row stops
    cleanly at the first literal or match byte that brings the output to
    ``limit`` (the checks of `csrc/decode.cu` `decode_rows`); a limit
    above out_cap stops nothing, and a sequence that would write past
    out_cap is malformed, as without a limit."""
    dlen = len(window)
    buf = bytearray(window)
    cap = dlen + out_cap
    stop = dlen + limit if limit >= 0 else -1
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
        if q + ll > clen:
            err = 1
            break
        if 0 <= stop <= cap and op + ll >= stop:  # the run reaches the limit
            buf += src[q:q + stop - op]
            return bytes(buf[dlen:]), 0
        if op + ll > cap:
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
            if stop >= 0 and b == 255:  # the extension ran out of input
                err = 1
                break
        last = 0 <= stop <= cap and op + ll + ml >= stop
        # buf holds the window first, so op already counts dlen
        if off == 0 or off > op + ll or (not last and op + ll + ml > cap):
            err = 1
            break
        buf += src[lit_at:lit_at + ll]
        if last:
            ml = stop - len(buf)
        base = len(buf) - off
        if off >= ml:
            buf += buf[base:base + ml]
        else:
            buf += (buf[base:] * (ml // off + 1))[:ml]
        if last:
            return bytes(buf[dlen:]), 0
        ip = q
    if err == 0 and ip != clen:
        err = 2
    return bytes(buf[dlen:]), err


class _Ring:
    """The kernel's ring (`csrc/decode.cu` `Ring`) over one row's clen
    bytes starting ``lead`` bytes into a 16-byte chunk: which stages are
    issued, held and landed, each read held to them."""

    def __init__(self, row: bytes, lead: int, tally: dict):
        self.row, self.lead, self.tally = row, lead, tally
        chunks = -(-(lead + len(row)) // 16)  # 16-byte chunks, 32 a stage
        self.stages = -(-chunks // 32)
        self.issued = self.landed = self.refill_at = 0
        self.skipped = []  # stage ranges never copied (the parse went past)

    def stage(self, p: int) -> int:
        return (p + self.lead) // RING_STAGE

    def held_from(self) -> int:
        return (self.issued - RING_STAGES) * RING_STAGE - self.lead

    def need(self, keep: int, p1: int) -> None:
        """Positions below p1 readable, those from ``keep`` kept."""
        assert p1 - keep <= RING_HOLD
        if keep >= self.refill_at:
            lim = min(self.stages, self.stage(keep) + RING_STAGES)
            if lim - RING_STAGES > self.landed:  # a slot to refill has a copy in flight
                if self.issued < lim - RING_STAGES:
                    self.skipped.append((self.issued, lim - RING_STAGES))
                    self.tally["skipped"] += lim - RING_STAGES - self.issued
                self.issued = max(self.issued, lim - RING_STAGES)
                self.landed = self.issued
                self.tally["waits"] += 1
            # a slot is refilled only once the stage it held has landed
            assert self.issued >= lim or lim - RING_STAGES <= self.landed
            self.tally["stages"] += max(lim - self.issued, 0)
            self.issued = max(self.issued, lim)
            self.refill_at = (END if self.issued >= self.stages else
                              (self.issued - RING_STAGES + 1) * RING_STAGE - self.lead)
        if p1 > self.ready_end():  # wait for p1's stage, up to 8 later ones left in flight
            pend = self.issued - self.stage(p1 - 1) - 1
            self.landed = self.issued - next(n for n in (8, 4, 2, 1, 0) if pend >= n)
            self.tally["waits"] += 1

    def ready_end(self) -> int:
        return END if self.landed >= self.stages else self.landed * RING_STAGE - self.lead

    def at(self, p: int) -> int:
        s = self.stage(p)
        assert self.issued - RING_STAGES <= s < self.landed, (p, s, self.issued, self.landed)
        assert not any(a <= s < b for a, b in self.skipped)
        return self.row[p]


def lane_index(lane: int, off: int) -> tuple[int, int]:
    """A lane's first index into a match's pattern and its step, as the copy
    warp takes them (`copy_match`): the lane and 32 at offsets of 32 and
    more, else lane mod off and 32 mod off from its table of 31 rows made
    once a CTA."""
    if off >= 32:
        return lane, 32
    return lane % off, 32 % off


def decode_rows_model(row: bytes, out_cap: int, window: bytes = b"",
                      limit: int = -1, lead: int = 0, eager: bool = False,
                      counts: list | None = None):
    """The one-warp route's schedule on one row of len(row) compressed bytes
    (`csrc/decode.cu` `decode_rows`), held at every step: the parse reads
    only bytes its ring holds and has landed (`_Ring`; the row starting
    ``lead`` bytes into a 16-byte chunk); takes the common sequences that
    start in 32 bytes at once (`_window`) and any other one by the serial
    parse, copying each literal run from the ring or, once the ring has let
    it go, from the row; queues each match, handing them to the copy warp in
    batches of QUEUE_BATCH, at most QUEUE_SLOTS batches ahead; the copy
    warp copies the matches of a batch that read only bytes final before
    it side by side, one lane each, then the rest in order, each by the
    warp and each lane's advanced index (`lane_index`), every byte it reads
    final, either as soon as a batch is handed over (``eager``) or as late
    as the parse allows; the output exported up to ``produced``.  Returns
    `_decode_row`'s (bytes, err); ``counts`` gets the row's tally:
    sequences parsed, length-extension bytes read, window steps and the
    sequences and extension bytes they took (`schedule_steps` counts the
    dependent steps from these), stages issued and skipped
    (never copied: the parse went past them), waits, batches, matches
    copied by one lane, literal bytes from the ring and from the row."""
    clen, dlen = len(row), len(window)
    tally = dict.fromkeys(("sequences", "extension_bytes", "windows",
                           "window_sequences", "window_extension_bytes", "stages",
                           "skipped", "waits", "batches", "alone", "ring_literals",
                           "row_literals"), 0)
    ring = _Ring(row, lead, tally)
    out = bytearray(window) + bytearray(b"\xab" * out_cap)  # unwritten: 0xab
    final = bytearray(b"\x01" * dlen) + bytearray(out_cap)
    pending, batch = [], []

    def copy_one(d, off, m):
        base = d - off
        assert base >= 0 and all(final[base:base + min(off, m)])
        j0, step = zip(*(lane_index(k, off) for k in range(32)))
        assert list(j0) == [k % off for k in range(32)] and all(
            x == (32 % off if off < 32 else 32) for x in step)
        i = np.arange(m)
        j = (np.asarray(j0)[i % 32] + (i // 32) * step[0]) % off
        out[d:d + m] = bytes(np.frombuffer(bytes(out[base:base + off]), np.uint8)[j])

    def copy(matches):
        # copied by one lane, side by side: a match of at most ALONE_MATCH
        # bytes that reads only bytes below the batch's first match or its
        # own literal run; then the rest in order, each by the warp
        first = matches[0][0] if matches else 0
        alone = [m <= ALONE_MATCH and (d - off + min(off, m) <= first or off <= ll)
                 for d, off, m, ll in matches]
        tally["alone"] += sum(alone)
        for (d, off, m, _), a in zip(matches, alone):
            if a:
                copy_one(d + dlen, off, m)
        for (d, off, m, _), a in zip(matches, alone):
            if a:
                final[d + dlen:d + dlen + m] = b"\x01" * m
        for (d, off, m, _), a in zip(matches, alone):
            if not a:
                copy_one(d + dlen, off, m)
                final[d + dlen:d + dlen + m] = b"\x01" * m

    def hand_over(done=False):
        nonlocal batch
        if len(pending) == QUEUE_SLOTS:  # the slot is reused: its batch copied first
            copy(pending.pop(0))
        pending.append(batch)
        batch = []
        tally["batches"] += 1
        if eager or done:
            while pending:
                copy(pending.pop(0))

    def literals(frm, n, op):
        if n <= 0:
            return
        if frm >= ring.held_from():
            a = frm
            while a < frm + n:
                b = min(frm + n, a + RING_HOLD)
                ring.need(a, b)
                ring.at(a), ring.at(b - 1)
                a = b
            tally["ring_literals"] += n
        else:
            tally["row_literals"] += n
        out[dlen + op:dlen + op + n] = row[frm:frm + n]
        final[dlen + op:dlen + op + n] = b"\x01" * n

    def vle(hold, q):
        v, b = 0, 255
        while b == 255 and q < clen:
            ring.need(max(hold, q + 1 - RING_HOLD), q + 1)
            b = ring.at(q)
            q += 1
            v += b
            tally["extension_bytes"] += 1
        return v, q, b

    def window(ip, op):
        """The sequences the kernel's window step takes at ip: (taken
        sequences as (literal run's position, its length, offset, match
        length, extension bytes), the next ip)."""
        ring.at(ip), ring.at(ip + 63)
        w = row[ip:ip + 64]
        nxt, cand = {}, {}
        for lane in range(32):
            lx, mc = int(w[lane] >> 4 == 15), w[lane] & 15
            lext = w[lane + 1] if lx else 0
            ll = (w[lane] >> 4) + lext
            a = lane + 1 + lx + ll  # the offset's position
            nxt[lane] = a + 2 + int(mc == 15)
            plain = lext != 255 and nxt[lane] <= 64
            ext = w[a + 2] if plain and mc == 15 else 0
            plain = plain and ext != 255
            cand[lane] = (ll, w[a] | (w[a + 1] << 8) if plain else 0,
                          mc + MIN_MATCH + ext, plain, lx + int(mc == 15), lane + 1 + lx)
        chain, p = [], 0
        while p < 32 and cand[p][3]:
            chain.append(p)
            p = nxt[p]
        assert len(chain) <= 16  # the kernel's four doubling rounds
        taken = []
        for p in chain:
            ll, off, ml, _, ext, ls = cand[p]
            c = ll + ml
            if (off == 0 or off - ll - dlen > op or out_cap - op < c
                    or (limit >= 0 and limit - op <= c)
                    or len(taken) == QUEUE_BATCH - len(batch)):
                return taken, ip + p
            taken.append((ip + ls, ll, off, ml, ext))
            op += c
        return taken, ip + (nxt[chain[-1]] if chain else 0)

    ip = op = err = 0
    stopped = False
    while True:
        while ip < ring.refill_at and ip + 64 <= min(ring.ready_end(), clen):
            taken, nip = window(ip, op)
            if not taken:
                break
            tally["windows"] += 1
            tally["window_sequences"] += len(taken)
            for at, ll, off, ml, ext in taken:
                tally["sequences"] += 1
                tally["extension_bytes"] += ext
                tally["window_extension_bytes"] += ext
                out[dlen + op:dlen + op + ll] = row[at:at + ll]
                final[dlen + op:dlen + op + ll] = b"\x01" * ll
                op += ll
                batch.append((op, off, ml, ll))
                op += ml
            if len(batch) == QUEUE_BATCH:
                hand_over()
            ip = nip
        if ip >= clen:
            err = 1
            break
        tally["sequences"] += 1
        ring.need(ip, ip + 1)
        token = ring.at(ip)
        q = ip + 1
        ll = token >> 4
        if ll == 15:
            v, q, _ = vle(ip, q)
            ll += v
        if q + ll > clen:
            err = 1
            break
        if 0 <= limit <= out_cap and op + ll >= limit:  # the run reaches the limit
            literals(q, limit - op, op)
            op, stopped = limit, True
            break
        if op + ll > out_cap:
            err = 1
            break
        lit_at = q
        q += ll
        if q >= clen:  # the last sequence: literals only
            literals(lit_at, ll, op)
            op += ll
            ip = q
            break
        if q + 2 > clen:
            err = 1
            break
        ring.need(max(ip, q + 2 - RING_HOLD), q + 2)
        off = ring.at(q) | (ring.at(q + 1) << 8)
        q += 2
        ml = (token & 15) + MIN_MATCH
        if token & 15 == 15:
            q0 = q
            v, q, b = vle(ip, q)
            ml += v
            if limit >= 0 and (q == q0 or b == 255):
                err = 1
                break
        last = 0 <= limit <= out_cap and op + ll + ml >= limit
        if off == 0 or off > op + ll + dlen or (not last and op + ll + ml > out_cap):
            err = 1
            break
        literals(lit_at, ll, op)
        op += ll
        m = limit - op if last else ml
        batch.append((op, off, m, ll))
        if len(batch) == QUEUE_BATCH:
            hand_over()
        op += m
        ip = q
        if last:
            stopped = True
            break
    if err == 0 and not stopped and ip != clen:
        err = 2
    hand_over(done=True)
    assert all(final[dlen:dlen + op])
    if counts is not None:
        counts.append(tally)
    return bytes(out[dlen:dlen + op]), err


def schedule_steps(tally: dict) -> int:
    """The one-warp route's dependent steps on a row, from its
    `decode_rows_model` tally: its window steps (each takes the common
    sequences that start in 32 bytes at once), and the other sequences'
    tokens and length-extension bytes that its serial parse reads one at a
    time.  At one shared-memory round trip each, the step bound of
    `decode_rows`; the serial count of every sequence and extension byte
    is ``tally["sequences"] + tally["extension_bytes"]``."""
    return (tally["windows"] + tally["sequences"] - tally["window_sequences"]
            + tally["extension_bytes"] - tally["window_extension_bytes"])


def decode_blocks_plain(comps_u8, comp_lens, out_cap: int, dicts_u8=None,
                        dict_lens=None, mode: str = "full2", limits=None):
    """The plain PyTorch version of `decode_blocks`: the same checks, the
    same outputs, one scalar parse per row on the host."""
    comps, clens, dicts, dls = _validate(
        comps_u8, comp_lens, out_cap, dicts_u8, dict_lens, mode
    )
    lim = _validate_limits(limits, clens.shape[0])
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
        data, err = _decode_row(src, clen, out_cap, window,
                                -1 if lim is None else int(lim[b]))
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


def _validate_limits(limits, nb: int):
    """Per-row output limits as an int32 CPU tensor (-1: no limit), or
    None."""
    if limits is None:
        return None
    lim = torch.as_tensor(limits, dtype=torch.int32).cpu()
    if lim.shape != (nb,):
        raise ValueError("limits must hold one value per row")
    if nb and int(lim.min()) < -1:
        raise ValueError("limits must be >= -1")
    return lim


# ---- the parallel parse and its passes, plain --------------------------


class RowsLayout(NamedTuple):
    """Where each row's scratch starts, from its comp_len c = max(comp_len,
    0): positions (c + 1 of them: nn, exits, counts, sums), segments
    (ceil((c + 1) / SEG): entry, seq_at, op_at), sequence-table rows
    (c // 3 + 1: every sequence but the last takes at least 3 bytes) and
    index entries (min(out_cap, 255 c)); each int64 [B], with the totals."""
    cbase: torch.Tensor
    gbase: torch.Tensor
    sbase: torch.Tensor
    pbase: torch.Tensor
    positions: int
    segments: int
    rows: int
    slots: int


def _row_parts(comp_lens, out_cap: int):
    c = torch.as_tensor(comp_lens).cpu().to(torch.int64).clamp(min=0)
    return [c + 1, (c + SEG) // SEG, c // 3 + 1,
            (c * MAX_EXPANSION).clamp(max=out_cap)]


def rows_layout(comp_lens, out_cap: int) -> RowsLayout:
    parts = _row_parts(comp_lens, out_cap)
    bases = [torch.cumsum(x, 0) - x for x in parts]
    return RowsLayout(*bases, *(int(x.sum()) for x in parts))


def _row_bytes(comps, b: int, clen: int) -> np.ndarray:
    """Row b's compressed bytes and two zeros (int64)."""
    c = max(clen, 0)
    row = np.zeros(c + 2, np.int64)
    row[:c] = comps[b, :c]
    return row


def _nn(row: np.ndarray, c: int) -> np.ndarray:
    """For positions 0..c, the next one whose byte is not 255 (or c)."""
    q = np.arange(c + 1, dtype=np.int64)
    stop = np.ones(c + 1, bool)
    stop[:c] = row[:c] != 255
    return np.minimum.accumulate(np.where(stop, q, c)[::-1])[::-1]


def _speculate(row: np.ndarray, c: int, nn: np.ndarray):
    """The sequence that would start at every position 0..c (the kernel's
    `parse_at`): kind (0 match, 1 the literal-only last sequence, 2 a
    structural failure), literal source and length, offset, match length
    and successor (END unless a match), int64 each."""
    q = np.arange(c + 1, dtype=np.int64)

    def vle(t):
        inside = t < c
        e = nn[np.minimum(t, c)]
        has = inside & (e < c)
        v = np.where(has, 255 * (e - t) + row[np.minimum(e, c)],
                     np.where(inside, 255 * (c - t), 0))
        return v, np.where(has, e + 1, np.where(inside, c, t))

    tok = row[q]
    ll = tok >> 4
    v, t_ext = vle(q + 1)
    ll = np.where(ll == 15, ll + v, ll)
    t = np.where(tok >> 4 == 15, t_ext, q + 1)
    fail = (q >= c) | (t + ll > c)
    lit = t
    t = t + ll
    last = ~fail & (t >= c)
    fail |= ~last & (t + 2 > c)
    at = np.minimum(t, c)
    off = row[at] | (row[np.minimum(at + 1, c + 1)] << 8)
    ml = (tok & 15) + MIN_MATCH
    v, t_ext = vle(t + 2)
    ml = np.where(tok & 15 == 15, ml + v, ml)
    t = np.where(tok & 15 == 15, t_ext, t + 2)
    fail |= ~last & (off == 0)
    match = ~fail & ~last
    kind = np.where(match, 0, np.where(last, 1, 2))
    lit = np.where(fail, 0, lit)
    ll = np.where(fail, 0, ll)
    return (kind, lit, ll, np.where(match, off, 0), np.where(match, ml, 0),
            np.where(match, t, END))


def _rows(comps_u8, comp_lens):
    comps = torch.as_tensor(comps_u8).cpu().numpy()
    return comps, [int(x) for x in torch.as_tensor(comp_lens).cpu().tolist()]


def rows_nn_plain(comps_u8, comp_lens):
    """Pass 1: every row's `_nn` at positions 0..c, flat at `rows_layout`'s
    cbase (int32)."""
    comps, clens = _rows(comps_u8, comp_lens)
    parts = [_nn(_row_bytes(comps, b, n), max(n, 0)) for b, n in enumerate(clens)]
    return torch.from_numpy(np.concatenate(parts).astype(np.int32))


def _contrib(kind, ll, ml):
    return np.where(kind == 2, 0, np.minimum(ll + ml, END))


def rows_spans_plain(comps_u8, comp_lens, nn):
    """Pass 2, from pass 1's ``nn``: for every position of every row, the
    first position at or past its segment's end that the chain from it
    reaches (or END), the sequences on the way and the bytes they decode
    to (saturated at END); int32, flat at cbase each."""
    comps, clens = _rows(comps_u8, comp_lens)
    nn = torch.as_tensor(nn).cpu().numpy().astype(np.int64)
    lay = rows_layout(clens, 0)
    out = [], [], []
    for b, n in enumerate(clens):
        c = max(n, 0)
        at = int(lay.cbase[b])
        kind, _, ll, _, ml, nx = _speculate(_row_bytes(comps, b, n), c, nn[at:at + c + 1])
        q = np.arange(c + 1, dtype=np.int64)
        seg_end = np.minimum((q // SEG + 1) * SEG, c + 1)
        cn = np.ones(c + 1, np.int64)
        os = _contrib(kind, ll, ml)
        while True:
            inside = np.flatnonzero(nx < seg_end)
            if inside.size == 0:
                break
            u = nx[inside]
            nx[inside], cn[inside], os[inside] = (
                nx[u], cn[inside] + cn[u], np.minimum(os[inside] + os[u], END))
        for part, x in zip(out, (nx, cn, os)):
            part.append(x)
    return tuple(torch.from_numpy(np.concatenate(x).astype(np.int32)) for x in out)


def rows_hops_plain(comp_lens, exits, counts, sums):
    """Pass 3: each row's hops from position 0, segment to segment: per
    segment the chain's entry (-1 where it skips the segment), the sequence
    index and the output position (saturated) there (int32, flat at gbase
    each; 0 where skipped), and per row the sequence count and the bytes
    decoded (saturated)."""
    clens = [int(x) for x in torch.as_tensor(comp_lens).cpu().tolist()]
    lay = rows_layout(clens, 0)
    exits, counts, sums = (torch.as_tensor(x).cpu().numpy() for x in (exits, counts, sums))
    entry = np.full(lay.segments, -1, np.int32)
    seq_at = np.zeros(lay.segments, np.int32)
    op_at = np.zeros(lay.segments, np.int32)
    nseq = np.zeros(len(clens), np.int32)
    total = np.zeros(len(clens), np.int32)
    for b in range(len(clens)):
        cb, gb = int(lay.cbase[b]), int(lay.gbase[b])
        e = seq = op = 0
        while e != END:
            k = gb + e // SEG
            entry[k], seq_at[k], op_at[k] = e, seq, op
            seq += int(counts[cb + e])
            op = min(op + int(sums[cb + e]), END)
            e = int(exits[cb + e])
        nseq[b], total[b] = seq, op
    return tuple(torch.from_numpy(x) for x in (entry, seq_at, op_at, nseq, total))


def _chain_rows(row, c, nn, out_cap, dlen):
    """The orbit of position 0 as sequence-table rows (int64 [n, 5], the
    output position and lengths saturated at END) and the index of its
    first failing sequence (END if none)."""
    kind, lit, ll, off, ml, nxt = _speculate(row, c, nn)
    chain, p = [], 0
    while True:
        chain.append(p)
        if kind[p] != 0:
            break
        p = int(nxt[p])
    ch = np.asarray(chain, dtype=np.int64)
    k, lt, l, o, m = kind[ch], lit[ch], ll[ch], off[ch], ml[ch]
    contrib = np.where(k == 2, 0, l + m)
    op = np.cumsum(contrib) - contrib
    bad = (k == 2) | (op + l > out_cap) | (
        (k == 0) & ((o > op + l + dlen) | (op + l + m > out_cap)))
    rows = np.stack([lt, np.minimum(l, END), np.minimum(op, END), o,
                     np.where(k == 0, np.minimum(m, END), np.where(k == 1, 0, -1))], 1)
    first = int(np.argmax(bad)) if bad.any() else END
    return rows, first


def rows_table_plain(comps_u8, comp_lens, out_cap: int, dict_lens, nn):
    """Pass 4, from pass 1's ``nn``: every row's sequence table (the orbit of
    position 0: int32 [rows, 5] at sbase, zeros in the rows no sequence
    took) and the index of its first failing sequence (int32 [B]; END if
    none), by the checks that need the output position too."""
    comps, clens = _rows(comps_u8, comp_lens)
    nn = torch.as_tensor(nn).cpu().numpy().astype(np.int64)
    dls = ([0] * len(clens) if dict_lens is None
           else [int(x) for x in torch.as_tensor(dict_lens).cpu().tolist()])
    lay = rows_layout(clens, out_cap)
    seqs = np.zeros((max(lay.rows, 1), SEQ_COLUMNS), np.int64)
    fail = np.zeros(len(clens), np.int32)
    for b, n in enumerate(clens):
        c, at = max(n, 0), int(lay.cbase[b])
        rows, fail[b] = _chain_rows(_row_bytes(comps, b, n), c,
                                    nn[at:at + c + 1], out_cap, dls[b])
        s0 = int(lay.sbase[b])
        seqs[s0:s0 + rows.shape[0]] = rows
    return torch.from_numpy(seqs.astype(np.int32)), torch.from_numpy(fail)


def spans(counts):
    """For each unit of `counts` (int64), its owner and its index within
    the owner."""
    owner = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    first = torch.cumsum(counts, 0) - counts
    return owner, torch.arange(owner.numel()) - first[owner]


def used_rows(sbase, nseq):
    """The sequence-table rows a parse filled (int64, row by row)."""
    owner, local = spans(torch.as_tensor(nseq).cpu().to(torch.int64))
    return torch.as_tensor(sbase).cpu()[owner] + local


def used_slots(pbase, lens):
    """The index entries of the bytes each row wrote (int64, row by row)."""
    return used_rows(pbase, torch.as_tensor(lens).cpu().clamp(min=0))


def sequence_bytes(lit, ll, op, off, ml):
    """Where the bytes of sequence-table rows go (int64 [n] each, the
    literal pass of both parallel decoders): the literal bytes' owner,
    source and destination, and the match bytes' owner, destination and
    index entry (byte j of a match at d: d - off + j mod off, one hop out
    of its own match however much it overlaps).  The caller adds each
    owner's bases."""
    seq, j = spans(ll)
    literals = seq, lit[seq] + j, op[seq] + j
    seq, j = spans(ml)
    d = op[seq] + ll[seq]
    return literals, (seq, d + j, d - off[seq] + j % off[seq])


def jump_plain(ptr, prefix: int):
    """Pointer jumping over the index array of a buffer [prefix | stream]
    (int64: entry i is stream byte i's, a position in the buffer; the
    prefix's positions are final) until no entry changes: the resolve pass
    of both parallel decoders."""
    full = torch.cat([torch.arange(prefix), torch.as_tensor(ptr, dtype=torch.int64)])
    while True:
        nxt = full[full]
        if torch.equal(nxt, full):
            return full[prefix:]
        full = nxt


def rows_literals_plain(comps_u8, comp_lens, out_cap: int, seqs, nseq, total,
                        fail):
    """Pass 5, from the sequence table: each row's lens and errs (the
    output position of its first failing sequence and 1, or its bytes and
    0), the output (uint8 [B, out_cap]) with the literal runs of the
    sequences before the failing one in place, and the index array (int32,
    flat at pbase; entries past lens unwritten, here -1): a literal byte
    points to itself, byte j of a match at d to d - off + j mod off."""
    comps = torch.as_tensor(comps_u8).cpu()
    lay = rows_layout(comp_lens, out_cap)
    seqs, nseq, total, fail = (torch.as_tensor(x).cpu().to(torch.int64)
                               for x in (seqs, nseq, total, fail))
    nb = comps.shape[0]
    out = torch.zeros((nb, out_cap), dtype=torch.uint8)
    ptr = torch.full((max(lay.slots, 1),), -1, dtype=torch.int64)
    lens = torch.zeros(nb, dtype=torch.int32)
    errs = torch.zeros(nb, dtype=torch.int32)
    for b in range(nb):
        n, f = int(nseq[b]), int(fail[b])
        s0, p0 = int(lay.sbase[b]), int(lay.pbase[b])
        lens[b] = int(seqs[s0 + f, 2] if f < n else total[b])
        errs[b] = int(f < n)
        (_, src, dst), (_, at, entry) = sequence_bytes(
            *seqs[s0:s0 + min(f, n)].unbind(1))
        out[b, dst] = comps[b, src]
        ptr[p0 + dst] = dst
        ptr[p0 + at] = entry
    return out, ptr.to(torch.int32), lens, errs


def rows_resolve_plain(comp_lens, out_cap: int, lit_out, lit_ptr, lens,
                       dicts_u8=None):
    """Pass 6, from pass 5's output: every row's index array (its first lens
    entries) jumped until no entry changes, then every match byte gathered
    from the literal or dictionary byte it points to.  Returns the output
    (uint8 [B, out_cap]) and the index array."""
    lay = rows_layout(comp_lens, out_cap)
    out = torch.as_tensor(lit_out).cpu().clone()
    ptr = torch.as_tensor(lit_ptr).cpu().to(torch.int64).clone()
    for b, n in enumerate(torch.as_tensor(lens).cpu().tolist()):
        p0 = int(lay.pbase[b])
        # the row's buffer: [its dictionary row | its output]
        v = jump_plain(ptr[p0:p0 + n] + DICT_CAP, DICT_CAP)
        ptr[p0:p0 + n] = v - DICT_CAP
        window = (torch.zeros(DICT_CAP, dtype=torch.uint8) if dicts_u8 is None
                  else torch.as_tensor(dicts_u8)[b].cpu())
        out[b, :n] = torch.cat([window, out[b, :n]])[v]
    return out, ptr.to(torch.int32)


class RowPasses(NamedTuple):
    """Every pass's output of one decode (`rows_passes`): the layout; pass 1
    nn; pass 2 exits, counts, sums; pass 3 entry, seq_at, op_at, nseq,
    total; pass 4 the sequence table and each row's first failing sequence;
    pass 5 lens, errs, the output and index array after the literal copies;
    pass 6 the index array and the output `decode_blocks` returns."""
    layout: RowsLayout
    nn: torch.Tensor
    exits: torch.Tensor
    counts: torch.Tensor
    sums: torch.Tensor
    entry: torch.Tensor
    seq_at: torch.Tensor
    op_at: torch.Tensor
    nseq: torch.Tensor
    total: torch.Tensor
    seqs: torch.Tensor
    fail: torch.Tensor
    lens: torch.Tensor
    errs: torch.Tensor
    lit_out: torch.Tensor
    lit_ptr: torch.Tensor
    ptr: torch.Tensor
    out: torch.Tensor


def rows_passes(comps_u8, comp_lens, out_cap: int, dicts_u8=None,
                dict_lens=None, mode: str = "full2"):
    """Every pass of one decode of a batch (`RowPasses`): the plain versions
    chained for a CPU tensor, the kernels for a CUDA tensor (then the
    output and index array after pass 5 are copies taken before pass 6
    runs, and scratch no pass wrote, sequence-table rows past a row's
    sequences and index entries past its lens, holds whatever the card
    left there)."""
    comps, clens, dicts, dls = _validate(
        comps_u8, comp_lens, out_cap, dicts_u8, dict_lens, mode
    )
    if comps.device.type == "cuda":
        return _launch_rows(comps, clens, out_cap, dicts, dls, keep=True)
    lay = rows_layout(clens, out_cap)
    nn = rows_nn_plain(comps, clens)
    exits, counts, sums = rows_spans_plain(comps, clens, nn)
    entry, seq_at, op_at, nseq, total = rows_hops_plain(clens, exits, counts, sums)
    seqs, fail = rows_table_plain(comps, clens, out_cap, dls, nn)
    lit_out, lit_ptr, lens, errs = rows_literals_plain(
        comps, clens, out_cap, seqs, nseq, total, fail)
    out, ptr = rows_resolve_plain(clens, out_cap, lit_out, lit_ptr, lens, dicts)
    return RowPasses(lay, nn, exits, counts, sums, entry, seq_at, op_at, nseq,
                     total, seqs, fail, lens, errs, lit_out, lit_ptr, ptr, out)


# ---- the kernels ---------------------------------------------------------


def row_groups(comp_lens, out_cap: int) -> list[tuple[int, int]]:
    """Consecutive [first, end) row ranges whose scratch for the parallel
    passes (`SCRATCH_BYTES` per part of `rows_layout`) fits
    `GROUP_SCRATCH_BYTES`; a row larger than that makes a group of its
    own."""
    parts = _row_parts(comp_lens, out_cap)
    need = sum(w * x for w, x in zip(SCRATCH_BYTES, parts)).tolist()
    groups, first, size = [], 0, 0
    for r, n in enumerate(need):
        if r > first and size + n > GROUP_SCRATCH_BYTES:
            groups.append((first, r))
            first, size = r, 0
        size += n
    groups.append((first, len(need)))
    return groups


def _scratch(dev, positions, segments, rows, slots, rounds):
    i32 = dict(dtype=torch.int32, device=dev)
    return {"pos": torch.empty((4, max(positions, 1)), **i32),
            "seg": torch.empty((3, max(segments, 1)), **i32),
            "seqs": torch.empty((max(rows, 1), SEQ_COLUMNS), **i32),
            "ptr": torch.empty((max(slots, 1),), **i32),
            "flags": torch.empty((max(rounds, 1),), **i32)}


def _rounds(c, out_cap: int) -> int:
    """Pointer-jumping rounds that resolve any row of comp_lens c."""
    return max(min(out_cap, MAX_EXPANSION * int(c.max())), 1).bit_length() + 2


def _launch_group(comps, clens, c, out_cap, dicts, dls, lay, buf, out, lens,
                  errs, keep=False):
    """Enqueue the passes over one group of rows on the current stream, in
    the scratch ``buf`` (`_scratch`, at least this group's size); no host
    round trip between them (the sizes they need from one another stay on
    the card).  ``keep``: copy the output and index array between passes 5
    and 6."""
    dev = comps.device
    nb = comps.shape[0]
    max_c = int(c.max())
    max_slot = min(out_cap, MAX_EXPANSION * max_c)
    rounds = _rounds(c, out_cap)
    meta = torch.cat([lay.cbase, lay.gbase, lay.sbase, lay.pbase]).to(dev)
    cbase, gbase, sbase, pbase = meta.split(nb)
    nn, exits, counts, sums = buf["pos"][:, :lay.positions]
    entry, seq_at, op_at = buf["seg"][:, :lay.segments]
    entry.fill_(-1)
    seq_at.zero_()
    op_at.zero_()
    seqs = buf["seqs"][:max(lay.rows, 1)]
    ptr = buf["ptr"][:max(lay.slots, 1)]
    flags = buf["flags"][:rounds].zero_()
    nseq, total = torch.empty((2, nb), dtype=torch.int32, device=dev)
    fail = torch.full((nb,), END, dtype=torch.int32, device=dev)
    lib = _kernel()
    dl = dls.data_ptr() if dls is not None else None
    with torch.cuda.device(dev):
        s = torch.cuda.current_stream(dev).cuda_stream
        check(lib.lz4t_rows_parse(
            comps.data_ptr(), comps.stride(0), clens.data_ptr(), out_cap, dl,
            nb, max_c, cbase.data_ptr(), gbase.data_ptr(), sbase.data_ptr(),
            nn.data_ptr(), exits.data_ptr(), counts.data_ptr(), sums.data_ptr(),
            entry.data_ptr(), seq_at.data_ptr(), op_at.data_ptr(),
            nseq.data_ptr(), total.data_ptr(), seqs.data_ptr(), fail.data_ptr(),
            s), "decode parse")
        for name in ("rows_nn", "rows_spans", "rows_hops", "rows_table"):
            kernel_launches[name] += 1
        check(lib.lz4t_rows_literals(
            comps.data_ptr(), comps.stride(0), out_cap, nb,
            -(-(max_c // 3 + 1) // 64), sbase.data_ptr(), pbase.data_ptr(),
            seqs.data_ptr(), nseq.data_ptr(), total.data_ptr(), fail.data_ptr(),
            out.data_ptr(), ptr.data_ptr(), lens.data_ptr(), errs.data_ptr(),
            s), "decode literals")
        kernel_launches["rows_literals"] += 1
        lit_out = out.clone() if keep else None
        lit_ptr = ptr.clone() if keep else None
        check(lib.lz4t_rows_resolve(
            pbase.data_ptr(), lens.data_ptr(), ptr.data_ptr(), out_cap,
            dicts.data_ptr() if dicts is not None else None, out.data_ptr(),
            flags.data_ptr(), rounds, nb, -(-max_slot // 2048), s),
            "decode resolve")
        kernel_launches["rows_jump"] += rounds
        kernel_launches["rows_gather"] += 1
    return RowPasses(lay, nn, exits, counts, sums, entry, seq_at, op_at, nseq,
                     total, seqs, fail, lens, errs, lit_out, lit_ptr, ptr, out)


def _launch_rows(comps, clens, out_cap, dicts, dls, keep=False):
    """The parallel passes over checked rows on the card, group by group
    (`row_groups`), the scratch allocated once for the largest group.
    Returns (out, lens, errs), or with ``keep`` every pass's output
    (`RowPasses`) of the batch run as one group."""
    dev = comps.device
    comps = comps.contiguous()
    nb = comps.shape[0]
    out = torch.zeros((nb, out_cap), dtype=torch.uint8, device=dev)
    lens, errs = torch.zeros((2, nb), dtype=torch.int32, device=dev)
    c = clens.cpu().to(torch.int64).clamp(min=0)
    if nb == 0:
        return (RowPasses(rows_layout(c, out_cap), *([lens] * 9),
                          lens.reshape(0, SEQ_COLUMNS), lens, lens, errs, out,
                          lens, lens, out) if keep else (out, lens, errs))
    if dicts is not None:
        dicts = dicts.contiguous()
    groups = [(0, nb)] if keep else row_groups(c, out_cap)
    lays = [rows_layout(c[g0:g1], out_cap) for g0, g1 in groups]
    buf = _scratch(dev, *(max(getattr(lay, k) for lay in lays)
                          for k in ("positions", "segments", "rows", "slots")),
                   _rounds(c, out_cap))
    for (g0, g1), lay in zip(groups, lays):
        part = slice(g0, g1)
        got = _launch_group(comps[part], clens[part], c[part], out_cap,
                            None if dicts is None else dicts[part],
                            None if dls is None else dls[part], lay, buf,
                            out[part], lens[part], errs[part], keep)
    return got if keep else (out, lens, errs)


def shared_out() -> int:
    """The largest out_cap whose output the one-warp route keeps in shared
    memory, as built (`csrc/decode.cu` kSharedOut; SHARED_OUT restates
    it)."""
    got = _kernel().lz4t_decode_warp_shared_out()
    if got != SHARED_OUT:
        raise RuntimeError("csrc/decode.cu's kSharedOut differs from SHARED_OUT")
    return got


def warp_shared_bytes(out_cap: int) -> int:
    """The one-warp route's dynamic shared memory a CTA (one row)."""
    return _kernel().lz4t_decode_warp_shared(out_cap)


def _launch_warp(comps, clens, out_cap, dicts, dls, limits=None):
    """One launch of the one-warp route (`decode_rows` in `csrc/decode.cu`:
    a parse warp and a copy warp per row), each row stopping at its limit
    where ``limits`` gives one."""
    dev = comps.device
    comps = comps.contiguous()
    nb = comps.shape[0]
    out = torch.zeros((nb, out_cap), dtype=torch.uint8, device=dev)
    lens = torch.empty((nb,), dtype=torch.int32, device=dev)
    errs = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return out, lens, errs
    if dicts is not None:
        dicts = dicts.contiguous()
    if limits is not None:
        limits = limits.to(dev)
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_decode_warp(
            comps.data_ptr(), comps.stride(0), clens.data_ptr(),
            out.data_ptr(), out_cap,
            dicts.data_ptr() if dicts is not None else None,
            dls.data_ptr() if dls is not None else None,
            limits.data_ptr() if limits is not None else None,
            lens.data_ptr(), errs.data_ptr(), nb,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(rc, "decode (one-warp route)")
    kernel_launches["decode_rows"] += 1
    kernel_launches["decode_rows_limit"] += limits is not None
    return out, lens, errs


ROUTES = {"warp": _launch_warp, "rows": _launch_rows}


def route(rows: int, out_cap: int) -> str:
    """The route of a batch of ``rows`` rows of ``out_cap`` without limits:
    "warp" (the one-warp route) or "rows" (the parallel passes), by
    WARP_ROUTE_ROWS."""
    for cap, fewest in WARP_ROUTE_ROWS:
        if out_cap <= cap:
            return "warp" if rows >= fewest else "rows"
    return "rows"


def _decode(route_name, comps_u8, comp_lens, out_cap: int, dicts_u8=None,
            dict_lens=None, mode: str = "full2", limits=None):
    """`decode_blocks` on ``route_name``: "warp" (the one-warp route), "rows"
    (the parallel passes) or None (`route`; the one-warp route for rows
    with limits, the only one that takes them).  Returns the outputs and
    whether the card ran them (a CPU tensor runs the plain version)."""
    comps, clens, dicts, dls = _validate(
        comps_u8, comp_lens, out_cap, dicts_u8, dict_lens, mode
    )
    lim = _validate_limits(limits, clens.shape[0])
    if comps.device.type != "cuda":
        return decode_blocks_plain(comps, clens, out_cap, dicts, dls, mode,
                                   lim), False
    if lim is not None:
        if route_name == "rows":
            raise ValueError("the parallel passes take no output limit")
        return _launch_warp(comps, clens, out_cap, dicts, dls, lim), True
    if route_name is None:
        route_name = route(comps.shape[0], out_cap)
    return ROUTES[route_name](comps, clens, out_cap, dicts, dls), True


def decode_blocks(comps_u8, comp_lens, out_cap: int, dicts_u8=None,
                  dict_lens=None, mode: str = "full2", limits=None):
    """Decode B independent LZ4 blocks.

    comps_u8: uint8 [B, CAP], row b's compressed bytes at [0, comp_lens[b])
    with >= 20 bytes of padding past the largest length.  dicts_u8: optional
    uint8 [B, 65536] right-aligned dictionaries of dict_lens[b] bytes.
    ``mode`` is one of "full", "full2", "full2v": the TPU kernel's fast-arm
    variants, which give the same bytes; here they all run the same kernel.

    Returns (out uint8 [B, out_cap], lens int32 [B], errs int32 [B]) on the
    input's device: errs is 0 or 1 (malformed), each row on its own; on
    error lens counts the bytes before the failing sequence.  A CPU tensor
    runs the serial plain version.  A CUDA tensor launches the kernel,
    counted here (each of its kernels in `kernel_launches`), on the route
    `route` gives: the one-warp route (`decode_rows`) or the parallel
    passes (every row at once, in groups of rows whose scratch fits
    `GROUP_SCRATCH_BYTES`).

    ``limits`` (int32 [B], -1 for none) makes each row a partial decode
    that stops at its limit (`_decode_row`); rows with limits always take
    the one-warp route, whatever ``out_cap``.
    """
    got, launched = _decode(None, comps_u8, comp_lens, out_cap, dicts_u8,
                            dict_lens, mode, limits)
    decode_blocks.launches += launched
    return got


decode_blocks.launches = 0
# launches of each of kernel A's kernels on the card (rows_jump: one per
# pointer-jumping round enqueued; decode_rows_limit: the decode_rows
# launches with output limits)
kernel_launches = dict.fromkeys(
    ("decode_rows", "decode_rows_limit", "rows_nn", "rows_spans", "rows_hops",
     "rows_table", "rows_literals", "rows_jump", "rows_gather"), 0)
