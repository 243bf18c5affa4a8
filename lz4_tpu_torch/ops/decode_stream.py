"""Kernel C, the streaming decoder, in its two jobs.

The port of `lz4_tpu/ops/decode_pallas_stream.py` (`pallas_decode_stream`,
wrapper `decode_blocks_pallas_stream`):

- `decode_blocks_stream`, the batch form: one block per row at any
  ``out_cap``, with optional dictionaries.  That is exactly kernel A's
  function (`ops/decode.py`), which takes any ``out_cap`` and dictionary
  rows, so it launches kernel A.  The TPU kernel exists because staged
  rows above 64 KB do not fit the TPU's scalar memory; nothing on the card
  needs it.
- `decode_chain`, the chained form: every block of one chained frame at
  once, where the JAX package launches C once per block and carries the
  64 KB window through the host.  One call enqueues the four passes of
  `csrc/decode_stream.cu` on the current stream: parse (every block's
  sequence table), place (each block's start, the window check, the
  status), literals (literal runs and stored blocks in place, an index
  array for the match bytes) and resolve (pointer jumping, then one
  gather).  Beside it: `decode_chain_plain`, the sequential reference (a
  host loop that carries the window from block to block); one plain
  version per pass (`chain_parse_plain`, `chain_place_plain`,
  `chain_literals_plain`, `chain_resolve_plain`); their composition
  `decode_chain_parallel_plain`; and `chain_passes`, every pass's output
  of one decode, for holding each pass to its plain version.  The
  kernel's source says what bounds it on the card and what its design
  does about that.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .build import check, load
from .common import round_up
from .decode import (MIN_MATCH, _decode_row, decode_blocks, jump_plain,
                     kernel_launches, sequence_bytes, spans, used_rows)

STREAM_MODES = ("full", "full2v")
WINDOW = 65536
# the most a compressed block of L bytes can decode to is 255 L: a
# sequence of 3 + k bytes (token, offset, k length extensions) gives at
# most 19 + 255 k
MAX_EXPANSION = 255
# the parse stages a block in shared memory when every compressed block of
# the frame fits compress_bound(64 KB)
STAGE_MAX = WINDOW + WINDOW // 255 + 16
# columns of the sequence table: literal source (in the block's compressed
# bytes), literal length, output position in the block, offset, match
# length (0 for the last, literal-only sequence)
SEQ_COLUMNS = 5
# threads of one literals or resolve CTA, and CTAs per SM for the resolve
_CTA = 256
_CTAS_PER_SM = 8

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("decode_stream")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lz4t_chain_parse.argtypes = [p, p, i, i, p, i, p, p, p, p, p]
        lib.lz4t_chain_place.argtypes = [p, i, p, p, p, p, p, i, p, p, p, p]
        lib.lz4t_chain_literals.argtypes = [p, p, i, i, p, p, p, p, p, p, i, p]
        lib.lz4t_chain_resolve.argtypes = [p, p, p, p, i, i, i, p]
        for fn in (lib.lz4t_chain_parse, lib.lz4t_chain_place,
                   lib.lz4t_chain_literals, lib.lz4t_chain_resolve):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode_blocks_stream(comps_u8, comp_lens, out_cap: int, dicts_u8=None,
                         dict_lens=None, mode: str = "full"):
    """Decode B independent LZ4 blocks at any ``out_cap``, optionally with
    right-aligned 64 KB dictionaries: kernel A's contract
    (`ops.decode.decode_blocks`), which it launches.  ``mode`` is "full" or
    "full2v" (the TPU kernel's fast-arm variants; the same bytes).  A CUDA
    call that enqueues kernel A is counted here too
    (`decode_blocks_stream.launches`)."""
    if mode not in STREAM_MODES:
        raise ValueError(
            f"unknown streaming decode mode {mode!r}; "
            "expected 'full' or 'full2v'"
        )
    enqueued = sum(kernel_launches.values())
    got = decode_blocks(comps_u8, comp_lens, out_cap, dicts_u8, dict_lens,
                        mode=mode)
    decode_blocks_stream.launches += sum(kernel_launches.values()) > enqueued
    return got


decode_blocks_stream.launches = 0


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
    # slot as its cap (every version), so one that broke the bound above
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
    """The sequential plain version of `decode_chain`: a host loop over the
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


# ---- the four passes, plain ----------------------------------------------


def chain_layout(table):
    """Each block's first row in the sequence table (int64 [nb]) and the
    table's row count: len // 3 + 1 rows for a compressed block (every
    sequence but the last takes at least 3 bytes), none for a stored one."""
    tab = torch.as_tensor(table, dtype=torch.int64).cpu().reshape(-1, 3)
    rows = torch.where(tab[:, 2] != 0, 0, tab[:, 1] // 3 + 1)
    return torch.cumsum(rows, 0) - rows, int(rows.sum())


def _parse_block(src: bytes, clen: int, cap: int, rows: list):
    """`_decode_row`'s walk and checks without the copies or the window
    check: appends one row per sequence up to the first failing one to the
    flat list `rows` and returns (decoded size, structural error)."""
    ip = op = err = 0
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
        if q + ll > clen or op + ll > cap:
            err = 1
            break
        lit = q
        q += ll
        if q >= clen:  # the last sequence: literals only
            rows += (lit, ll, op, 0, 0)
            op += ll
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
        if off == 0 or op + ll + ml > cap:
            err = 1
            break
        rows += (lit, ll, op, off, ml)
        op += ll + ml
        ip = q
    if err == 0 and ip != clen:
        err = 2
    return op, err


def chain_parse_plain(frame_u8, table, block_size: int):
    """Pass 1: every compressed block's sequence table, up to its first
    structurally failing sequence (rows at `chain_layout`'s offsets, zeros
    in the rows no sequence took), and per block the sequence count, the
    decoded size and the structural error (int32 [nb] each).  A stored
    block has no rows, its length as its size and no error."""
    raw = torch.as_tensor(frame_u8).cpu().numpy()
    tab = torch.as_tensor(table, dtype=torch.int64).cpu().reshape(-1, 3)
    sbase, nrows = chain_layout(tab)
    nb = tab.shape[0]
    seqs = np.zeros((max(nrows, 1), SEQ_COLUMNS), dtype=np.int32)
    counts = np.zeros((3, nb), dtype=np.int32)  # nseq, size, err
    for k, ((off, length, stored), at) in enumerate(zip(tab.tolist(),
                                                        sbase.tolist())):
        if stored:
            counts[1, k] = length
            continue
        rows = []
        counts[1:, k] = _parse_block(
            raw[off:off + length].tobytes(), length,
            min(length * MAX_EXPANSION, block_size), rows,
        )
        n = len(rows) // SEQ_COLUMNS
        counts[0, k] = n
        seqs[at:at + n] = np.asarray(rows, dtype=np.int32).reshape(n, SEQ_COLUMNS)
    nseq, size, err = torch.from_numpy(counts)
    return torch.from_numpy(seqs), nseq, size, err


def chain_place_plain(table, seqs, nseq, size, err, preset_len: int):
    """Pass 2: each block's start in the stream (the exclusive scan of the
    sizes, int64 [nb]); the window check, an offset past op + ll +
    min(65536, preset_len + start); the status (written, bad, err) of the
    first failing block; and per block the sequences to apply (int32 [nb]:
    up to the first failing one, 1 or 0 for a stored block, 0 past the
    failing block)."""
    tab = torch.as_tensor(table, dtype=torch.int64).cpu().reshape(-1, 3)
    seqs, nseq, size, err = (t.cpu() for t in (seqs, nseq, size, err))
    sbase, _ = chain_layout(tab)
    stored = tab[:, 2] != 0
    n = nseq.to(torch.int64)
    sizes = size.to(torch.int64)
    start = torch.cumsum(sizes, 0) - sizes
    blk, local = spans(n)
    rows = seqs[sbase[blk] + local].to(torch.int64)
    dlen = (preset_len + start[blk]).clamp(max=WINDOW)
    fails = (rows[:, 4] > 0) & (rows[:, 3] > rows[:, 2] + rows[:, 1] + dlen)
    first = n.clone()
    first.scatter_reduce_(0, blk[fails], local[fails], reduce="amin")
    use = torch.where(stored, 1, first)
    bad_blocks = torch.nonzero((err != 0) | (first < n)).flatten()
    if bad_blocks.numel() == 0:
        status = [int(sizes.sum()), -1, 0]
    else:
        bad = int(bad_blocks[0])
        if first[bad] < n[bad]:
            produced = int(seqs[sbase[bad] + first[bad], 2])
            code = 1
        else:
            produced, code = int(size[bad]), int(err[bad])
        status = [int(start[bad]) + produced, bad, code]
        use[bad + 1:] = 0
    return start, use.to(torch.int32), torch.tensor(status, dtype=torch.int64)


def chain_literals_plain(frame_u8, table, seqs, start, use, preset: bytes,
                         cap: int):
    """Pass 3: the buffer [64 KB prefix | stream] (uint8 [65536 + cap]) with
    the preset's last 64 KB right-aligned in the prefix and every applied
    literal run and stored block in place, and the stream's index array
    (int64 [cap], positions in that buffer): a literal or stored byte points to itself,
    byte j of a match of offset `off` at d to d - off + j mod off.  Entries
    past the bytes written point to themselves."""
    frame = torch.as_tensor(frame_u8).cpu()
    tab = torch.as_tensor(table, dtype=torch.int64).cpu().reshape(-1, 3)
    seqs, start, use = (t.cpu() for t in (seqs, start, use))
    sbase, _ = chain_layout(tab)
    out = torch.zeros((WINDOW + cap,), dtype=torch.uint8)
    preset = bytes(preset)[-WINDOW:]
    if preset:
        out[WINDOW - len(preset):WINDOW] = torch.frombuffer(
            bytearray(preset), dtype=torch.uint8)
    ptr = torch.arange(WINDOW, WINDOW + cap, dtype=torch.int64)
    stored = tab[:, 2] != 0
    applied = use.to(torch.int64)
    # stored blocks
    blk, j = spans(torch.where(stored & (applied > 0), tab[:, 1], 0))
    out[WINDOW + start[blk] + j] = frame[tab[blk, 0] + j]
    # literal runs and match bytes
    blk, local = spans(torch.where(stored, 0, applied))
    (seq, src, dst), (seq_m, at, entry) = sequence_bytes(
        *seqs[sbase[blk] + local].to(torch.int64).unbind(1))
    out[WINDOW + start[blk[seq]] + dst] = frame[tab[blk[seq], 0] + src]
    base = start[blk[seq_m]]
    ptr[base + at] = WINDOW + base + entry
    return out, ptr


def chain_resolve_plain(out, ptr, status):
    """Pass 4: pointer jumping over the index array (the prefix's entries
    point to themselves) until no entry changes, then every one of the
    first `written` bytes gathered from the byte it finally points to.
    Returns the buffer and the resolved index array."""
    written = int(status[0])
    out, ptr = out.cpu().clone(), ptr.cpu().to(torch.int64).clone()
    full = jump_plain(ptr[:written], WINDOW)
    ptr[:written] = full
    out[WINDOW:WINDOW + written] = out[full]
    return out, ptr


def decode_chain_parallel_plain(frame_u8, table, block_size: int,
                                dict_u8=None):
    """The four plain passes composed: `decode_chain`'s function, computed
    as the kernel computes it.  Returns (stream, status) on the CPU."""
    return chain_passes(torch.as_tensor(frame_u8).cpu(), table, block_size,
                        None if dict_u8 is None else
                        torch.as_tensor(dict_u8).cpu())[-2:]


class ChainPasses(NamedTuple):
    """Every pass's output of one chained decode: the sequence table and
    its row offsets (parse, `chain_layout`), the per-block counts, sizes
    and errors (parse), the starts, applied counts and status (place), the
    buffer and index array after the literals pass, the index array after
    resolve, and the stream and status `decode_chain` returns."""
    seqs: torch.Tensor
    sbase: torch.Tensor
    nseq: torch.Tensor
    size: torch.Tensor
    err: torch.Tensor
    start: torch.Tensor
    use: torch.Tensor
    lit_out: torch.Tensor
    lit_ptr: torch.Tensor
    ptr: torch.Tensor
    stream: torch.Tensor
    status: torch.Tensor


def chain_passes(frame_u8, table, block_size: int, dict_u8=None):
    """Every pass of one chained decode (`ChainPasses`): the plain versions
    for a CPU tensor, the kernels for a CUDA tensor (then the buffer and
    index array after the literals pass are copies taken before resolve
    runs, and unused sequence-table rows and index entries past the bytes
    written hold whatever the card left there)."""
    frame, tab, cap, preset = _validate_chain(
        frame_u8, table, block_size, dict_u8
    )
    if frame.device.type == "cuda":
        return _launch(frame, tab, block_size, preset, cap, keep=True)
    sbase, _ = chain_layout(tab)
    seqs, nseq, size, err = chain_parse_plain(frame, tab, block_size)
    start, use, status = chain_place_plain(tab, seqs, nseq, size, err,
                                           len(preset))
    lit_out, lit_ptr = chain_literals_plain(frame, tab, seqs, start, use,
                                            preset, cap)
    out, ptr = chain_resolve_plain(lit_out, lit_ptr, status)
    return ChainPasses(seqs, sbase, nseq, size, err, start, use, lit_out,
                       lit_ptr, ptr, out[WINDOW:], status)


# ---- the kernels ---------------------------------------------------------


def _launch(frame, tab, block_size, preset, cap, keep=False):
    """Enqueue the four passes on the current stream; no host round trip
    between them (the sizes they need from one another stay on the card).
    ``keep``: copy the buffer and index array between literals and
    resolve."""
    dev = frame.device
    frame = frame.contiguous()
    nb = tab.shape[0]
    out = torch.zeros((WINDOW + cap,), dtype=torch.uint8, device=dev)
    if preset:
        out[WINDOW - len(preset): WINDOW] = torch.frombuffer(
            bytearray(preset), dtype=torch.uint8
        ).to(dev)
    sbase, nrows = chain_layout(tab)
    if nb == 0:  # no block: nothing to launch
        none = torch.zeros((0,), dtype=torch.int32, device=dev)
        status = torch.tensor([0, -1, 0], dtype=torch.int64, device=dev)
        return ChainPasses(none.reshape(0, SEQ_COLUMNS), sbase, none, none,
                           none, sbase.to(dev), none, out, none, none,
                           out[WINDOW:], status)
    length, stored = tab[:, 1], tab[:, 2] != 0
    longest = int(length[~stored].max()) if bool((~stored).any()) else 0
    stage = round_up(longest, 16) if longest <= STAGE_MAX else 0
    chunks = min(max(-(-int(length.max()) // 4096), 1), 4096)
    wide = WINDOW + cap >= 1 << 31
    rounds = max(cap, 1).bit_length() + 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(sms * _CTAS_PER_SM, -(-cap // _CTA)))

    meta = torch.cat([tab.reshape(-1), sbase]).to(dev)
    tab_d, sbase_d = meta[:3 * nb], meta[3 * nb:]
    seqs = torch.empty((max(nrows, 1), SEQ_COLUMNS), dtype=torch.int32,
                       device=dev)
    nseq, size, err = torch.empty((3, nb), dtype=torch.int32, device=dev)
    start = torch.empty((nb,), dtype=torch.int64, device=dev)
    use = torch.empty((nb,), dtype=torch.int32, device=dev)
    status = torch.empty((3,), dtype=torch.int64, device=dev)
    ptr = torch.empty((max(cap, 1),),
                      dtype=torch.int64 if wide else torch.int32, device=dev)
    flags = torch.zeros((rounds,), dtype=torch.int32, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        s = torch.cuda.current_stream(dev).cuda_stream
        check(lib.lz4t_chain_parse(
            frame.data_ptr(), tab_d.data_ptr(), nb, block_size,
            sbase_d.data_ptr(), stage, seqs.data_ptr(), nseq.data_ptr(),
            size.data_ptr(), err.data_ptr(), s), "decode_chain parse")
        check(lib.lz4t_chain_place(
            tab_d.data_ptr(), nb, seqs.data_ptr(), sbase_d.data_ptr(),
            nseq.data_ptr(), size.data_ptr(), err.data_ptr(), len(preset),
            start.data_ptr(), use.data_ptr(), status.data_ptr(), s),
            "decode_chain place")
        check(lib.lz4t_chain_literals(
            frame.data_ptr(), tab_d.data_ptr(), nb, chunks, seqs.data_ptr(),
            sbase_d.data_ptr(), start.data_ptr(), use.data_ptr(),
            out.data_ptr(), ptr.data_ptr(), int(wide), s),
            "decode_chain literals")
        lit_out = out.clone() if keep else None
        lit_ptr = ptr[:cap].clone() if keep else None
        check(lib.lz4t_chain_resolve(
            ptr.data_ptr(), out.data_ptr(), status.data_ptr(),
            flags.data_ptr(), rounds, grid, int(wide), s),
            "decode_chain resolve")
    decode_chain.launches += 1
    for name in ("chain_parse", "chain_place", "chain_literals", "chain_gather"):
        chain_kernel_launches[name] += 1
    chain_kernel_launches["chain_jump"] += rounds
    return ChainPasses(seqs, sbase, nseq, size, err, start, use, lit_out,
                       lit_ptr, ptr[:cap], out[WINDOW:], status)


def decode_chain(frame_u8, table, block_size: int, dict_u8=None):
    """Decode every block of one chained LZ4 frame.

    frame_u8: uint8 [N], the frame's bytes.  table: int64 [nb, 3], each
    block's (offset in frame_u8, length, stored) as the host scan of the
    block table found them.  dict_u8: optional uint8 [D], a preset
    dictionary (its last 64 KB is the first block's window).  Each block
    decodes into at most ``block_size`` bytes, its matches reaching the
    64 KB before it, across block boundaries and into the dictionary.

    Returns (stream uint8 [CAP], status int64 [3]) on the input's device:
    stream[:written] is the decoded content, zeros follow, and status is
    (written, bad, err): bad is -1, or the index of the first malformed
    block, where the decode stopped, and err its code (1 malformed, 2
    trailing garbage); written then counts that block's bytes up to its
    failing sequence.  A CPU tensor runs the sequential plain version; a
    CUDA tensor enqueues the four passes of the kernel (all blocks at
    once) and counts one launch.
    """
    frame, tab, cap, preset = _validate_chain(
        frame_u8, table, block_size, dict_u8
    )
    if frame.device.type != "cuda":
        return decode_chain_plain(frame, tab, block_size, dict_u8)
    passes = _launch(frame, tab, block_size, preset, cap)
    return passes.stream, passes.status


decode_chain.launches = 0
# launches of each of the chained decoder's kernels on the card (chain_jump:
# one per pointer-jumping round enqueued)
chain_kernel_launches = dict.fromkeys(
    ("chain_parse", "chain_place", "chain_literals", "chain_jump", "chain_gather"), 0)
