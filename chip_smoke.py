#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`lz4_tpu_torch`) on one card.

    python3 chip_smoke.py [--seed N] [--mb 64]

Phases, each fatal on failure:
1. build every kernel from `lz4_tpu_torch/ops/csrc/` (one nvcc per source,
   all started together) and print each one's registers and shared memory
   (`nvcc -Xptxas -v`);
2. kernel B (FAST encode: kernel D's warp scan over B's rows) against its
   plain version on sampled 64 KB rows of every part of the data mix plus
   0-, 1- and 13-byte rows, canonical and dense, acceleration 1 and 8:
   equal bytes, lengths and flags;
3. kernel A (decode) against its plain version on phase 2's output,
   sequence-writer streams (overlapping matches, dictionary reach, long
   length extensions) with known output, and rows with flipped bits, on
   the route `decode.route` gives and on the one-warp route: equal
   lengths, flags and bytes;
4. kernel D (FAST encode at any size, with dictionaries) against its plain
   version: dense 64 KB rows with dictionaries of 0, 100, 4,000 and 65,536
   bytes, canonical rows of 65,546, 65,547, 1 MiB and 4 MiB (the byU16 and
   byU32 tables), acceleration 1 and 8, and windows of the chained
   layout: equal bytes, lengths and flags; then kernel A against its plain
   version at the big-block path's shapes: the 1 MiB and 4 MiB rows and
   copies with flipped bits, at out_cap 1 MiB and 4 MiB;
5. the chained decoder against its plain versions, the whole kernel
   against the sequential one (whole buffer and status) and each of its
   four passes (parse, place, literals, resolve) against its own: a 16 MiB
   chained frame (256 blocks of 64 KB, stored blocks among them), a frame
   whose blocks reach into a preset dictionary, a frame of tiny blocks at
   maximum expansion (each decoded inside its slot of the output), a frame
   whose one fault is an offset past its second block's window (and the
   same frame made valid by a 1-byte preset), two blocks of 3-byte
   sequences that fill their sequence tables, a 1,000-byte block between
   64 KB blocks, 16 MiB of one byte (match chains through every block) and
   frames with a flipped byte (the same failing block, length and code);
6. the main path: `frame.compress(data, EncoderSettings(chain_blocks=False))`
   and `frame.decompress` on --mb MiB (1,024 blocks of 64 KB at the
   default), with every launch count set to 0 just before and read just
   after; the round trip must be exact;
7. the chained path: `frame.compress(data)` with the default
   `EncoderSettings()` and `frame.decompress` on --mb MiB, counts set to 0
   just before and read just after (kernel D and the chained decoder must
   run), exact and deterministic over three runs;
8. the big-block path: an independent frame of 1 MiB blocks over --mb MiB
   (kernels D and A), exact, three runs;
9. the FAST scan's edges (`phase_fast_edges`): kernel D's warp against
   the serial and the batched plain scans on rows of 12, 13, 65,546 and
   65,547 bytes, 4 MiB of zeros and a row whose probes collide in one
   bucket (canonical and dense, acceleration 1 and 8) and on chained
   windows with 64 KB prefixes; kernel A on their compressed rows, the
   corrupt kinds (a flipped token, a cut row, an offset past the output
   start, trailing bytes, length runs that end at the row's end) and
   dictionary rows, each of its passes against its plain version and the
   whole against its one-warp route's lens and errs; the one-warp route's
   edge rows (`hold_warp_edges`: offsets 1-40 and matches from the
   dictionary into the output, limits inside literal runs and matches and
   on sequence ends, compress_bound rows, literal runs longer than the
   ring, out_cap 16/1,000/65,535, rows of 0 and 1 byte, the corrupt kinds,
   rows of up to 1 MiB, rows 1-15 bytes into their chunks), max_abs_err 0
   over the whole output;
10. the FAST row sizes (`phase_fast_rows`): kernels D and A over the --mb
   payload as 64 KB, 1 MiB and 4 MiB rows, timed (CUDA events; A's passes
   by the profiler's device time; A's one-warp route beside it, its whole
   output equal; both routes at 1-1,024 of the 64 KB rows held equal and
   timed per call beside the route rule, `route_counts`; the rule's
   batches above 64 KB, 128 rows of 128 KB and 256 of 256 KB, on both
   routes held equal, to the raw rows and on two rows each to the plain
   version, the rule's route required to be the one-warp route,
   `hold_route_rule_rows`), one row per
   quarter of each timed launch held to the
   serial and batched plain scans and the serial plain decode (in the
   worker pool), and A's passes held to their plain versions on those
   rows; bounds: bytes moved over 3.35 TB/s, and D's dependent steps
   (probe steps and sequences of the slowest picked row, one L1 round
   trip each; `decode_rows`: the slowest picked row's steps in the plain
   model of its schedule (window steps, and sequences and length-extension
   bytes parsed one at a time) at 32 cycles each, `warp_step_bound`);
11. times of kernel D on the chained path's rows and of the chained
   decoder (its passes from the profiler's device time, on the 16 MiB frame
   of phase 5, the --mb MiB frame of phase 7 and a 16 MiB L9 frame), their
   plain versions and bounds, and the end to end compress and decompress
   rates of each path;
12. kernel B's HC and OPT arms (levels 3-9 the three HC passes of
   `csrc/encode_opt.cu` and `csrc/encode_hc_passes.cu`, levels 10-11 the
   chain and match passes and the parse by rounds of `csrc/encode_opt.cu`,
   level 12 its three level 12 passes) against their plain version at
   levels 3, 6, 9, 10, 11 and 12, and the serial HC or OPT arm too: four
   sampled 64 KB rows, the 26,200-byte wordy regression row, rows of 0, 12,
   13 and 4,096 bytes and a 64 KB row of random bytes: equal bytes, lengths
   and flags; and each level 9 pass (`opt_chain`, `hc_deltas`,
   `hc_parse`), level 10 pass (`opt_chain`, `opt_matches`,
   `opt_parse_spec`) and level 12 pass (`opt_chain`, `opt_matches`,
   `opt_parse`) against its own plain version on every row, fed the
   kernel's output of the pass before;
13. kernel D's HC and OPT arms against their plain version at levels 3, 9,
   10 and 12: four chained windows (64 KB blocks with their 64 KB
   prefixes), 64 KB blocks with dictionaries of 3,000, 65,536 and 0 bytes,
   and one 1 MiB row; each level 9, 10 and 12 pass against its plain
   version on the chained windows and the dictionary rows;
14. the HC/OPT paths: 16 MiB round trips at levels 9, 10 and 12, each
   independent (64 KB blocks: the HC or OPT passes over kernel B's rows,
   then kernel A) and with the default chained settings (kernel D's
   passes, then the chained decoder), and at level 11 independent, counts
   set to 0 just before and read just after each path (each level's three
   passes; the serial HC arm at level 9 and the serial OPT arm at 10-12
   must stay at 0), exact and deterministic over three runs after a
   warm-up; the level 9 independent frame of the first 1 MiB equal byte
   for byte to the plain route's (the plain parse of all 16 MiB would take
   minutes); then the serial HC arm at level 9 and the serial OPT arm at
   levels 10, 11 (independent) and 12 timed at their paths' shapes and
   held byte for byte to the plain version on four rows of the timed
   launch, two of them taken by CTAs that had already encoded a row; at
   levels 9, 10 and 12 on both paths and 11 on the independent rows the
   passes' whole output held to the serial arm's on all 256 rows, each
   pass timed (levels 9-11: CUDA events between the passes; level 12:
   profiler device time) and held to its plain version on the same four
   rows (the level 12 parse to its plain parse by rounds, which asserts
   the serial loop's order), every pass's dependent-step bound from the
   plain versions' counts (the chain pass's segment model, beside the
   one-warp schedule's 32-position steps as `serial_step_ms`, the
   match pass's slowest search, the parse's steps beside one thread's
   serial walk of the same row); the chain pass's sort formulation
   (`chain_by_sort`, its `library_ms`) timed on every HC/OPT path and held
   equal to the kernel's prev on the level 9 rows, and the chain pass held
   to its plain version at its segment edges (`hold_chain_edges`: rows
   across the boundaries, windows 1-3 bytes past a 16-byte boundary and
   in a view 1 byte in, a 4 MiB row of zeros, a chained 64 KB + 4 MiB
   window); the device memory of one level 10
   compress; the `lz4 -9` path (`_cli_hc`: 4 MiB independent
   blocks, a content checksum, level 9) over --mb MiB, counts set to 0
   just before and read just after, exact and deterministic over three
   runs after a warm-up, every block of its frame equal to the serial HC
   arm's output on the same rows (timed once beside the passes), the HC
   passes timed on 4 MiB of zeros and of a 3-byte pattern, each equal to
   the serial HC arm's (`hc_repeat_rows`); and one
   profiled level 9 chained, `lz4 -9`, level 10 independent, and level 12
   independent and chained compress and decompress;
15. kernel E (xxHash32) against its plain version: rows of 0-65,536 bytes
   with noise past each length, windows at every alignment of one flat
   tensor, all 1,024 rows of 64 KB of its timed batch and its timed 64 MiB
   window, and single windows of 1 and 4 MiB (the plain hashes of the long
   windows in the worker pool); its times at both shapes (the rows' from
   the profiler's device time, with CUDA events per wrapper call beside
   it; the window's from CUDA events) beside the byte bound and the chain
   bound, each with its cycles a stripe and its time before its redesign
   in brackets; the host hash's time on 4 MiB
   (the route it replaces); then the checksummed paths, counts set to 0
   just before and read just after each, each launching kernel E, exact
   and deterministic over three runs after a warm-up: the `lz4` command
   line's default frames (4 MiB independent blocks, content checksum) over
   --mb MiB, 64 KB independent blocks with block and content checksums over
   --mb MiB, and chained 64 KB blocks with both checksums over --mb MiB;
   and one profiled compress and decompress of each, and the ms of kernel
   E's device time (its content hashes on its side stream) that overlap
   kernel D and the copies between host and card (CUDA events around the
   launches and copies of one more compress and decompress).

16. the host surface (`phase_streaming`): kernel E's streaming form
   (its wrapper `stripes_update`, entry `xxh32_stripes`) against its CPU
   route on windows at starts and lengths 1/15/16/17 with and without a
   carried tail, a 4 MiB window, the timed 1 MiB update and 1 MiB updates
   at odd starts, and
   `XXH32.update` over device updates of 1, 15, 16 and 17 bytes and of
   4 MiB after a carried tail; kernel A's one-warp route with output limits against its
   plain version (limits inside literal runs and overlapping matches,
   dictionaries, rows malformed after the limit); then, counts set to 0
   just before and read just after each (the host's stripe loop must stay
   at 0): `LZ4FrameFile` writes and reads of 1 MiB over --mb MiB at the
   `lz4` CLI default (also of 64 KiB, and of 1 MiB with 12 MiB of extra
   memory: four blocks a launch) and chained with both checksums, each frame equal to
   the one-shot frame; a three-frame stream with a skippable frame; a
   16 MiB legacy frame (8 MiB blocks, A's passes); a ChainDecoder over a
   chained frame's blocks (C's batch form); `partial_decode`, pickle and
   legacy round trips; one `block.decode` and one `partial_decode` alone,
   each required to launch the route the rule gives (a `routes` line);
   the streaming form, the limited route and C's batch form (on each of
   A's routes) timed at their paths' shapes, with step bounds.
17. the dense codecs X1-X3 (`phase_dense`; PyTorch tensor ops, not
   hand-written kernels, so they print a `dense` line of their own): X1 at
   levels 0, 3, 9 and 12 on four 64 KB rows of the mix and X2 on its output
   and a flipped row, on the card against the same functions on the CPU
   (out bytes, lengths, error counts); `frame.compress/decompress` with
   `mesh=make_mesh([card, card])` at FAST independent 64 KB over 16 MiB,
   counts set to 0 just before and read just after (X1, X2, X3 must run,
   kernels B and A must not), exact and deterministic over three runs, the
   first 1 MiB's frame equal to a CPU mesh's; X1, X2 and X3 timed on one row
   group of that path (CUDA events) with their peak memory per row;
   unbounded `block.decode`s needing the first, second and third output
   cap; `compress_distributed`/`decompress_distributed` in two processes on
   the card over gloo, their frames equal to the single-process frames.
18. canonical chained FAST frames (`phase_canonical_chained`, kernel F):
   F against its serial plain version (bytes, lengths) and its warp model
   (each block's probe steps and sequences) on edge frames of 10-, 4,096-,
   65,536- and 262,144-byte blocks (blocks under 13 bytes, a random block
   stored raw, a run block, a last block of 5, 7 and 12 bytes, an exact
   multiple; windows staged in shared memory and read from the payload),
   one launch a frame, F's rounds (at the default `max_rounds`, at 0, the
   serial tail alone, and at 1) against their CPU model
   (`continue_blocks_rounds`: bytes, rounds, blocks walked per round,
   where the tail began, each block's walks) on the edge frames and 1 MiB
   of the mix, and `frame.compress` on the card equal to the CPU route's
   frame; then `frame.compress/decompress` with
   `EncoderSettings(geometry="canonical", content_checksum=True)` over a
   16 MiB payload of 64 KB blocks, counts set to 0 just before and read
   just after (F once a compress, kernels D and B never), exact and
   deterministic over three runs after a warm-up, every block at the
   default `max_rounds`, at 0 and at 1 equal to `continue_blocks_plain`
   over the frame (timed in a worker) and to the warp model, the first
   1 MiB's to `continue_blocks_plain` on that 1 MiB alone; the rounds and
   the re-walks by quarter of the mix; F timed (CUDA events) at the
   default and at `max_rounds=0`, beside its bound (the slowest block's
   probe steps and sequences at 32 cycles each, or its bytes) and the
   serial schedule's (every block's steps), and at the caps of
   `CONTINUE_SWEEP`; the same timings and bounds on the frames of
   `CONTINUE_FRAMES` (16 MiB of the mix's noise in 64 KB blocks, the mix
   in 256 KB and 4 MB blocks, the walks that read the payload), with no
   cap too, every block equal to the serial plain version; F on payloads
   that start 1 and 3 bytes into their tensor (1 MiB of the mix) and 1
   byte (each frame of `CONTINUE_FRAMES`);
19. `hash5_rows` (`phase_hash5`, the byU32 hash D and F call) against its
   plain version on the vectors of `experiments/tests/test_canon_hash32.py`
   and 2^20 more, timed by CUDA events around launches queued behind a
   device sleep (`_queued_ms`);
20. the micro-benchmarks (`phase_ubench`, `csrc/ubench.cu`): each of the
   22 loops' cycles per iteration as the slope of its clock64() span
   between 200,000 and 1,000,000 iterations, its accumulators at 200,000
   held to the plain version (in the worker pool); a `ubench` line.

Prints a `kernels` JSON line, a `canonical_chained` and a `ubench` line,
the card's name and power limit, and as the last line {"ok": true,
"device": {...}}.  Exits non-zero, printing no
result, without a CUDA card or without the package beside it.  The data is
made with numpy from --seed.  No PyTorch call computes LZ4 or xxHash32, so
library_ms is null for every kernel but the chain pass (`opt_chain`):
its function is a stable sort of each row's positions by hash, which one
`torch.sort` computes (`chain_by_sort`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import importlib
import json
import os
import random
import struct
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
BLOCK = 65536
CLI_BLOCK = 4 << 20  # the `lz4` command line's default block


def _cli_default():
    """`lz4`'s command-line defaults: independent 4 MB blocks and a content
    checksum (lz4io.c's preferences)."""
    from lz4_tpu_torch import frame

    return frame.EncoderSettings(chain_blocks=False, block_size=4 << 20,
                                 content_checksum=True)


def make_corpus(total_bytes: int, seed: int) -> bytes:
    """The repo's benchmark mix in four quarters: text-like words,
    structured records, runs, and low-entropy noise."""
    rng = np.random.default_rng(seed)
    parts = []
    quarter = total_bytes // 4
    vocab = [
        b"the ", b"compression ", b"of ", b"data ", b"lorem ", b"ipsum ",
        b"block ", b"stream ", b"frame ", b"hash ", b"match ", b"literal ",
        b"sequence ", b"offset ", b"window ", b"dictionary ",
    ]
    words = rng.integers(0, len(vocab), quarter // 4)
    parts.append(b"".join(vocab[w] for w in words)[:quarter])
    rec = np.zeros((quarter // 64 + 1, 64), np.uint8)
    rec[:, :16] = np.arange(16, dtype=np.uint8)
    rec[:, 16:32] = rng.integers(0, 4, (rec.shape[0], 16), dtype=np.uint8)
    rec[:, 32:] = (np.arange(rec.shape[0], dtype=np.uint32)[:, None]
                   .view(np.uint8).reshape(rec.shape[0], 4).repeat(8, axis=1))
    parts.append(rec.tobytes()[:quarter])
    run_lens = rng.integers(3, 60, quarter // 10)
    vals = rng.integers(0, 256, quarter // 10, dtype=np.uint8)
    parts.append(np.repeat(vals, run_lens).tobytes()[:quarter])
    noise = (rng.integers(0, 16, total_bytes - 3 * quarter) * 13).astype(np.uint8)
    parts.append(noise.tobytes())
    return b"".join(parts)[:total_bytes]


def wordy_row() -> bytes:
    """The 26,200-byte wordy row (repeated short phrases, noise, zeros) that
    exposed the chain offset after a chain-swap jump in the TPU kernel: the
    bytes of tests/test_pallas_encode5.py's regression case."""
    rng = random.Random(33)
    words = [rng.randbytes(rng.randint(3, 8)) for _ in range(30)]
    big = 131072
    return (b" ".join(rng.choice(words) for _ in range(big))[: big // 2]
            + rng.randbytes(big // 4) + bytes(big // 4))[:26200]


def _vle(out: bytearray, v: int) -> None:
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def write_stream(rng, window: bytes, limit: int):
    """A valid LZ4 block from seeded random sequences, and the bytes it
    decodes to: offsets 1-7 (overlapping copies), offsets that reach into
    the right-aligned dictionary `window`, and literal and match lengths of
    15, 270 and more (length-extension bytes)."""
    comp, hist = bytearray(), bytearray(window)
    while True:
        ll = int(rng.choice([0, 1, 7, 14, 15, 16, 270, 300]))
        ml = int(rng.choice([4, 5, 18, 19, 20, 270, 300, 700]))
        if len(hist) - len(window) + ll + ml + 300 > limit:
            break
        ll = max(ll, 8 - len(hist))  # something to match against
        reach = len(hist) + ll
        off = int(rng.integers(1, 8) if rng.integers(0, 2) else rng.integers(1, reach + 1))
        off = min(off, reach, 65535)
        comp.append((min(ll, 15) << 4) | min(ml - 4, 15))
        if ll >= 15:
            _vle(comp, ll - 15)
        lits = rng.integers(0, 256, ll, dtype=np.uint8).tobytes()
        comp += lits
        comp += off.to_bytes(2, "little")
        if ml >= 19:
            _vle(comp, ml - 19)
        hist += lits
        for _ in range(ml):
            hist.append(hist[-off])
    ll = int(rng.integers(0, 40))
    lits = rng.integers(0, 256, ll, dtype=np.uint8).tobytes()
    comp.append(min(ll, 15) << 4)
    if ll >= 15:
        _vle(comp, ll - 15)
    comp += lits
    hist += lits
    return bytes(comp), bytes(hist[len(window):])


def _require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _max_abs_err(got, want) -> int:
    import torch

    worst = 0
    for g, w in zip(got, want):
        _require(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            d = (g.cpu().to(torch.int64) - w.cpu().to(torch.int64)).abs().max()
            worst = max(worst, int(d))
    return worst


def phase_build():
    from lz4_tpu_torch.ops import build, encode_opt, encode_stream

    t0 = time.perf_counter()
    logs = build.build(*build.KERNEL_SOURCES)
    print(f"[build] {len(logs)} sources in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if ("ptxas" in line or "spill" in line) and "Compile" not in line:
                print(f"[build] {name}.cu: {line.strip()}")
    from lz4_tpu_torch.ops import decode

    _require(decode.shared_out() == decode.SHARED_OUT,
             "decode.SHARED_OUT differs from the one-warp route's")
    print(f"[build] decode.cu: decode_rows (the one-warp route) dynamic shared memory "
          f"{decode.warp_shared_bytes(BLOCK)} bytes per CTA at out_cap 64 KB, "
          f"{decode.warp_shared_bytes(1 << 20)} above {decode.SHARED_OUT} (output in "
          f"place); the passes 0 (rows_spans: 49,152 bytes static); decode_stream.cu: 0")
    for geometry, longest, what in (("canonical", 1 << 22, "canonical"),
                                    ("dense", 1 << 16, "dense, windows <= 64 KB"),
                                    ("dense", 1 << 17, "dense, longer windows")):
        print(f"[build] encode_stream.cu: dynamic shared memory "
              f"{encode_stream.shared_bytes(geometry, longest=longest)} bytes per CTA "
              f"({what})")
    for arm, level in (("HC", 9), ("OPT", 12)):
        print(f"[build] encode_stream.cu: dynamic shared memory "
              f"{encode_stream.shared_bytes('canonical', level)} bytes per CTA "
              f"({arm} arm), plus a 131,072-byte head table per resident CTA "
              f"in device memory")
    for name, smem in encode_opt.shared_bytes().items():
        print(f"[build] encode_opt.cu: dynamic shared memory {smem} bytes per "
              f"CTA ({name})")
    _require(encode_opt.slice_positions() == encode_opt.SLICE,
             "encode_opt.SLICE differs from the match kernel's slice")
    _require(encode_opt.chain_segment() == encode_opt.CHAIN_SEGMENT,
             "encode_opt.CHAIN_SEGMENT differs from the chain kernel's segment")
    print(f"[build] encode_opt.cu: the chain walk's segments of {encode_opt.CHAIN_SEGMENT} "
          f"positions, {encode_opt.chain_ctas_per_sm()} CTAs an SM")
    print("[build] encode_hc_passes.cu: dynamic shared memory 0 bytes per CTA")
    print("[build] encode_continue.cu: 16,384 bytes of static shared memory per CTA "
          "(a block's byU32 table; continue_setup and continue_check 0); ubench.cu: "
          "32,768 bytes static")


def sample_rows(data: bytes, rng):
    """Two 64 KB rows from each quarter of the mix, then 0-, 1- and
    13-byte rows."""
    nb = len(data) // BLOCK
    picks = [int(q * nb // 4 + rng.integers(0, nb // 4)) for q in (0, 0, 1, 1, 2, 2, 3, 3)]
    rows = [data[k * BLOCK:(k + 1) * BLOCK] for k in picks]
    rows += [b"", rng.integers(0, 256, 1, dtype=np.uint8).tobytes(),
             rng.integers(0, 256, 13, dtype=np.uint8).tobytes()]
    return rows


def _stage(rows, width):
    import torch

    bufs = torch.zeros((len(rows), width), dtype=torch.uint8)
    lens = torch.zeros((len(rows),), dtype=torch.int32)
    for i, r in enumerate(rows):
        if r:
            bufs[i, :len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
        lens[i] = len(r)
    return bufs, lens


def phase_encode(rows, dev):
    import torch
    from lz4_tpu_torch.ops import encode

    bufs, lens = _stage(rows, BLOCK + 1024)
    worst, outs = 0, {}
    for geometry in ("canonical", "dense"):
        for accel in (1, 8):
            got = encode.encode_blocks(bufs.to(dev), lens.to(dev), BLOCK, 0, accel, geometry)
            torch.cuda.synchronize()
            want = encode.encode_blocks_plain(bufs, lens, BLOCK, 0, accel, geometry)
            err = _max_abs_err(got, want)
            _require(err == 0, f"encode {geometry} accel={accel}: kernel != plain")
            _require(not bool(want[2].any()), "encode overflow flag set")
            worst = max(worst, err)
            outs[(geometry, accel)] = [
                want[0][i, :int(want[1][i])].numpy().tobytes() for i in range(len(rows))
            ]
            print(f"[encode] {geometry} accel={accel}: {len(rows)} rows equal, "
                  f"clens={want[1].tolist()}")
    return worst, outs


def phase_decode(streams, rng, dev):
    import torch
    from lz4_tpu_torch.ops import decode
    from lz4_tpu_torch.parallel.blocks import comp_capacity

    cap = comp_capacity(BLOCK)
    flipped = []
    for k in range(24):
        c = bytearray(streams[k % len(streams)])
        for _ in range(int(rng.integers(1, 6))):
            c[int(rng.integers(0, len(c)))] ^= 1 << int(rng.integers(0, 8))
        flipped.append(bytes(c))
    worst = 0
    rows = streams + flipped
    comps, clens = _stage(rows, cap)
    for out_cap in (BLOCK, 4096):
        got = decode.decode_blocks(comps.to(dev), clens.to(dev), out_cap)
        warp, _ = decode._decode("warp", comps.to(dev), clens.to(dev), out_cap)
        torch.cuda.synchronize()
        want = decode.decode_blocks_plain(comps, clens, out_cap)
        err = max(_max_abs_err(got, want), _max_abs_err(warp, want))
        _require(err == 0, f"decode out_cap={out_cap}: kernel != plain")
        worst = max(worst, err)
        print(f"[decode] out_cap={out_cap}: {len(rows)} rows equal on the route rule's "
              f"route and the one-warp route ({int((want[2] != 0).sum())} flagged), flips "
              f"{len(flipped)}")
    # sequence-writer streams with right-aligned dictionaries
    windows, synth, expect = [], [], []
    for k in range(32):
        wlen = int(rng.choice([0, 1, 100, 4000, 65536]))
        window = rng.integers(0, 256, wlen, dtype=np.uint8).tobytes()
        c, o = write_stream(rng, window, BLOCK)
        windows.append(window)
        synth.append(c)
        expect.append(o)
    comps, clens = _stage(synth, cap)
    dicts = torch.zeros((len(synth), 65536), dtype=torch.uint8)
    dlens = torch.tensor([len(w) for w in windows], dtype=torch.int32)
    for i, w in enumerate(windows):
        if w:
            dicts[i, 65536 - len(w):] = torch.frombuffer(bytearray(w), dtype=torch.uint8)
    args = comps.to(dev), clens.to(dev), BLOCK, dicts.to(dev), dlens.to(dev)
    got = decode.decode_blocks(*args)
    warp = decode._launch_warp(*args)
    torch.cuda.synchronize()
    want = decode.decode_blocks_plain(comps, clens, BLOCK, dicts, dlens)
    err = max(_max_abs_err(got, want), _max_abs_err(warp, want))
    _require(err == 0, "decode with dictionaries: kernel != plain")
    worst = max(worst, err)
    out, lens, errs = (t.cpu() for t in got)
    for i, o in enumerate(expect):
        _require(int(errs[i]) == 0 and out[i, :int(lens[i])].numpy().tobytes() == o,
                 f"sequence-writer row {i} did not decode to its expected bytes")
    print(f"[decode] {len(synth)} sequence-writer rows with dictionaries equal "
          f"and exact (the route rule's route and the one-warp route)")
    return worst


def with_content_length(blob: bytes, n: int) -> bytes:
    """``blob``, a frame whose header carries a content length, with that
    length set to ``n`` and the header's checksum byte made anew: the
    header is valid, the length false."""
    from lz4_tpu_torch.xxh32 import xxh32

    flg = blob[4]
    _require(flg & 0x08, "the frame's header carries no content length")
    end = 14 + (4 if flg & 0x01 else 0)  # FLG, BD, the length, a dictionary ID
    head = bytearray(blob[:end + 1])
    struct.pack_into("<Q", head, 6, n)
    head[end] = (xxh32(bytes(head[4:end])) >> 8) & 0xFF
    return bytes(head) + blob[end + 1:]


def _round_trips(data: bytes, settings, dev, counts, kernels=(), idle=(), frames=None):
    """Three timed compress + decompress runs of one path, the launch
    counts set to 0 just before the first and read just after it: each
    wrapper's in `counts` and in ``idle``, and kernel A's kernels named in
    ``kernels`` (`decode.kernel_launches`).  Each count of `counts` and
    ``kernels`` must be above 0, each of ``idle`` (a reference the path
    must not launch) 0; the host's stripe loop (`lz4_tpu_torch.xxh32.
    host_stripes`) is idle on every path.  Each compress's device memory
    at its peak above what was held before it is read outside the timed
    span (`compress_peak_allocated_bytes`, the largest); ``frames``, if
    given, gets the frame."""
    import torch
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import decode

    host = importlib.import_module("lz4_tpu_torch.xxh32")  # the module, not the function
    idle = (*idle, host.host_stripes)  # the plain stripe loop: 0 on every path
    warm = frame.compress(data[:4 * BLOCK], settings, device=dev)
    _require(frame.decompress(warm, device=dev) == data[:4 * BLOCK], "warm-up round trip")
    for fn in (*counts, *idle):
        fn.launches = 0
    for k in decode.kernel_launches:
        decode.kernel_launches[k] = 0
    times, blob, launches, peak = [], None, None, 0
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held_before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        b = frame.compress(data, settings, device=dev)
        t1 = time.perf_counter()
        peak = max(peak, torch.cuda.max_memory_allocated(dev) - held_before)
        back = frame.decompress(b, device=dev)
        times.append((t1 - t0, time.perf_counter() - t1))
        if launches is None:
            launches = {fn.__name__: fn.launches for fn in counts}
            launches.update({k: decode.kernel_launches[k] for k in kernels})
            unused = {fn.__name__: fn.launches for fn in idle}
        _require(back == data, "round trip is not exact")
        _require(blob is None or b == blob, "compress is not deterministic")
        blob = b
    for name, n in launches.items():
        _require(n > 0, f"path never launched {name}")
    for name, n in unused.items():
        _require(n == 0, f"path launched {name}, which it must not run, {n} times")
    launches.update(unused)
    if frames is not None:
        frames.append(blob)
    c_s = statistics.median(t[0] for t in times)
    d_s = statistics.median(t[1] for t in times)
    return launches, {
        "bytes": len(data), "frame_bytes": len(blob),
        "compress_s": [t[0] for t in times], "decompress_s": [t[1] for t in times],
        "compress_GBps_median": len(data) / c_s / 1e9,
        "decompress_GBps_median": len(data) / d_s / 1e9,
        "compress_peak_allocated_bytes": peak,
    }


def phase_main_path(data: bytes, dev):
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import decode, encode

    launches, e2e = _round_trips(
        data, frame.EncoderSettings(chain_blocks=False), dev,
        [encode.encode_blocks, decode.decode_blocks], ("decode_rows",))
    print(f"[main] {len(data)} bytes -> {e2e['frame_bytes']} bytes "
          f"(ratio {len(data) / e2e['frame_bytes']:.4f}), round trip exact, "
          f"launches {launches}")
    return launches, e2e


def chained_windows(nbytes: int, block_size: int, preset_len: int = 0):
    """The windows of a chained frame's blocks in a payload that holds a
    preset_len-byte dictionary, then the frame's nbytes of content:
    (starts, src_offs, lens), each block with the <= 64 KB before it."""
    import torch

    nb = -(-nbytes // block_size)
    blk = torch.arange(nb, dtype=torch.int64) * block_size + preset_len
    dls = blk.clamp(max=65536)
    ends = (blk + block_size).clamp(max=preset_len + nbytes)
    return blk - dls, dls, ends - blk + dls


def chained_frame(body: bytes, preset: bytes, dev) -> bytes:
    """A chained frame of 64 KB blocks whose first block may reach into the
    last 64 KB of `preset` (kernel D over one payload [preset | body])."""
    import torch
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.frame.api import _assemble_frame
    from lz4_tpu_torch.ops import encode_stream
    from lz4_tpu_torch.parallel.blocks import pack_blocks

    pre = preset[-65536:]
    payload = torch.frombuffer(bytearray(pre + body), dtype=torch.uint8).to(dev)
    starts, offs, lens = chained_windows(len(body), BLOCK, len(pre))
    out, clens, errs = encode_stream.encode_windows(
        payload, starts, offs, lens, BLOCK, fast_schedule="dense")
    _require(not bool(errs.any()), "chained frame with a dictionary: overflow")
    return _assemble_frame(frame.EncoderSettings().to_descriptor(), body,
                           BLOCK, pack_blocks(out, clens))


def phase_encode_stream(data: bytes, rng, dev):
    """Kernel D against its plain version."""
    import torch
    from lz4_tpu_torch.ops import encode_stream

    worst = 0

    def hold(what, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        _require(err == 0, f"encode_stream {what}: kernel != plain")
        _require(not bool(want[2].any()), f"encode_stream {what}: overflow flag set")
        worst = max(worst, err)
        print(f"[encode_stream] {what}: {want[1].numel()} rows equal, "
              f"clens={want[1].tolist()}")

    nb = len(data) // BLOCK
    picks = [int(rng.integers(1, nb)) for _ in range(4)]
    bufs, lens = _stage([data[k * BLOCK:(k + 1) * BLOCK] for k in picks], BLOCK)
    dls = torch.tensor([0, 100, 4000, 65536], dtype=torch.int32)
    dicts = torch.zeros((len(picks), 65536), dtype=torch.uint8)
    for i, (k, dl) in enumerate(zip(picks, dls.tolist())):
        if dl:
            dicts[i, 65536 - dl:] = torch.frombuffer(
                bytearray(data[k * BLOCK - dl:k * BLOCK]), dtype=torch.uint8)
    for accel in (1, 8):
        got = encode_stream.encode_blocks_stream(
            bufs.to(dev), lens.to(dev), BLOCK, 0, accel, dicts.to(dev), dls.to(dev))
        hold(f"dense, dictionaries {dls.tolist()}, accel={accel}", got,
             encode_stream.encode_blocks_stream_plain(
                 bufs, lens, BLOCK, 0, accel, dicts, dls))
    sizes = [65546, 65547, 1 << 20, 4 << 20]
    starts = [int(rng.integers(0, len(data) - n)) for n in sizes]
    sources = [data[a:a + n] for a, n in zip(starts, sizes)]
    bcap = max(sizes)
    bufs, lens = _stage(sources, bcap)
    for accel in (1, 8):
        got = encode_stream.encode_blocks_stream(
            bufs.to(dev), lens.to(dev), bcap, 0, accel)
        want = encode_stream.encode_blocks_stream_plain(bufs, lens, bcap, 0, accel)
        hold(f"canonical rows of {sizes} bytes, accel={accel}", got, want)
        if accel == 1:
            big = [(want[0][i, :int(want[1][i])].numpy().tobytes(), sources[i])
                   for i in (2, 3)]
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    st, offs, wl = chained_windows(len(data), BLOCK)
    rows = sorted({0, 1, nb - 1} | {int(x) for x in rng.integers(2, nb, 5)})
    got = encode_stream.encode_windows(
        payload.to(dev), st[rows], offs[rows], wl[rows], BLOCK,
        fast_schedule="dense")
    hold(f"chained windows of blocks {rows}", got,
         encode_stream.encode_windows_plain(
             payload, st[rows], offs[rows], wl[rows], BLOCK,
             fast_schedule="dense"))
    return worst, big


def phase_decode_big(big, rng, dev):
    """Kernel A against its plain version at the big-block path's shapes:
    phase 4's 1 MiB and 4 MiB canonical rows and copies with flipped bits,
    at out_cap 1 MiB and 4 MiB, rows of comp_capacity(out_cap) bytes (a
    stream longer than a row is cut short: one more corrupt row)."""
    import torch
    from lz4_tpu_torch.ops import decode
    from lz4_tpu_torch.parallel.blocks import comp_capacity

    worst = 0
    for k, out_cap in enumerate((1 << 20, 4 << 20)):
        width = comp_capacity(out_cap)
        rows = [c[:width - 20] for c, _ in big]
        for _ in range(4):
            c = bytearray(rows[k])
            for _ in range(int(rng.integers(1, 4))):
                c[int(rng.integers(0, len(c)))] ^= 1 << int(rng.integers(0, 8))
            rows.append(bytes(c))
        comps, clens = _stage(rows, width)
        got = decode.decode_blocks(comps.to(dev), clens.to(dev), out_cap)
        torch.cuda.synchronize()
        want = decode.decode_blocks_plain(comps, clens, out_cap)
        err = _max_abs_err(got, want)
        _require(err == 0, f"decode out_cap={out_cap}: kernel != plain")
        worst = max(worst, err)
        out, lens, errs = want
        for i, (c, src) in enumerate(big):
            if len(c) <= width - 20 and len(src) <= out_cap:
                _require(int(errs[i]) == 0 and out[
                    i, :int(lens[i])].numpy().tobytes() == src,
                    f"decode out_cap={out_cap}: row {i} is not its source")
        print(f"[decode] out_cap={out_cap}: {len(rows)} rows equal, "
              f"errs={errs.tolist()}, lens={lens.tolist()}")
    return worst


def expansion_frame(ks=(0, 1, 2, 7, 50, 200, 255, 256)) -> bytes:
    """A chained frame of tiny blocks that each decode to close to 255
    times their length: one offset-1 match into the byte before it, its
    length extended by k bytes of 255 and one of 254, then an empty last
    sequence, 19 + 255 k + 254 bytes in all (past 64 KB at k = 256, where
    the block fails).  Its first block reaches into a preset dictionary."""
    from lz4_tpu_torch import frame

    parts = [frame.build_header(frame.EncoderSettings().to_descriptor())]
    for k in ks:
        blk = bytes([0x0F, 1, 0]) + b"\xff" * k + bytes([254, 0])
        parts += [struct.pack("<I", len(blk)), blk]
    return b"".join(parts) + bytes(4)


def _chained_frame_of(blocks) -> bytes:
    """A chained frame of 64 KB blocks around the given compressed blocks."""
    from lz4_tpu_torch import frame

    parts = [frame.build_header(frame.EncoderSettings().to_descriptor())]
    for blk in blocks:
        parts += [struct.pack("<I", len(blk)), blk]
    return b"".join(parts) + bytes(4)


def window_fault_frame() -> bytes:
    """A chained frame whose one fault is an offset past the window of its
    second block, min(65536, preset + start) bytes: block 0 is 100 literal
    bytes; block 1 four literals and an offset-50 match, then a match at
    offset 109, one byte past op + ll + 100 = 108 without a preset
    dictionary (block 1 fails with code 1 after 108 bytes) and inside it
    with a preset of at least one byte; block 2 five literals and an
    offset-110 match, back into block 0."""
    lits = bytes(range(1, 101))
    return _chained_frame_of([
        bytes([0xF0, 85]) + lits,
        bytes([0x40]) + lits[:4] + (50).to_bytes(2, "little")
        + bytes([0x00]) + (109).to_bytes(2, "little") + bytes([0x00]),
        bytes([0x50]) + lits[10:15] + (110).to_bytes(2, "little") + bytes([0x00]),
    ])


def densest_frame(k: int = 16000) -> bytes:
    """A chained frame of two blocks of 3-byte sequences (a token and an
    offset of 1, no literals) after one literal: each fills the len // 3 + 1
    rows of its sequence table exactly, and each match copies the one
    before it (a chain as deep as the sequences)."""
    blk = bytes([0x10, 0x61, 1, 0]) + bytes([0x00, 1, 0]) * k + bytes([0x00])
    return _chained_frame_of([blk, blk])


def short_block_frame(data: bytes, dev, sizes=(65536, 1000, 65536, 30000)):
    """A chained frame whose second block decodes to 1,000 bytes, fewer
    than the block size (a writer that flushed early), with the blocks
    after it reaching back across it: each block encoded by the block API
    with the 64 KB before it as its dictionary.  Returns (frame, content)."""
    from lz4_tpu_torch import block

    blocks, at = [], 0
    for n in sizes:
        blocks.append(block.encode(data[at:at + n],
                                   dictionary=data[max(0, at - 65536):at],
                                   device=dev))
        at += n
    return _chained_frame_of(blocks), data[:at]


def deep_chain_frame(nbytes: int, dev):
    """A chained frame (the default settings) of one byte repeated: each
    block's matches copy the end of the block before, so a byte of the last
    block reaches its literal through every block before it.  Returns
    (frame, content)."""
    from lz4_tpu_torch import frame

    body = b"\x61" * nbytes
    return frame.compress(body, device=dev), body


def with_stored_blocks(data: bytes, rng) -> bytes:
    """`data` with eight 64 KB blocks of its noise quarter replaced by
    uniform random bytes, which LZ4 cannot shrink: the frame stores them."""
    buf = bytearray(data)
    nb = len(data) // BLOCK
    for k in rng.choice(np.arange(3 * nb // 4, nb), 8, replace=False):
        buf[k * BLOCK:(k + 1) * BLOCK] = rng.integers(
            0, 256, BLOCK, dtype=np.uint8).tobytes()
    return bytes(buf)


def chain_inputs(blob: bytes, preset: bytes | None = None):
    """A chained frame's decoder inputs on the host: (frame, block table,
    block size, preset dictionary or None)."""
    import torch
    from lz4_tpu_torch.frame.api import _scan_single_frame

    d, blocks, _ = _scan_single_frame(blob)
    table = torch.tensor(blocks, dtype=torch.int64).reshape(-1, 3)
    fr = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    pre = None if preset is None else torch.frombuffer(
        bytearray(preset), dtype=torch.uint8)
    return fr, table, d.block_size, pre


def hold_chain_passes(fr, table, block_size: int, pre, dev) -> dict:
    """Each pass of the chained decoder on the card against its plain
    version on the same inputs (the kernel's own output of the pass
    before): the parse's filled sequence-table rows, counts, sizes and
    errors; place's starts, applied counts and status; the buffer and the
    index array (up to the bytes written) after the literals pass; the
    index array and the stream after resolve.  Returns each pass's
    max_abs_err."""
    import torch
    from lz4_tpu_torch.ops import decode_stream as ds

    got = ds.chain_passes(fr.to(dev), table, block_size,
                          None if pre is None else pre.to(dev))
    torch.cuda.synchronize()
    g = ds.ChainPasses(*(t.cpu() for t in got))
    preset = b"" if pre is None else pre[-ds.WINDOW:].numpy().tobytes()
    seqs, nseq, size, err = ds.chain_parse_plain(fr, table, block_size)
    rows = ds.used_rows(g.sbase, nseq)
    errs = {"parse": _max_abs_err(
        [g.nseq, g.size, g.err, g.seqs[rows]], [nseq, size, err, seqs[rows]])}
    start, use, status = ds.chain_place_plain(
        table, g.seqs, g.nseq, g.size, g.err, len(preset))
    errs["place"] = _max_abs_err([g.start, g.use, g.status], [start, use, status])
    n = int(g.status[0])
    out, ptr = ds.chain_literals_plain(fr, table, g.seqs, g.start, g.use,
                                       preset, g.stream.numel())
    errs["literals"] = _max_abs_err(
        [g.lit_out, g.lit_ptr[:n].to(torch.int64)], [out, ptr[:n]])
    out, ptr = ds.chain_resolve_plain(g.lit_out, g.lit_ptr, g.status)
    errs["resolve"] = _max_abs_err(
        [g.ptr[:n].to(torch.int64), g.stream], [ptr[:n], out[ds.WINDOW:]])
    return errs


def phase_decode_chain(data: bytes, rng, dev):
    """The chained decoder against its plain versions: the whole kernel
    against the sequential plain version (whole buffer and status), and
    each pass against its own plain version.  Returns the worst difference
    (and each pass's), the sequential plain version's time on the 16 MiB
    frame, and that frame."""
    import torch
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.frame.api import _scan_single_frame
    from lz4_tpu_torch.ops import decode_stream

    worst = 0
    pass_err = dict.fromkeys(("parse", "place", "literals", "resolve"), 0)

    def hold(what, blob, preset=None, expect=None):
        nonlocal worst
        fr, table, block_size, pre = chain_inputs(blob, preset)
        got = decode_stream.decode_chain(
            fr.to(dev), table, block_size, None if pre is None else pre.to(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = decode_stream.decode_chain_plain(fr, table, block_size, pre)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _max_abs_err(got, want)
        _require(err == 0, f"decode_chain {what}: kernel != plain")
        passes = hold_chain_passes(fr, table, block_size, pre, dev)
        for name, e in passes.items():
            _require(e == 0, f"decode_chain {what}: the {name} pass != plain")
            pass_err[name] = max(pass_err[name], e)
        worst = max(worst, err, *passes.values())
        status = tuple(want[1].tolist())
        if expect is not None:
            _require(status[1] == -1 and
                     want[0][:status[0]].numpy().tobytes() == expect,
                     f"decode_chain {what}: not the payload")
        print(f"[decode_chain] {what}: {table.shape[0]} blocks "
              f"({int(table[:, 2].sum())} stored), status (written, bad, err) "
              f"{status} equal, each pass equal to its plain version")
        return status, plain_ms

    body = with_stored_blocks(data, rng)
    big = frame.compress(body, frame.EncoderSettings(), device=dev)
    _, plain_ms = hold("16 MiB chained frame", big, expect=body)
    preset = data[:100000]
    part = data[len(data) // 2:len(data) // 2 + (2 << 20)]
    hold("2 MiB chained frame with a preset dictionary",
         chained_frame(part, preset, dev), preset, expect=part)
    status, _ = hold("tiny blocks at maximum expansion", expansion_frame(), preset)
    _require(status[1:] == (7, 1), "the block past 64 KB did not fail")
    status, _ = hold("an offset past the window of block 1", window_fault_frame())
    _require(status == (108, 1, 1), "the window fault was not found")
    hold("the same frame with a 1-byte preset dictionary",
         window_fault_frame(), b"x")
    hold("3-byte sequences filling their tables", densest_frame(),
         expect=b"a" * 128010)
    blob, body = short_block_frame(data, dev)
    hold("a 1,000-byte block between 64 KB blocks", blob, expect=body)
    blob, body = deep_chain_frame(len(data), dev)
    hold(f"one byte repeated {len(data)} times (deep match chains)", blob,
         expect=body)
    small = frame.compress(part[:4 * BLOCK], frame.EncoderSettings(), device=dev)
    _, blocks, _ = _scan_single_frame(small)
    failed = tries = 0
    while failed < 3 and tries < 200:  # most flips hit a literal: no error
        off, length, _ = blocks[int(rng.integers(0, len(blocks)))]
        flipped = bytearray(small)
        flipped[off + int(rng.integers(0, length))] ^= 1 << int(rng.integers(0, 8))
        status, _ = hold(f"flipped byte {tries}", bytes(flipped))
        failed += status[1] >= 0
        tries += 1
    _require(failed > 0, "no flipped byte made a block fail")
    return worst, pass_err, plain_ms, big


def phase_chained_path(data: bytes, dev):
    """The default settings: a chained frame of 64 KB blocks."""
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import decode_stream, encode_stream

    launches, e2e = _round_trips(
        data, frame.EncoderSettings(), dev,
        [encode_stream.encode_blocks_stream, decode_stream.decode_chain])
    print(f"[chained] {len(data)} bytes -> {e2e['frame_bytes']} bytes, round "
          f"trip exact, deterministic, launches {launches}; median "
          f"{e2e['compress_GBps_median']:.4f} GB/s compress, "
          f"{e2e['decompress_GBps_median']:.4f} GB/s decompress")
    return launches, e2e


def phase_big_blocks(data: bytes, dev):
    """An independent frame of 1 MiB blocks: kernel D encodes, A decodes."""
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import decode, encode_stream

    launches, e2e = _round_trips(
        data, frame.EncoderSettings(chain_blocks=False, block_size=1 << 20), dev,
        [encode_stream.encode_blocks_stream, decode.decode_blocks], ROW_PASSES)
    print(f"[big blocks] {len(data)} bytes in 1 MiB blocks -> "
          f"{e2e['frame_bytes']} bytes, round trip exact, deterministic, "
          f"launches {launches}; median {e2e['compress_GBps_median']:.4f} GB/s "
          f"compress, {e2e['decompress_GBps_median']:.4f} GB/s decompress")
    return launches, e2e


def phase_times_stream(data: bytes, blob: bytes, chain_plain_ms: float, dev,
                       data64: bytes):
    """Kernel D on the chained path's rows, and the chained decoder on the
    16 MiB FAST frame, the 64 MiB FAST frame of the default chained path
    and a 16 MiB L9 chained frame: device time of each pass (profiler),
    CUDA events per wrapper call, plain times, bounds."""
    import torch
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import decode_stream, encode_stream

    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    st, offs, wl = chained_windows(len(data), BLOCK)
    nb = st.numel()
    payload_d = payload.to(dev)
    _, clens, _ = encode_stream.encode_windows(
        payload_d, st, offs, wl, BLOCK, fast_schedule="dense")
    enc_ms = _cuda_ms(lambda: encode_stream.encode_windows(
        payload_d, st, offs, wl, BLOCK, fast_schedule="dense"), 3)
    picks = [q * nb // 4 for q in range(4)]
    t0 = time.perf_counter()
    encode_stream.encode_windows_plain(
        payload, st[picks], offs[picks], wl[picks], BLOCK, fast_schedule="dense")
    enc_plain_ms = (time.perf_counter() - t0) * 1e3 / len(picks) * nb
    packed = int(clens.sum())
    # the payload read once, compressed bytes written once, and per row
    # the int64 start and the int32 prefix, length, clen and flag
    enc_bytes = len(data) + packed + 24 * nb

    chain = {}
    for name, b in (
        ("FAST_16MiB", blob),
        ("FAST_64MiB", frame.compress(data64, device=dev)),
        ("L9_16MiB", frame.compress(
            data, frame.EncoderSettings(compression_level=9), device=dev)),
    ):
        fr, table, block_size, _ = chain_inputs(b)
        frame_d = fr.to(dev)

        def run():
            return decode_stream.decode_chain(frame_d, table, block_size)

        written = int(run()[1][0])
        passes, _ = _device_ms_by(
            run, lambda: dict(decode_stream.chain_kernel_launches), 3)
        # the frame read once, the content written once, the block table
        # and the status
        moved = len(b) + written + 24 * table.shape[0] + 24
        chain[name] = {
            "ms": sum(passes.values()), "call_ms": _cuda_ms(run, 3),
            "pass_ms": passes, "frame_bytes": len(b), "bytes": written,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        print(f"[times] decode_chain {name}: {chain[name]['ms']:.3f} ms of "
              f"device time ({chain[name]['call_ms']:.3f} ms per wrapper "
              f"call) over a {len(b)}-byte frame; passes "
              + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
    print(f"[times] encode_stream {enc_ms:.3f} ms over {nb} chained rows")
    fast = chain["FAST_16MiB"]
    return [
        {"name": "encode_blocks_stream", "route": "cuda",
         "source": "lz4_tpu_torch/ops/csrc/encode_stream.cu",
         "replaces": "lz4_tpu/ops/encode_pallas_stream.py:266",
         "ms": enc_ms, "plain_ms": enc_plain_ms,
         "bound_ms": enc_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        {"name": "decode_chain", "route": "cuda",
         "source": "lz4_tpu_torch/ops/csrc/decode_stream.cu",
         "replaces": "lz4_tpu/ops/decode_pallas_stream.py:636",
         "ms": fast["ms"], "call_ms": fast["call_ms"],
         "pass_ms": fast["pass_ms"], "plain_ms": chain_plain_ms,
         "bound_ms": fast["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "frames": chain},
    ]


def _cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _call_ms(fn, iters: int) -> float:
    """The median host time of one call of ``fn`` and a synchronize: what
    a caller waits for one call, host work included."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# the row counts at which both of kernel A's routes are timed and held
ROUTE_COUNTS = (1, 4, 16, 64, 256, 1024)


def route_counts(comps, clens, raw, dev) -> dict:
    """Both of kernel A's routes on 1-1,024 of a batch's 64 KB rows (spread
    evenly): each held equal to the other and to the raw rows, timed per
    wrapper call (`_call_ms`, median of 5), beside the route
    `decode.route` gives."""
    import torch
    from lz4_tpu_torch.ops import decode

    nb = comps.shape[0]
    out = {}
    for n in ROUTE_COUNTS:
        if n > nb:
            break
        picks = torch.tensor([k * nb // n for k in range(n)])
        c, cl = comps[picks.to(dev)], clens[picks.to(dev)]
        warp = decode._decode("warp", c, cl, BLOCK)[0]
        rows = decode._decode("rows", c, cl, BLOCK)[0]
        _require(_max_abs_err(warp, rows) == 0, f"A's routes differ on {n} rows")
        _require(torch.equal(warp[0].cpu(), raw[picks]) and not bool(warp[2].any()),
                 f"A's one-warp route on {n} rows: the round trip is not exact")
        out[n] = {"warp_ms": _call_ms(lambda: decode._decode("warp", c, cl, BLOCK), 5),
                  "rows_ms": _call_ms(lambda: decode._decode("rows", c, cl, BLOCK), 5),
                  "rule": decode.route(n, BLOCK)}
    print("[routes] A's routes equal at " + ", ".join(
        f"{n} rows (warp {v['warp_ms']:.3f} ms, passes {v['rows_ms']:.3f}; rule {v['rule']})"
        for n, v in out.items()))
    return out


def hold_route_rule_rows(data: bytes, dev, timed: bool = True) -> dict:
    """The route rule's batches above 64 KB (`decode.WARP_ROUTE_ROWS`: the
    fewest rows that take the one-warp route at 128 KB and at 256 KB), cut
    from ``data`` (repeated where it is shorter) and encoded by kernel D:
    the rule must give the one-warp route and `decode_blocks` must launch
    it; both routes' whole outputs held equal, to the raw rows, and on two
    rows to the plain version (max_abs_err 0); each route timed per
    wrapper call (`_call_ms`, median of 5) when ``timed``."""
    import torch
    from lz4_tpu_torch.ops import decode, encode_stream
    from lz4_tpu_torch.parallel.blocks import comp_capacity, split_blocks

    out = {}
    for cap, n in decode.WARP_ROUTE_ROWS:
        if cap <= decode.WARP_ROUTE_MAX:
            continue
        src = (data * -(-n * cap // len(data)))[:n * cap]
        bufs, lens = split_blocks(src, cap)
        enc, clens, _ = encode_stream.encode_blocks_stream(bufs.to(dev), lens.to(dev), cap)
        comps = torch.zeros((n, comp_capacity(cap)), dtype=torch.uint8, device=dev)
        comps[:, :enc.shape[1]] = enc
        _require(decode.route(n, cap) == "warp", f"the rule at {n} x {cap}: not the one-warp route")
        before = dict(decode.kernel_launches)
        got = decode.decode_blocks(comps, clens, cap)
        ran = {k: decode.kernel_launches[k] - before[k] for k in ("decode_rows", "rows_gather")}
        _require(ran == {"decode_rows": 1, "rows_gather": 0},
                 f"decode_blocks at {n} x {cap} launched {ran}, not the one-warp route")
        rows = decode._decode("rows", comps, clens, cap)[0]
        picks = [n // 3, n - 1]
        want = decode.decode_blocks_plain(comps[picks].cpu(), clens[picks].cpu(), cap)
        err = max(_max_abs_err(got, rows), _max_abs_err([t[picks] for t in got], want))
        _require(err == 0, f"A's routes at {n} x {cap}: kernel != passes or plain")
        _require(torch.equal(got[0].cpu(), bufs[:, :cap]) and not bool(got[2].any()),
                 f"A's one-warp route at {n} x {cap}: the round trip is not exact")
        key = f"{n} x {cap // 1024} KB"
        out[key] = {"rule": "warp", "max_abs_err": err}
        if timed:
            out[key].update(
                warp_ms=_call_ms(lambda: decode._decode("warp", comps, clens, cap), 5),
                rows_ms=_call_ms(lambda: decode._decode("rows", comps, clens, cap), 5))
    print("[routes] the rule's one-warp batches above 64 KB equal to the passes and the "
          "plain version: " + ", ".join(
              k + (f" (warp {v['warp_ms']:.3f} ms, passes {v['rows_ms']:.3f})" if timed else "")
              for k, v in out.items()))
    return out


def warp_step_bound(rows, clock: float, limit: int = -1, window: bytes = b"") -> dict:
    """The one-warp route's step bound on compressed rows (bytes) of out_cap
    64 KB, from the plain model of its schedule (`decode.decode_rows_model`,
    each row with ``window`` as its dictionary): the slowest row's
    dependent steps (`decode.schedule_steps`: the window steps, and the
    sequences and length-extension bytes parsed one at a time) at one
    shared-memory round trip each, `step_bound_ms`; beside it one step per
    sequence and extension byte, `serial_step_ms`."""
    from lz4_tpu_torch.ops import decode

    tallies = []
    for r in rows:
        decode.decode_rows_model(r, BLOCK, window, limit, counts=tallies)
    steps = max(decode.schedule_steps(t) for t in tallies)
    serial = max(t["sequences"] + t["extension_bytes"] for t in tallies)
    step_ms = L1_CYCLES / clock * 1e3
    return {"steps": steps, "step_bound_ms": steps * step_ms,
            "serial_steps": serial, "serial_step_ms": serial * step_ms}


def _step_bound(entry: dict, steps: dict) -> dict:
    """``entry`` with `warp_step_bound`'s counts, its bytes bound kept as
    `byte_bound_ms` and the larger of the two as its bound."""
    entry.update(steps, byte_bound_ms=entry["bound_ms"], bound_by="bytes")
    if steps["step_bound_ms"] > entry["bound_ms"]:
        entry.update(bound_ms=steps["step_bound_ms"], bound_by="operations")
    return entry


FAST_SHAPES = (("64KiB", 1 << 16), ("1MiB", 1 << 20), ("4MiB", 4 << 20))
ROW_PASSES = ("rows_nn", "rows_spans", "rows_hops", "rows_table", "rows_literals",
              "rows_jump", "rows_gather")
# the kernels of each of kernel A's routes (`decode.route`)
ROUTE_KERNELS = {"warp": ("decode_rows",), "rows": ROW_PASSES}
# one dependent step of the FAST scan's warp: at least one L1 round trip
# (an estimate, in cycles)
L1_CYCLES = 32


def collision_row(n: int, seed: int) -> bytes:
    """n bytes of 4-byte words that share one bucket of the dense 15-bit
    hash, and so of the canonical 13-bit one (found by search), in random
    order: the probes of one warp step collide in the table."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)
    buckets = ((words * 2654435761) & 0xFFFFFFFF) >> 17
    vals, counts = np.unique(buckets, return_counts=True)
    same = words[buckets == vals[np.argmax(counts)]][:8].astype(np.uint32)
    pick = rng.integers(0, same.size, -(-n // 4))
    return same[pick].tobytes()[:n]


def _warp_plain(row: bytes, accel: int, schedule: str, src_off: int = 0):
    """The batched plain scan of one row in a worker: (bytes, step counts,
    seconds)."""
    from lz4_tpu_torch.ops import encode

    t0 = time.perf_counter()
    out, steps = encode.encode_row_warp(row, accel, schedule, src_off)
    return bytes(out), steps, time.perf_counter() - t0


def hold_rows_passes(comps, clens, out_cap: int, dev, dicts=None, dls=None) -> dict:
    """Each pass of kernel A on the card against its plain version on the
    same inputs (the kernel's own output of the pass before): nn; the
    segments' exits, counts and sums; the hops; the filled sequence-table
    rows and each row's first failing sequence; lens, errs, the output and
    the written index entries after the literals pass; the output and index
    after resolve.  Also the whole against the serial plain version.
    Returns each pass's max_abs_err and its plain version's seconds."""
    import torch
    from lz4_tpu_torch.ops import decode

    got = decode.rows_passes(comps.to(dev), clens.to(dev), out_cap,
                             None if dicts is None else dicts.to(dev),
                             None if dls is None else dls.to(dev))
    torch.cuda.synchronize()
    g = got._replace(**{k: v.cpu() for k, v in got._asdict().items()
                        if isinstance(v, torch.Tensor)})
    lay = g.layout
    seconds = {}

    def plain(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    errs = {"rows_nn": _max_abs_err([g.nn], [plain("rows_nn", decode.rows_nn_plain,
                                                   comps, clens)])}
    errs["rows_spans"] = _max_abs_err(
        [g.exits, g.counts, g.sums],
        plain("rows_spans", decode.rows_spans_plain, comps, clens, g.nn))
    errs["rows_hops"] = _max_abs_err(
        [g.entry, g.seq_at, g.op_at, g.nseq, g.total],
        plain("rows_hops", decode.rows_hops_plain, clens, g.exits, g.counts, g.sums))
    seqs, fail = plain("rows_table", decode.rows_table_plain, comps, clens, out_cap,
                       dls, g.nn)
    used = decode.used_rows(lay.sbase, g.nseq)
    errs["rows_table"] = _max_abs_err([g.seqs[used], g.fail], [seqs[used], fail])
    lo, lp, ln, le = plain("rows_literals", decode.rows_literals_plain, comps, clens,
                           out_cap, g.seqs, g.nseq, g.total, g.fail)
    slots = decode.used_slots(lay.pbase, g.lens)
    errs["rows_literals"] = _max_abs_err(
        [g.lens, g.errs, g.lit_out, g.lit_ptr[slots]], [ln, le, lo, lp[slots]])
    ro, rp = plain("rows_resolve", decode.rows_resolve_plain, clens, out_cap,
                   g.lit_out, g.lit_ptr, g.lens, dicts)
    errs["rows_resolve"] = _max_abs_err([g.out, g.ptr[slots]], [ro, rp[slots]])
    errs["serial"] = _max_abs_err(
        [g.out, g.lens, g.errs],
        decode.decode_blocks_plain(comps, clens, out_cap, dicts, dls))
    for name, e in errs.items():
        _require(e == 0, f"kernel A's {name} pass != plain")
    return errs, seconds


def corrupt_rows(good: bytes):
    """Kernel A's corrupt kinds, from one valid compressed row `good`: a
    flipped token, the row cut in half, an offset past the output start, a
    valid row with trailing bytes, literal- and match-length runs that end
    at the row's end."""
    flipped = bytearray(good)
    flipped[0] ^= 0x80
    return [
        bytes(flipped), good[:len(good) // 2],
        bytes([0x40]) + b"abcd" + (100).to_bytes(2, "little") + bytes([0x00]),
        good + b"xyz", good + bytes(1),
        b"\xf0" + b"\xff" * 20,
        bytes([0x1F, 0x61, 1, 0]) + b"\xff" * 10,
    ]


def phase_fast_edges(data: bytes, rng, dev, pool):
    """Kernel D's FAST scan on its edge rows against the serial and the
    batched plain versions: rows of 12, 13, 65,546 and 65,547 bytes (the
    byU16/byU32 edge), 4 MiB of zeros and a 64 KB row whose probes collide
    in one bucket, canonical and dense, accel 1 and 8; chained windows with
    a 64 KB prefix (dense).  Then kernel A on their compressed rows, the
    corrupt kinds and dictionary rows, each pass against its plain version
    and the whole against the one-warp route's lens and errs.  Returns the
    worst difference of D and of A."""
    import torch
    from lz4_tpu_torch.ops import decode, encode_stream
    from lz4_tpu_torch.parallel.blocks import comp_capacity

    nb = len(data) // BLOCK
    rows = [data[:12], data[BLOCK:BLOCK + 13], data[2 * BLOCK:2 * BLOCK + 65546],
            data[(nb // 2) * BLOCK:(nb // 2) * BLOCK + 65547], bytes(4 << 20),
            collision_row(BLOCK, 7)]
    bcap = 4 << 20
    bufs, lens = _stage(rows, bcap)
    base, st = bufs.reshape(-1), torch.arange(len(rows), dtype=torch.int64) * bcap
    zeros = torch.zeros(len(rows), dtype=torch.int32)
    warp = {(sched, accel): [pool.submit(_warp_plain, r, accel, sched) for r in rows]
            for sched in ("canonical", "dense") for accel in (1, 8)}
    worst_d = 0
    streams = []
    for (sched, accel), futs in warp.items():
        got = encode_stream.encode_windows(base.to(dev), st, zeros, lens, bcap,
                                           acceleration=accel, fast_schedule=sched)
        torch.cuda.synchronize()
        want = encode_stream.encode_windows_plain(base, st, zeros, lens, bcap,
                                                  acceleration=accel, fast_schedule=sched)
        err = _max_abs_err(got, want)
        out, clens = got[0].cpu(), got[1].cpu()
        for i, f in enumerate(futs):
            wb, _, _ = f.result()
            mine = out[i, :int(clens[i])].numpy().tobytes()
            err = max(err, 0 if mine == wb else 1)
        _require(err == 0, f"encode_windows {sched} accel={accel} edge rows != plain")
        worst_d = max(worst_d, err)
        if accel == 1:
            streams += [out[i, :int(clens[i])].numpy().tobytes() for i in range(len(rows))]
        print(f"[fast edges] D {sched} accel={accel}: rows of {[len(r) for r in rows]} "
              f"bytes equal to the serial and the batched plain scans, clens={clens.tolist()}")
    payload = torch.frombuffer(bytearray(data[:8 * BLOCK]), dtype=torch.uint8)
    cst, coffs, cwl = chained_windows(8 * BLOCK, BLOCK)
    picks = [1, 5]
    futs = [pool.submit(_warp_plain, data[int(cst[k]):int(cst[k] + cwl[k])], 1, "dense",
                        int(coffs[k])) for k in picks]
    got = encode_stream.encode_windows(payload.to(dev), cst[picks], coffs[picks], cwl[picks],
                                       BLOCK, fast_schedule="dense")
    out, clens = (t.cpu() for t in got[:2])
    for i, f in enumerate(futs):
        ok = out[i, :int(clens[i])].numpy().tobytes() == f.result()[0]
        _require(ok, "chained window != the batched plain scan")
    print(f"[fast edges] D dense: chained windows {picks} (64 KB prefixes) equal to the "
          "batched plain scan")

    # kernel A: the edge rows' streams, the corrupt kinds, dictionary rows
    worst_a = {}
    for out_cap, batch in ((bcap, streams + corrupt_rows(streams[3])),
                           (BLOCK, corrupt_rows(streams[5]))):
        comps, cl = _stage(batch, comp_capacity(out_cap))
        errs, _ = hold_rows_passes(comps, cl, out_cap, dev)
        new, _ = decode._decode("rows", comps.to(dev), cl.to(dev), out_cap)
        old, _ = decode._decode("warp", comps.to(dev), cl.to(dev), out_cap)
        errs["one-warp route"] = _max_abs_err(new, old)
        _require(errs["one-warp route"] == 0, "kernel A != its one-warp route")
        for k, e in errs.items():
            worst_a[k] = max(worst_a.get(k, 0), e)
        print(f"[fast edges] A out_cap={out_cap}: {len(batch)} rows, each pass equal to its "
              f"plain version, lens/errs equal to the one-warp route's: "
              f"errs={new[2].tolist()}, lens={new[1].tolist()}")
    windows, synth = [], []
    for wlen in (0, 1, 100, 4000, 65536, 65536):
        window = rng.integers(0, 256, wlen, dtype=np.uint8).tobytes()
        synth.append(write_stream(rng, window, BLOCK)[0])
        windows.append(window)
    synth.append(bytes([0x40]) + b"abcd" + (100).to_bytes(2, "little") + bytes([0x00]))
    windows.append(b"w" * 50)  # offset 100 past op + ll + 50: fails
    comps, cl = _stage(synth, comp_capacity(BLOCK))
    dicts = torch.zeros((len(synth), 65536), dtype=torch.uint8)
    dls = torch.tensor([len(w) for w in windows], dtype=torch.int32)
    for i, w in enumerate(windows):
        if w:
            dicts[i, 65536 - len(w):] = torch.frombuffer(bytearray(w), dtype=torch.uint8)
    errs, _ = hold_rows_passes(comps, cl, BLOCK, dev, dicts, dls)
    args = comps.to(dev), cl.to(dev), BLOCK, dicts.to(dev), dls.to(dev)
    new, _ = decode._decode("rows", *args)
    old, _ = decode._decode("warp", *args)
    errs["one-warp route"] = _max_abs_err(new, old)
    _require(errs["one-warp route"] == 0, "kernel A with dictionaries != its one-warp route")
    for k, e in errs.items():
        worst_a[k] = max(worst_a.get(k, 0), e)
    print(f"[fast edges] A with dictionaries {dls.tolist()}: each pass equal to its plain "
          f"version and to the one-warp route, errs={new[2].tolist()}")
    worst_a["one-warp edges"] = hold_warp_edges(dev, 17)
    return worst_d, worst_a


def row_pass_bounds(comps, clens, size: int, clock: float) -> dict:
    """Each of kernel A's passes' bound on a batch on the card: the bytes
    that pass must move (its inputs read once, its outputs written once,
    counted from this batch's sequences) over the memory rate; for
    rows_hops also its dependent hops, the slowest row's, one L1 round trip
    each.  Returns name -> (bound_ms, bound_by, bytes)."""
    import torch
    from lz4_tpu_torch.ops import decode

    p = decode.rows_passes(comps, clens, size)
    torch.cuda.synchronize()
    nb = clens.numel()
    packed = int(clens.clamp(min=0).sum())
    out = int(p.lens.to(torch.int64).sum())
    nseq = int(p.nseq.to(torch.int64).sum())
    used = decode.used_rows(p.layout.sbase, p.nseq).to(comps.device)
    lit = int(p.seqs[used, 1].to(torch.int64).sum())
    segs = torch.diff(torch.cat([p.layout.gbase, torch.tensor([p.layout.segments])]))
    owner = torch.repeat_interleave(torch.arange(nb), segs)
    hops = torch.bincount(owner[(p.entry >= 0).cpu()], minlength=nb)
    visited, slowest = int(hops.sum()), int(hops.max())
    pos = packed + nb
    moved = {
        "rows_nn": packed + 4 * pos,
        "rows_spans": packed + 4 * pos + 12 * pos,
        "rows_hops": 24 * visited + 8 * nb,
        "rows_table": packed + 12 * visited + 4 * decode.SEQ_COLUMNS * nseq + 4 * nb,
        "rows_literals": 4 * decode.SEQ_COLUMNS * nseq + 2 * lit + 4 * out + 8 * nb,
        "rows_jump": 8 * out,
        "rows_gather": 4 * out + 2 * (out - lit),
    }
    bounds = {}
    for name, n in moved.items():
        byte_ms = n / HBM_BYTES_PER_S * 1e3
        step_ms = slowest * L1_CYCLES / clock * 1e3 if name == "rows_hops" else 0.0
        bounds[name] = (max(byte_ms, step_ms),
                        "bytes" if byte_ms >= step_ms else "operations", n)
    return bounds


def phase_fast_rows(data: bytes, dev, pool):
    """Kernel D's FAST scan and kernel A at the FAST paths' row sizes over
    the --mb payload: 64 KB (kernel B's rows, the headline path), 1 MiB and
    4 MiB (the `lz4` CLI default).  Each timed with CUDA events, A's passes
    by the profiler's device time and A's one-warp route beside it (whole
    output equal), A's passes above 64 KB also in several groups of rows
    (equal to one group), kernel B's dense rows at 64 KB (the 16-bit
    table) with one row per quarter held; one row per quarter of each timed launch held to the
    serial and the batched plain scans and the serial plain decode (in the
    pool; their step counts give D's dependent-step bound), and A's passes
    held to their plain versions on those rows.  Returns `kernels` entries
    (launches filled in by the caller) and a summary."""
    import torch
    from lz4_tpu_torch.ops import decode, encode, encode_stream
    from lz4_tpu_torch.parallel.blocks import comp_capacity, split_blocks

    clock = float(_nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    entries, summary = [], {}
    for label, size in FAST_SHAPES:
        bufs, lens = split_blocks(data, size)
        nb = bufs.shape[0]
        picks = [q * nb // 4 + nb // 8 for q in range(4)]
        rows = [data[k * size:(k + 1) * size] for k in picks]
        warp_f = [pool.submit(_warp_plain, r, 1, "canonical") for r in rows]
        serial_f = _submit_timed(pool, encode_stream.encode_blocks_stream_plain,
                                 bufs[picks], lens[picks], size)
        bufs_d, lens_d = bufs.to(dev), lens.to(dev)
        if size <= BLOCK:
            def enc():
                return encode.encode_blocks(bufs_d, lens_d, size)
        else:
            def enc():
                return encode_stream.encode_blocks_stream(bufs_d, lens_d, size)
        out, clens, _ = enc()
        enc_ms = _cuda_ms(enc, 3)
        if size <= BLOCK:  # kernel B's dense rows: the 16-bit table
            dense_f = [pool.submit(_warp_plain, r, 1, "dense") for r in rows]

            def enc_dense():
                return encode.encode_blocks(bufs_d, lens_d, size, fast_schedule="dense")

            dense = enc_dense()
            summary["64KiB_dense_D_ms"] = _cuda_ms(enc_dense, 3)
            dense_out, dense_len = dense[0][picks].cpu(), dense[1][picks].cpu()
            for i, f in enumerate(dense_f):
                _require(dense_out[i, :int(dense_len[i])].numpy().tobytes() == f.result()[0],
                         f"D's dense rows at {label}: row {picks[i]} != the plain scan")
            print(f"[fast rows] D dense {nb} x {label}: {summary['64KiB_dense_D_ms']:.3f} ms "
                  f"({encode_stream.shared_bytes('dense', longest=size)} bytes of table per "
                  f"CTA); rows {picks} equal to the batched plain scan")
        cap = comp_capacity(size)
        comps = torch.zeros((nb, cap), dtype=torch.uint8, device=dev)
        comps[:, :out.shape[1]] = out

        def dec():
            return decode.decode_blocks(comps, clens, size)

        def rows_route():
            return decode._decode("rows", comps, clens, size)[0]

        def warp_route():
            return decode._decode("warp", comps, clens, size)[0]

        back = dec()
        dec_ms = _cuda_ms(dec, 3)
        if size > decode.WARP_ROUTE_MAX:  # the passes in groups of rows
            whole = decode.GROUP_SCRATCH_BYTES
            decode.GROUP_SCRATCH_BYTES = 1 << 28
            try:
                groups = len(decode.row_groups(clens.cpu(), size))
                err = _max_abs_err(back, dec())
            finally:
                decode.GROUP_SCRATCH_BYTES = whole
            _require(groups > 1 and err == 0,
                     f"A at {label} in {groups} groups != in one group")
            print(f"[fast rows] A at {label}: {nb} rows in {groups} groups of at most "
                  f"256 MiB of scratch equal to one group")
        routes_ms = {"passes": _cuda_ms(rows_route, 3), "one_warp": _cuda_ms(warp_route, 3)}
        pass_ms, _ = _device_ms_by(
            rows_route, lambda: {k: decode.kernel_launches[k] for k in ROW_PASSES}, 2)
        torch.cuda.synchronize()
        err_old = max(_max_abs_err(back, rows_route()), _max_abs_err(back, warp_route()))
        _require(err_old == 0, f"A at {label}: its two routes differ")
        _require(torch.equal(back[0].cpu(), bufs[:, :size]) and
                 torch.equal(back[1].cpu(), lens) and not bool(back[2].any()),
                 f"A at {label}: the round trip is not exact")
        comps_h, clens_h = comps[picks].cpu(), clens[picks].cpu()
        dec_plain_f = _submit_timed(pool, decode.decode_blocks_plain, comps_h, clens_h, size)
        if size == BLOCK:
            summary["routes"] = route_counts(comps, clens, bufs[:, :size], dev)
            summary["routes_above_64KiB"] = hold_route_rule_rows(data, dev)
        pass_err, pass_s = hold_rows_passes(comps_h, clens_h, size, dev)
        out_h = out.cpu()
        serial, serial_s = serial_f.result()
        worst_d = 0
        steps, warp_s = [], 0.0
        for i, (k, wf) in enumerate(zip(picks, warp_f)):
            mine = out_h[k, :int(clens[k])].numpy().tobytes()
            wb, st, ws = wf.result()
            sb = serial[0][i, :int(serial[1][i])].tobytes()
            worst_d = max(worst_d, 0 if mine == wb == sb else 1)
            steps.append(st)
            warp_s += ws
        _require(worst_d == 0, f"D at {label}: rows {picks} != the plain scans")
        want, seconds = dec_plain_f.result()
        err_a = _max_abs_err([t[picks] for t in back],
                             [torch.from_numpy(x) for x in want])
        _require(err_a == 0, f"A at {label}: rows {picks} != the serial plain decode")
        raw, packed = int(lens.sum()), int(clens.sum())
        enc_bytes = raw + packed + 24 * nb
        dec_bytes = packed + raw + 12 * nb
        slowest = max(st["probe_steps"] + st["sequences"] for st in steps)
        step_ms = slowest * L1_CYCLES / clock * 1e3
        byte_ms = enc_bytes / HBM_BYTES_PER_S * 1e3
        summary[label] = {
            "rows": nb, "raw_bytes": raw, "compressed_bytes": packed,
            "D_ms": enc_ms, "A_ms": dec_ms, "A_route_ms": routes_ms,
            "A_pass_device_ms": pass_ms, "steps_of_picked_rows": steps}
        is64 = size <= BLOCK
        entries += [
            {"name": "encode_blocks" if is64 else f"encode_blocks_stream:{label}",
             "route": "cuda", "source": "lz4_tpu_torch/ops/csrc/encode_stream.cu",
             "replaces": ("lz4_tpu/ops/encode_pallas5.py:1922" if is64
                          else "lz4_tpu/ops/encode_pallas_stream.py:266"),
             "shape": f"{nb} x {label}", "max_abs_err": worst_d,
             "ms": enc_ms, "plain_ms": serial_s * 1e3 / len(picks) * nb,
             "batched_plain_ms": warp_s * 1e3 / len(picks) * nb,
             "bound_ms": max(byte_ms, step_ms),
             "bound_by": "bytes" if byte_ms >= step_ms else "operations",
             "byte_bound_ms": byte_ms, "step_bound_ms": step_ms, "library_ms": None},
            {"name": "decode_rows" if is64 else f"decode_blocks:{label}",
             "route": "cuda", "source": "lz4_tpu_torch/ops/csrc/decode.cu",
             "replaces": "lz4_tpu/ops/decode_pallas6.py:643",
             "shape": f"{nb} x {label}", "max_abs_err": max(err_a, *pass_err.values()),
             "ms": dec_ms, "route_ms": routes_ms, "pass_ms": pass_ms,
             "rule": decode.route(nb, size),
             "plain_ms": seconds * 1e3 / len(picks) * nb,
             "bound_ms": dec_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": None},
        ]
        if is64:  # the one-warp route: its schedule's step bound, the slowest picked row's
            _step_bound(entries[-1], warp_step_bound(
                [comps_h[i, :int(clens_h[i])].numpy().tobytes() for i in range(len(picks))],
                clock))
        if size == 4 << 20:
            bounds = row_pass_bounds(comps, clens, size, clock)
            for name in ROW_PASSES:
                entries.append({
                    "name": name, "route": "cuda",
                    "source": "lz4_tpu_torch/ops/csrc/decode.cu",
                    "replaces": "lz4_tpu/ops/decode_pallas6.py:643 (a pass of kernel A)",
                    "shape": f"{nb} x {label}",
                    "max_abs_err": pass_err["rows_resolve" if name in (
                        "rows_jump", "rows_gather") else name],
                    "ms": pass_ms[name],
                    "plain_ms": pass_s["rows_resolve" if name in (
                        "rows_jump", "rows_gather") else name] * 1e3 / len(picks) * nb,
                    "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                    "bytes_moved": bounds[name][2], "library_ms": None})
        print(f"[fast rows] {nb} x {label}: D {enc_ms:.3f} ms, A {dec_ms:.3f} ms (the "
              f"passes {routes_ms['passes']:.3f} ms, the one-warp route "
              f"{routes_ms['one_warp']:.3f} ms; passes' device time " + ", ".join(
                  f"{k} {v:.3f}" for k, v in pass_ms.items())
              + f"); rows {picks} equal to the plain versions, each of A's passes "
              f"equal to its own; slowest picked row {slowest} dependent steps")
    return entries, summary


def _union_ms(spans) -> float:
    """The time covered by the union of (start, end) spans in us, in ms."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def _overlap_ms(xs, ys) -> float:
    """The time in ms that the unions of two lists of spans share."""
    return _union_ms(xs) + _union_ms(ys) - _union_ms(list(xs) + list(ys))


def _xxh32_overlaps(spans) -> dict:
    """Kernel E's device time and how much of it ran while kernel D
    (`encode_windows`) or a copy between host and card ran, in ms: the
    content hash on E's side stream beside them."""
    e = [(a, b) for n, a, b in spans if "xxh32_windows" in n]
    d = [(a, b) for n, a, b in spans if "encode_windows" in n]
    copies = [(a, b) for n, a, b in spans if "Memcpy" in n]
    return {"xxh32_ms": _union_ms(e), "with_encode_ms": _overlap_ms(e, d),
            "with_copies_ms": _overlap_ms(e, copies)}


def stream_overlaps(data: bytes, dev, settings) -> dict:
    """Kernel E's device time over one compress and one decompress of a
    path, and the part of it that overlaps kernel D and the copies between
    host and card, from CUDA events (the profiler drops events): events
    recorded on its launch's stream around each launch of E
    (`ops.xxh32._launch`: its content hashes on the side stream, block
    checksums on the caller's), around each launch of D's FAST scan
    (`encode_stream._launch_fast`, B's rows too), of the frame's upload and of each
    copy of a CUDA tensor to the host (`Tensor.cpu`), on the current
    stream; each span between its two events, all timed from one event
    recorded first.  The wrappers are in place only for the two calls."""
    import torch
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.frame import api
    from lz4_tpu_torch.ops import encode_stream, xxh32

    spans = []

    def timed(name, fn, stream_of):
        def run(*a, **k):
            stream = stream_of(*a)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record(stream)
            out = fn(*a, **k)
            e1.record(stream)
            spans.append((name, e0, e1))
            return out
        return run

    def current(*_):
        return torch.cuda.current_stream(dev)

    cpu = torch.Tensor.cpu
    patches = [(xxh32, "_launch", timed("xxh32_windows", xxh32._launch, lambda *a: a[6])),
               (encode_stream, "_launch_fast",
                timed("encode_windows", encode_stream._launch_fast, current)),
               (api, "upload", timed("Memcpy HtoD", api.upload, current)),
               (torch.Tensor, "cpu", timed("Memcpy DtoH", cpu, current))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    torch.cuda.synchronize()
    base = torch.cuda.Event(enable_timing=True)
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        base.record(torch.cuda.current_stream(dev))
        blob = frame.compress(data, settings, device=dev)
        cut = len(spans)
        back = frame.decompress(blob, device=dev)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    torch.cuda.synchronize()
    _require(back == data, "round trip with events is not exact")
    us = [(n, base.elapsed_time(a) * 1e3, base.elapsed_time(b) * 1e3) for n, a, b in spans]
    return {"compress": _xxh32_overlaps(us[:cut]), "decompress": _xxh32_overlaps(us[cut:])}


def profile_path(data: bytes, dev, settings, kernels=(), attempts: int = 3) -> dict:
    """Device time by name over one compress + decompress of a path
    (torch.profiler), and the device's busy share of the host's wall time:
    the union of the device's intervals (kernels and copies), which overlap
    where kernel E's side stream runs beside the other work.  Where E ran,
    its device time on each side and the part of it that overlaps kernel D
    and the copies.  A report, not a check: a profiler that cannot trace
    the card yields "not measured".  The profiler drops events now and
    then, so a trace that records fewer launches of a kernel than
    ``kernels`` requires (names, each launched at least once, or {name:
    the launches the path's counts give}), or has no device events, is
    taken again, up to ``attempts`` traces; the last one is reported, with
    the kernels it lacks."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from lz4_tpu_torch import frame

    for attempt in range(1, attempts + 1):
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with record_function("chip_smoke.compress"):
                    blob = frame.compress(data, settings, device=dev)
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                with record_function("chip_smoke.decompress"):
                    frame.decompress(blob, device=dev)
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
            spans, cut = [], None
            for e in prof.events():
                if e.name == "chip_smoke.decompress" and \
                        e.device_type == torch.autograd.DeviceType.CPU:
                    cut = e.time_range.start
                elif e.device_type == torch.autograd.DeviceType.CUDA and \
                        not getattr(e, "is_user_annotation", False) and \
                        not e.name.startswith("chip_smoke."):
                    spans.append((e.name, e.time_range.start, e.time_range.end))
        except Exception as e:  # the report must not end the run
            return {"profile": f"not measured ({e!r})"}
        need = kernels if isinstance(kernels, dict) else dict.fromkeys(kernels, 1)
        missing = [k for k, n in need.items() if sum(k in m for m, _, _ in spans) < n]
        if spans and not missing:
            break
    if not spans:
        return {"profile": f"not measured (no device events in {attempts} traces)"}
    by_name = {}
    for n, a, b in spans:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e3
    wall_ms = (t2 - t0) * 1e3
    busy = _union_ms([(a, b) for _, a, b in spans])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_ms": wall_ms, "compress_wall_ms": (t1 - t0) * 1e3,
           "decompress_wall_ms": (t2 - t1) * 1e3, "device_busy_ms": busy,
           "device_busy_share": busy / wall_ms, "device_sum_ms": sum(by_name.values()),
           "traces": attempt, "device_ms_by_name": {k[:60]: v for k, v in top}}
    if missing:
        out["missing_kernels"] = missing
    if any("xxh32_windows" in n for n, _, _ in spans) and cut is not None:
        out["xxh32_overlap"] = {
            "compress": _xxh32_overlaps([t for t in spans if t[1] < cut]),
            "decompress": _xxh32_overlaps([t for t in spans if t[1] >= cut])}
    return {"profile": out}


def _hc_rows(data: bytes, rng):
    """Four 64 KB rows of the mix, the wordy regression row, rows of 0, 12,
    13 and 4,096 bytes, and a 64 KB row of random bytes."""
    nb = len(data) // BLOCK
    picks = [int(q * nb // 4 + rng.integers(0, nb // 4)) for q in range(4)]
    rows = [data[k * BLOCK:(k + 1) * BLOCK] for k in picks]
    rows += [wordy_row(), b"", data[:12], data[BLOCK:BLOCK + 13],
             data[3 * BLOCK:3 * BLOCK + 4096],
             rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()]
    return rows


def plain_pool():
    """Worker processes, one per core up to 8, for the plain versions'
    scalar parses, which take most of a run's time at the HC and OPT
    levels.  Spawned, not forked, so that no CUDA state reaches them; the
    caller's `with` block joins them."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))


def _plain_call(qualname: str, args, kwargs):
    """Run a plain version in a worker: numpy arrays in and out, tensors in
    between."""
    import importlib

    import torch

    module, name = qualname.rsplit(".", 1)
    fn = getattr(importlib.import_module(module), name)

    def tensor(a):
        return torch.from_numpy(a) if isinstance(a, np.ndarray) else a

    out = fn(*map(tensor, args), **{k: tensor(v) for k, v in kwargs.items()})
    if isinstance(out, tuple):
        return tuple(t.numpy() if isinstance(t, torch.Tensor) else t for t in out)
    return out.numpy() if isinstance(out, torch.Tensor) else out


def submit_plain(pool, fn, *args, **kwargs):
    """A plain version's call on `pool`; `.result()` of the returned future
    gives numpy arrays (see `plain_result`)."""
    def array(a):
        return a.cpu().numpy() if hasattr(a, "numpy") else a

    return pool.submit(_plain_call, f"{fn.__module__}.{fn.__name__}",
                       tuple(map(array, args)),
                       {k: array(v) for k, v in kwargs.items()})


def plain_result(future):
    import torch

    return tuple(torch.from_numpy(a) for a in future.result())


OPT_PASSES = ("opt_chain", "opt_matches", "opt_parse")
SPEC_PASSES = ("opt_chain", "opt_matches", "opt_parse_spec")  # levels 10-11


def _opt_passes(level: int):
    """The names of a level's OPT passes: level 12's, or 10-11's."""
    from lz4_tpu_torch.ops.encode_hc import level_arm

    return OPT_PASSES if level_arm(level)[3] else SPEC_PASSES


def _submit_timed(pool, fn, *args, **kwargs):
    """`submit_plain` with the worker's seconds: `.result()` gives (numpy
    output, seconds)."""
    def array(a):
        return a.cpu().numpy() if hasattr(a, "numpy") else a

    return pool.submit(_timed_plain_call, f"{fn.__module__}.{fn.__name__}",
                       tuple(map(array, args)),
                       {k: array(v) for k, v in kwargs.items()})


def hold_opt_passes(base, starts, src_offs, lens, bcap: int, picks, dev, pool,
                    level: int = 12):
    """The OPT passes at ``level`` (10-12) on the card over a batch of
    windows, each held to its plain version on the batch's rows ``picks``
    with the same inputs (the kernel's own output of the pass before), the
    plain versions on ``pool`` (the level 10-11 parse with its counts; at
    level 12 the serial plain parse, the CPU route, timed, and beside it
    the parse by rounds with its counts as "opt_parse:rounds").  Returns a
    function that waits for them and returns each pass's max_abs_err, the
    plain versions' seconds for the picked rows, the given-up entries of
    the match pass and the per-row counts of the plain match pass and parse
    by rounds ({pass: [tally, ...]}: the match pass's dependent steps and
    the parse's, `encode_opt.opt_matches_plain` and
    `opt_parse_rounds_row`); at levels 10-11 the kernel's schedule too,
    `encode_opt.opt_parse_segments_plain` ("opt_parse_spec:segments", its
    bytes held to the kernel's as well)."""
    import torch
    from lz4_tpu_torch.ops import encode_opt
    from lz4_tpu_torch.ops.encode_hc import level_arm

    _, depth, sufficient, full = level_arm(level)
    names = _opt_passes(level)
    st = torch.as_tensor(starts, dtype=torch.int64).cpu()
    so = torch.as_tensor(src_offs, dtype=torch.int32).cpu()
    ln = torch.as_tensor(lens, dtype=torch.int32).cpu()
    base_d = base.to(dev)
    prev = encode_opt.opt_chain(base_d, st, ln)
    matches = encode_opt.opt_matches(base_d, st, so, ln, prev, depth)
    parse = encode_opt.opt_parse if full else encode_opt.opt_parse_spec
    got = parse(base_d, st, so, ln, prev, matches, bcap, depth, sufficient)
    torch.cuda.synchronize()
    given_up = int((matches[:, 0] < 0).sum())
    toff, _ = encode_opt.table_offsets(ln)
    base_h = base.cpu()
    outs = [t.cpu() for t in got]
    jobs = []  # (pass, kernel's output, future), one row each
    for r in picks:
        a, t, n = int(st[r]), int(toff[r]), int(ln[r])
        row = (base_h[a:a + n], [0], so[r:r + 1], ln[r:r + 1])
        pv, mt = prev[t:t + n].cpu(), matches[t:t + n].cpu()
        args = tuple(x.numpy() if hasattr(x, "numpy") else x for x in row)
        jobs += [
            ("opt_chain", [pv], _submit_timed(
                pool, encode_opt.opt_chain_plain, row[0], [0], ln[r:r + 1])),
            ("opt_matches", [mt], pool.submit(
                _timed_counted_call, f"{encode_opt.__name__}.opt_matches_plain",
                (*args, pv.numpy(), depth), {})),
            (names[2], [o[r:r + 1] for o in outs], pool.submit(
                _timed_counted_call, f"{encode_opt.__name__}.opt_parse_spec_plain",
                (*args, pv.numpy(), mt.numpy(), bcap, depth, sufficient), {}))
            if not full else
            (names[2], [o[r:r + 1] for o in outs], _submit_timed(
                pool, encode_opt.opt_parse_plain, *row, pv, mt, bcap, depth, sufficient)),
        ]
        if full:  # the parse by rounds: its counts (it asserts every commit)
            jobs.append(("opt_parse:rounds", [o[r:r + 1] for o in outs], pool.submit(
                _timed_counted_call, f"{encode_opt.__name__}.opt_parse_rounds_plain",
                (*args, pv.numpy(), mt.numpy(), bcap, depth, sufficient, True), {})))
        else:  # the kernel's schedule: its tallies (rounds, links, steps)
            jobs.append(("opt_parse_spec:segments", [o[r:r + 1] for o in outs], pool.submit(
                _timed_counted_call, f"{encode_opt.__name__}.opt_parse_segments_plain",
                (*args, pv.numpy(), mt.numpy(), bcap, depth, sufficient), {})))

    def finish():
        errs, seconds, counts = _finish_holds(jobs, names, picks)
        return errs, seconds, given_up, counts

    return finish


def _finish_holds(jobs, names, picks):
    """Wait for the plain versions of held passes: each job is (pass, the
    kernel's output, future of (plain output, seconds)), the plain output
    of a counted job (`_timed_counted_call`) (output, per-row counts).
    Returns each pass's max_abs_err, the plain versions' seconds and the
    counted passes' counts."""
    import torch

    errs = dict.fromkeys(names, 0)
    seconds = dict.fromkeys(names, 0.0)
    counts = {}
    for name, mine, fut in jobs:
        errs.setdefault(name, 0)
        seconds.setdefault(name, 0.0)
        out, sec = fut.result()
        if isinstance(out, tuple) and isinstance(out[-1], list):
            out, got = out
            counts.setdefault(name, []).extend(got)
        want = [torch.from_numpy(x) for x in (out if isinstance(out, tuple) else (out,))]
        err = _max_abs_err(mine, want)
        _require(err == 0, f"{name} on rows {list(picks)}: kernel != plain")
        errs[name] = max(errs[name], err)
        seconds[name] += sec
    return errs, seconds, counts


HC_PASSES = ("opt_chain", "hc_deltas", "hc_parse")


def hold_hc_passes(base, starts, src_offs, lens, bcap: int, picks, dev, pool,
                   level: int = 9, parse_picks=(), model_picks=None):
    """The HC passes on the card over a batch of windows at ``level``, each
    held to its plain version on the batch's rows ``picks`` (the parse also
    on ``parse_picks``) with the same inputs (the kernel's own output of the
    pass before), the plain versions on ``pool`` (the parse with its
    counts).  Returns a function that waits for them and returns each
    pass's max_abs_err, the plain versions' seconds for the picked rows and
    the plain parse's per-row counts; the parse's rows (or ``model_picks``
    of them) also through the kernel's schedule, `encode_hc_passes.
    hc_parse_segments_plain` ("hc_parse:segments", its bytes held to the
    kernel's as well)."""
    import torch
    from lz4_tpu_torch.ops import encode_hc_passes as hp
    from lz4_tpu_torch.ops import encode_opt
    from lz4_tpu_torch.ops.encode_hc import level_arm

    depth = level_arm(level)[1]
    st = torch.as_tensor(starts, dtype=torch.int64).cpu()
    so = torch.as_tensor(src_offs, dtype=torch.int32).cpu()
    ln = torch.as_tensor(lens, dtype=torch.int32).cpu()
    base_d = base.to(dev)
    prev = encode_opt.opt_chain(base_d, st, ln)
    deltas = hp.hc_deltas(prev, ln)
    got = hp.hc_parse(base_d, st, so, ln, prev, deltas, bcap, depth)
    torch.cuda.synchronize()
    toff, _ = encode_opt.table_offsets(ln)
    base_h = base.cpu()
    outs = [t.cpu() for t in got]
    jobs = []
    for r in list(picks) + [r for r in parse_picks if r not in picks]:
        a, t, n = int(st[r]), int(toff[r]), int(ln[r])
        row = (base_h[a:a + n].numpy(), [0], so[r:r + 1].numpy(), ln[r:r + 1].numpy())
        pv, dl = prev[t:t + n].cpu(), deltas[t:t + n].cpu()
        if r in picks:
            jobs += [
                ("opt_chain", [pv], _submit_timed(
                    pool, encode_opt.opt_chain_plain, row[0], [0], ln[r:r + 1])),
                ("hc_deltas", [dl], _submit_timed(pool, hp.deltas_plain, pv, ln[r:r + 1]))]
        args = (*row, pv.numpy(), dl.numpy(), bcap, depth)
        jobs.append(("hc_parse", [o[r:r + 1] for o in outs], pool.submit(
            _timed_counted_call, f"{hp.__name__}.hc_parse_plain", args, {})))
        if model_picks is None or r in model_picks:
            jobs.append(("hc_parse:segments", [o[r:r + 1] for o in outs], pool.submit(
                _timed_counted_call, f"{hp.__name__}.hc_parse_segments_plain", args, {})))

    def finish():
        return _finish_holds(jobs, HC_PASSES, picks)

    return finish


REWALK = {"segment": 2048, "overlap": 4, "max_rounds": 2}  # an overlap too short to meet


def hold_rewalks(base, starts, src_offs, lens, bcap: int, dev, pool):
    """The parses by segments on the card with an overlap too short to meet
    (`REWALK`: 4 positions past segments of 2,048): most links fail, so
    segments are walked again, in a second round and then in the serial
    tail.  Each parse (level 9's `hc_parse`, level 10's `opt_parse_spec`)
    held to its plain version and to its model (`hc_parse_segments_plain`,
    `opt_parse_segments_plain`) with the same arguments: the bytes, and the
    launch's walks in each round and in the tail to the model's summed over
    the rows.  Returns a function that waits for them and returns each
    parse's max_abs_err and its schedule."""
    import torch
    from lz4_tpu_torch.ops import encode_hc_passes as hp
    from lz4_tpu_torch.ops import encode_opt

    st = torch.as_tensor(starts, dtype=torch.int64)
    so = torch.as_tensor(src_offs, dtype=torch.int32)
    ln = torch.as_tensor(lens, dtype=torch.int32)
    base_d = base.to(dev)
    rounds = REWALK["max_rounds"]
    args = (base.cpu().numpy(), st.numpy(), so.numpy(), ln.numpy())
    prev = encode_opt.opt_chain(base_d, st, ln)
    deltas = hp.hc_deltas(prev, ln)
    hc = hp.hc_parse(base_d, st, so, ln, prev, deltas, bcap, 256, **REWALK)
    hc_stats = encode_opt.segment_stats(hp.hc_parse.stats, rounds)
    matches = encode_opt.opt_matches(base_d, st, so, ln, prev, 96)
    opt = encode_opt.opt_parse_spec(base_d, st, so, ln, prev, matches, bcap, 96, 64, **REWALK)
    opt_stats = encode_opt.segment_stats(encode_opt.opt_parse_spec.stats, rounds)
    torch.cuda.synchronize()
    pv, tb, mt = prev.cpu().numpy(), deltas.cpu().numpy(), matches.cpu().numpy()
    sizes = tuple(REWALK.values())
    jobs = {
        "hc_parse": (hc, hc_stats, submit_plain(pool, hp.hc_parse_plain, *args, pv, tb, bcap),
                     pool.submit(_timed_counted_call, f"{hp.__name__}.hc_parse_segments_plain",
                                 (*args, pv, tb, bcap, 256, *sizes), {})),
        "opt_parse_spec": (opt, opt_stats, submit_plain(
            pool, encode_opt.opt_parse_spec_plain, *args, pv, mt, bcap, 96, 64), pool.submit(
                _timed_counted_call, f"{encode_opt.__name__}.opt_parse_segments_plain",
                (*args, pv, mt, bcap, 96, 64, *sizes), {}))}

    def finish():
        out = {}
        for name, (got, stats, plain, model) in jobs.items():
            (mine, counts), _ = model.result()
            err = max(_max_abs_err(got, plain_result(plain)),
                      _max_abs_err(got, [torch.from_numpy(a) for a in mine]))
            _require(err == 0, f"{name} with an overlap of 4: kernel != plain")
            want = [sum(c["walks_per_round"][r] for c in counts if r < c["rounds"])
                    for r in range(rounds)]
            _require(stats["walks_per_round"] == want
                     and stats["tail_walks"] == sum(c["tail_walks"] for c in counts),
                     f"{name} with an overlap of 4: the schedule {stats} != its model's "
                     f"{want}, tail {sum(c['tail_walks'] for c in counts)}")
            _require(stats["walks_per_round"][1] + stats["tail_walks"] > 0,
                     f"{name} with an overlap of 4: no segment walked again")
            out[name] = {"max_abs_err": err, **stats}
        return out

    return finish


def phase_hc_encode(data: bytes, rng, dev, pool):
    """Kernel B's HC and OPT arms against their plain version (computed on
    `pool`), the serial HC and OPT arms too (the passes' references), and
    each level 9, 10 and 12 pass against its own on every row.  Returns the
    worst difference of each kernel."""
    import torch
    from lz4_tpu_torch.ops import encode, encode_stream

    rows = _hc_rows(data, rng)
    bufs, lens = _stage(rows, BLOCK + 1024)
    levels = (3, 6, 9, 10, 11, 12)
    wants = {level: submit_plain(pool, encode.encode_blocks_plain, bufs, lens, BLOCK, level)
             for level in levels}
    windows = (bufs.reshape(-1), [i * bufs.shape[1] for i in range(len(rows))],
               [0] * len(rows), lens)
    passes = {level: hold_opt_passes(*windows, BLOCK, range(len(rows)), dev, pool, level)
              for level in (12, 10)}
    hc_passes = hold_hc_passes(*windows, BLOCK, range(len(rows)), dev, pool)
    rewalks = hold_rewalks(*windows, BLOCK, dev, pool)
    worst = {}
    for level in levels:
        got = encode.encode_blocks(bufs.to(dev), lens.to(dev), BLOCK, level)
        ref = "hc" if level <= 9 else "opt"
        serial = getattr(encode_stream, f"encode_windows_{ref}_serial")(
            windows[0].to(dev), *windows[1:], BLOCK, level)
        torch.cuda.synchronize()
        want = plain_result(wants[level])
        err = _max_abs_err(got, want)
        _require(err == 0, f"encode level {level}: kernel != plain")
        _require(not bool(want[2].any()), f"encode level {level}: overflow flag set")
        fn = _hc_kernel(level)
        worst[fn] = max(worst.get(fn, 0), err)
        err = _max_abs_err(serial, want)
        _require(err == 0, f"encode level {level}: the serial {ref.upper()} arm != plain")
        worst[f"encode_windows_{ref}"] = max(worst.get(f"encode_windows_{ref}", 0), err)
        print(f"[hc encode] level {level}: {len(rows)} rows equal (the passes and the "
              f"serial {ref.upper()} arm), clens={want[1].tolist()}")
    for level, finish in passes.items():
        errs, _, given_up, _ = finish()
        for name, err in errs.items():
            worst[name] = max(worst.get(name, 0), err)
        print(f"[hc encode] level {level} passes {', '.join(_opt_passes(level))}: each "
              f"equal to its plain version on all {len(rows)} rows ({given_up} searches "
              f"given up by the match pass)")
    errs, _, _ = hc_passes()
    for name, err in errs.items():
        worst[name] = max(worst.get(name, 0), err)
    for name, got in rewalks().items():
        worst[name] = max(worst.get(name, 0), got["max_abs_err"])
        print(f"[hc encode] {name} with an overlap of 4 positions (segments of "
              f"{REWALK['segment']}): walks per round {got['walks_per_round']}, "
              f"{got['tail_walks']} in the serial tail, each as its model's, the bytes "
              f"equal to the plain version's on all {len(rows)} rows")
    print(f"[hc encode] level 9 passes {', '.join(HC_PASSES)}: each equal to "
          f"its plain version on all {len(rows)} rows")
    return worst


def _hc_kernel(level: int) -> str:
    """The kernel that writes a level's encode: the HC passes' parse
    (levels 3-9) or the OPT passes' (10-11, 12) (the whole output's
    difference is kept with the parse)."""
    if level >= 10:
        return _opt_passes(level)[2]
    return "hc_parse"


def phase_hc_stream(data: bytes, rng, dev, pool):
    """Kernel D's HC and OPT arms against their plain version (computed on
    `pool`), and each level 9, 10 and 12 pass against its own on the
    chained windows and the dictionary rows.  Returns the worst difference
    of each kernel."""
    import torch
    from lz4_tpu_torch.ops import encode_stream

    worst = {}

    def hold(what, got, want):
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        _require(err == 0, f"encode_stream {what}: kernel != plain")
        _require(not bool(want[2].any()), f"encode_stream {what}: overflow flag set")
        worst[fn] = max(worst.get(fn, 0), err)
        print(f"[hc encode_stream] {what}: {want[1].numel()} rows equal, "
              f"clens={want[1].tolist()}")

    nb = len(data) // BLOCK
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    payload_d = payload.to(dev)
    st, offs, wl = chained_windows(len(data), BLOCK)
    chained = sorted(int(x) for x in rng.choice(np.arange(1, nb), 4, replace=False))
    picks = [int(rng.integers(1, nb)) for _ in range(3)]
    bufs, lens = _stage([data[k * BLOCK:(k + 1) * BLOCK] for k in picks], BLOCK)
    dls = torch.tensor([3000, 65536, 0], dtype=torch.int32)
    dicts = torch.zeros((len(picks), 65536), dtype=torch.uint8)
    for i, (k, dl) in enumerate(zip(picks, dls.tolist())):
        if dl:
            dicts[i, 65536 - dl:] = torch.frombuffer(
                bytearray(data[k * BLOCK - dl:k * BLOCK]), dtype=torch.uint8)
    at = int(rng.integers(0, len(data) - (1 << 20)))
    big, big_lens = _stage([data[at:at + (1 << 20)]], 1 << 20)
    levels = (3, 9, 10, 12)
    # the window tensors hold only the chained rows' bytes, rebased
    lo = int(st[chained].min())
    hi = int((st[chained] + wl[chained]).max())
    window = payload[lo:hi]
    wants = {level: (
        submit_plain(pool, encode_stream.encode_windows_plain, window,
                     st[chained] - lo, offs[chained], wl[chained], BLOCK, level),
        submit_plain(pool, encode_stream.encode_blocks_stream_plain, bufs, lens,
                     BLOCK, level, dicts=dicts, dict_lens=dls),
        submit_plain(pool, encode_stream.encode_blocks_stream_plain, big,
                     big_lens, 1 << 20, level),
    ) for level in levels}
    # each level 9, 10 and 12 pass on the chained windows and the dictionary rows
    # (the 1 MiB row's plain match pass would take minutes:
    # its whole output is held below)
    flat, d_st, d_so, d_ln, _ = encode_stream._stage(bufs, lens, BLOCK, dicts, dls, "dense")
    sets = ((window, st[chained] - lo, offs[chained], wl[chained], BLOCK,
             range(len(chained))), (flat, d_st, d_so, d_ln, BLOCK, range(len(picks))))
    passes = [held(*rows, dev, pool) for held in (hold_opt_passes, hold_hc_passes)
              for rows in sets]
    passes += [hold_opt_passes(*rows, dev, pool, 10) for rows in sets]
    for level in levels:
        fn = _hc_kernel(level)
        w_chain, w_dict, w_big = wants[level]
        got = encode_stream.encode_windows(
            payload_d, st[chained], offs[chained], wl[chained], BLOCK, level)
        hold(f"level {level}, chained windows of blocks {chained}", got,
             plain_result(w_chain))
        got = encode_stream.encode_blocks_stream(
            bufs.to(dev), lens.to(dev), BLOCK, level, dicts=dicts.to(dev),
            dict_lens=dls.to(dev))
        hold(f"level {level}, dictionaries {dls.tolist()}", got, plain_result(w_dict))
        got = encode_stream.encode_blocks_stream(
            big.to(dev), big_lens.to(dev), 1 << 20, level)
        hold(f"level {level}, one 1 MiB row", got, plain_result(w_big))
    for finish, (level, what) in zip(passes, ((12, "chained windows"), (12, "dictionary rows"),
                                             (9, "chained windows"), (9, "dictionary rows"),
                                             (10, "chained windows"), (10, "dictionary rows"))):
        errs, _, *rest = finish()
        for name, err in errs.items():
            worst[name] = max(worst.get(name, 0), err)
        print(f"[hc encode_stream] level {level} passes on the {what}: each equal to "
              f"its plain version" + ("" if level == 9 else f" ({rest[0]} searches given up)"))
    return worst


def check_hc_frame(data: bytes, dev, pool):
    """The level 9 independent frame of the first 1 MiB, byte for byte
    against the plain route's (the plain parse of all 16 MiB would take
    minutes)."""
    from lz4_tpu_torch import frame

    head = data[:1 << 20]
    settings = frame.EncoderSettings(compression_level=9, chain_blocks=False)
    want = pool.submit(_plain_call, "lz4_tpu_torch.frame.compress",
                       (head, settings), {"device": "cpu"})
    _require(frame.compress(head, settings, device=dev) == want.result(),
             "level 9 frame != the plain route's frame")
    print("[hc paths] level 9 independent frame of 1 MiB: equal to the plain "
          "route's, byte for byte")


def _hc_counts(level: int):
    """The wrappers that count a level's encode launches: the three HC
    passes (3-9), or the three OPT passes (10-11 with the parse by rounds,
    12 with level 12's parse)."""
    from lz4_tpu_torch.ops import encode_hc_passes, encode_opt

    if level >= 10:
        return [getattr(encode_opt, name) for name in _opt_passes(level)]
    return [encode_opt.opt_chain, encode_hc_passes.hc_deltas, encode_hc_passes.hc_parse]


def _hc_idle(level: int):
    """The wrappers a level's encode must not launch: the serial HC arm at
    levels 3-9 and the serial OPT arm at 10 and up (`encode_windows_hc` and
    `encode_windows_opt` count only those references)."""
    from lz4_tpu_torch.ops import encode_stream

    return [encode_stream.encode_windows_hc if level <= 9 else encode_stream.encode_windows_opt]


def phase_hc_paths(data: bytes, dev):
    """The HC/OPT round trips of 16 MiB at levels 9, 10, 11 and 12."""
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import decode, decode_stream

    launches, e2e = {}, {}
    for name, level, chained in (
        ("L9_independent", 9, False), ("L9_chained", 9, True),
        ("L10_independent", 10, False), ("L10_chained", 10, True),
        ("L11_independent", 11, False),
        ("L12_independent", 12, False), ("L12_chained", 12, True),
    ):
        dec = decode_stream.decode_chain if chained else decode.decode_blocks
        settings = frame.EncoderSettings(compression_level=level, chain_blocks=chained)
        counts, rates = _round_trips(data, settings, dev, _hc_counts(level) + [dec],
                                     idle=_hc_idle(level))
        launches[name] = counts
        e2e[name] = rates
        print(f"[hc paths] {name}: {len(data)} bytes -> {rates['frame_bytes']} "
              f"bytes (ratio {len(data) / rates['frame_bytes']:.4f}), round trip "
              f"exact, deterministic, launches {counts}; median "
              f"{rates['compress_GBps_median']:.4f} GB/s compress, "
              f"{rates['decompress_GBps_median']:.4f} GB/s decompress")
    return launches, e2e


OPT_KERNELS = {"opt_chain_walk": "opt_chain", "opt_chain_join": "opt_chain",
               "opt_matches_rows": "opt_matches", "opt_parse_rows": "opt_parse"}


def chain_by_sort(base_d, starts, lens):
    """`encode_opt.opt_chain`'s function as PyTorch calls on the card: the
    hashes by tensor ops, one stable `torch.sort` of the keys row * 2^15 +
    hash of the whole batch, and the predecessor scatter (prev[p] = the
    position sorted just before p where its key is p's).  The chain pass's
    library yardstick (`library_ms`); the port never calls it."""
    import torch
    from lz4_tpu_torch.ops import encode_opt

    dev = base_d.device
    ln = torch.as_tensor(lens, dtype=torch.int64).cpu()
    ins = (ln - 3).clamp(min=0)
    total, inserted = int(ln.sum()), int(ins.sum())
    toff = (torch.cumsum(ln, 0) - ln).to(dev)
    ioff = (torch.cumsum(ins, 0) - ins).to(dev)
    st = torch.as_tensor(starts, dtype=torch.int64).to(dev)
    rows = torch.repeat_interleave(torch.arange(len(ln), device=dev), ins.to(dev),
                                   output_size=inserted)
    pos = torch.arange(inserted, device=dev) - ioff[rows]
    at = st[rows] + pos
    w = (base_d[at].long() | base_d[at + 1].long() << 8 | base_d[at + 2].long() << 16
         | base_d[at + 3].long() << 24)
    keys = rows * encode_opt.CHAIN_HASHES + (((w * 2654435761) & 0xFFFFFFFF) >> 17)
    keys, order = torch.sort(keys, stable=True)
    same = keys[1:] == keys[:-1]
    prev = torch.full((total,), encode_opt.HC_EMPTY, dtype=torch.int32, device=dev)
    later, earlier = order[1:][same], order[:-1][same]
    prev[toff[rows[later]] + pos[later]] = pos[earlier].int()
    return prev


def chain_library_ms(base_d, starts, lens, hold: bool = False) -> float:
    """The chain pass's `library_ms`: `chain_by_sort` on the rows, timed by
    CUDA events over two calls; with ``hold``, its prev held equal to
    `encode_opt.opt_chain`'s first."""
    import torch
    from lz4_tpu_torch.ops import encode_opt

    if hold:
        got = encode_opt.opt_chain(base_d, starts, lens)
        _require(torch.equal(got, chain_by_sort(base_d, starts, lens)),
                 "opt_chain != the sort formulation")
        del got
    return _cuda_ms(lambda: chain_by_sort(base_d, starts, lens), 2)


def settle_chain_entry(e, longest: int, clock: float) -> None:
    """The chain pass's step counts in its `kernels` entry: `steps`, the
    segment model's dependent steps on the longest row (its longest
    segment's walk and the join's carry, one step a segment,
    `encode_opt.chain_steps`), and `step_bound_ms`, one L1 round trip
    each; `serial_step_ms`, the one-warp schedule's ceil(longest / 32)
    steps the kernel no longer takes.  The bound is the larger of the
    bytes' and the steps'."""
    from lz4_tpu_torch.ops import encode_opt

    step_ms = L1_CYCLES / clock * 1e3
    e["steps"] = sum(encode_opt.chain_steps(longest))
    e["step_bound_ms"] = e["steps"] * step_ms
    e["serial_step_ms"] = -(-longest // 32) * step_ms
    e["segment"] = encode_opt.CHAIN_SEGMENT
    if e["step_bound_ms"] > e["bound_ms"]:
        e["bound_ms"], e["bound_by"] = e["step_bound_ms"], "operations"


def chain_edge_windows(segment: int, seed: int) -> list:
    """Windows at the chain pass's segment edges, as (what, payload, view,
    starts, lens): the kernel runs on the payload on the card from byte
    ``view`` (a tensor at an odd address when not 0).  Rows back to back
    from byte 3: 40 KB of each quarter of the mix, 70 KB of zeros and of
    noise, 140 KB of noise with one 40-byte snippet across every multiple
    of 32 positions (every segment boundary), rows of 0-7 bytes, and rows
    whose n - 3 lies just before, at and after the end of the first
    segment and at the end of the second; 100 KB windows of the mix that
    start 1, 2 and 3 bytes past a 16-byte boundary, in the payload and in
    a view of it 1 byte in; a 4 MiB row of zeros; a chained window, a
    64 KB prefix and a 4 MiB block of the mix."""
    import torch

    rng = np.random.default_rng(seed)
    mix = make_corpus(8 << 20, seed)
    q = len(mix) // 4
    noise = rng.integers(0, 256, 140000, dtype=np.uint8).tobytes()
    snippet = rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
    straddled = bytearray(noise)
    for b in range(32, len(straddled) - 20, 32):
        straddled[b - 20:b + 20] = snippet
    rows = ([mix[k * q + 1000:k * q + 41000] for k in range(4)]
            + [b"\x00" * 70000, noise[:70000], bytes(straddled)]
            + [mix[100:100 + n] for n in range(8)]
            + [mix[300000:300000 + n]
               for n in (segment + 2, segment + 3, segment + 4, 2 * segment + 3)])
    blob = b"\x07" * 3 + b"".join(rows)
    starts = (3 + np.cumsum([0] + [len(r) for r in rows[:-1]])).tolist()

    def payload(b):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8)

    odd = [16 * 1000 + 1, 16 * 20000 + 2, 16 * 40000 + 3]
    return [
        ("edge rows", payload(blob), 0, starts, [len(r) for r in rows]),
        ("windows 1, 2, 3 mod 16", payload(mix), 0, odd, [100000] * 3),
        ("the same in a view 1 byte in", payload(mix), 1, odd, [100000] * 3),
        ("a 4 MiB row of zeros", torch.zeros(4 << 20, dtype=torch.uint8), 0, [0], [4 << 20]),
        ("a chained window of 64 KB and a 4 MiB block", payload(mix), 0, [q - 65536],
         [65536 + (4 << 20)]),
    ]


def hold_chain_edges(dev, seed: int) -> int:
    """`encode_opt.opt_chain` on the card held to its plain version on
    `chain_edge_windows` at the built segment size, one wrapper call each.
    Returns the number of positions held."""
    import torch
    from lz4_tpu_torch.ops import encode_opt

    held = 0
    for what, payload, view, starts, lens in chain_edge_windows(encode_opt.CHAIN_SEGMENT, seed):
        got = encode_opt.opt_chain(payload.to(dev)[view:], starts, lens)
        want = encode_opt.opt_chain_plain(payload[view:], starts, lens)
        _require(_max_abs_err([got], [want]) == 0, f"opt_chain on {what}: kernel != plain")
        held += int(sum(lens))
    return held


def hc_pass_ms(base_d, starts, src_offs, lens, bcap: int, level: int = 9,
               iters: int = 2):
    """Each HC pass's time per call on a batch of windows: CUDA events
    between the wrappers' calls (each enqueues its kernel after copying its
    row tables to the card), the mean of ``iters`` calls.  Returns
    ({pass: ms}, the passes' output)."""
    import torch
    from lz4_tpu_torch.ops import encode_hc_passes as hp
    from lz4_tpu_torch.ops import encode_opt
    from lz4_tpu_torch.ops.encode_hc import level_arm

    depth = level_arm(level)[1]
    total = dict.fromkeys(HC_PASSES, 0.0)
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        prev = encode_opt.opt_chain(base_d, starts, lens)
        ev[1].record()
        deltas = hp.hc_deltas(prev, lens)
        ev[2].record()
        got = hp.hc_parse(base_d, starts, src_offs, lens, prev, deltas, bcap, depth)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(HC_PASSES):
            total[name] += ev[i].elapsed_time(ev[i + 1])
        del prev, deltas
    return {k: v / iters for k, v in total.items()}, got


def hc_pass_entries(label: str, held: str, replaces: str, windows, got, pass_ms,
                    clock: float) -> list:
    """The `kernels` entries of the HC passes on a batch of windows (``got``
    their output), bounds from the bytes each pass must move (the step
    bounds and plain times are filled in when the plain versions end)."""
    _, _, _, wln = windows
    nb = len(wln)
    total = int(wln.sum())
    clen = int(got[1].sum())
    # each pass's inputs read once and outputs written once: the windows,
    # prev (4 bytes a window position), the deltas (2), the compressed
    # bytes and the per-row values
    moved = {"opt_chain": total + 4 * total + 20 * nb,
             "hc_deltas": 4 * total + 2 * total + 12 * nb,
             "hc_parse": total + 4 * total + 2 * total + clen + 40 * nb}
    return [{
        "name": f"{name}:{label}", "route": "cuda",
        "source": ("lz4_tpu_torch/ops/csrc/encode_opt.cu" if name == "opt_chain"
                   else "lz4_tpu_torch/ops/csrc/encode_hc_passes.cu"),
        "replaces": f"{replaces} (HC arm, level 9; lz4_tpu/ops/encode_pallas5.py:953 hc_body)",
        "path": label, "held": held, "max_abs_err": 0,
        "ms": pass_ms[name], "plain_ms": None,
        "bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "byte_bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3,
        "library_ms": None} for name in HC_PASSES]


def segment_step_bound(entry: dict, model: list, row_counts: list, clock: float) -> None:
    """A parse by segments' dependent-step bound, one L1 round trip
    (L1_CYCLES at the card's top clock) a step: its schedule's steps on
    the held rows (``model``, `parse_segments.schedule`'s tallies: each
    round's slowest walk and merge and the settling scan, the tail's walks
    one after another) in `steps` and `step_bound_ms`, the bound where it
    passes the bytes'; beside it the one-warp (OPT) or one-thread (HC)
    walk of each whole held row, the design before (``row_counts``'
    `steps`), as `serial_step_ms`, and the held rows' rounds and walks."""
    step_ms = L1_CYCLES / clock * 1e3
    entry["steps"] = max(c["steps"] for c in model)
    entry["step_bound_ms"] = entry["steps"] * step_ms
    entry["serial_step_ms"] = max(c["steps"] for c in row_counts) * step_ms
    entry["model_rounds"] = max(c["rounds"] for c in model)
    entry["model_rewalks"] = sum(c["rewalks"] + c["tail_walks"] for c in model)
    entry["model_segments"] = sum(c["segments"] for c in model)
    entry["step_bound_of"] = (f"the schedule of the {len(model)} held rows "
                              f"({entry['model_segments']} segments)")
    if entry["step_bound_ms"] > entry["bound_ms"]:
        entry["bound_ms"], entry["bound_by"] = entry["step_bound_ms"], "operations"


def settle_hc_entries(entries, finish, scale: dict, clock: float, longest: int) -> dict:
    """Fill the HC passes' entries from their plain versions on the picked
    rows: max_abs_err, the plain time scaled to the batch (times
    ``scale[pass]``), and the dependent-step bounds, one L1 round trip
    (L1_CYCLES at the card's top clock) a step: the chain pass's segment
    model over the longest row (``longest`` positions,
    `settle_chain_entry`) and the parse's schedule by segments on its held
    rows (`segment_step_bound`: `hc_parse_segments_plain`'s tallies; a
    step of a walk is an episode or a chain step of one of its searches);
    the deltas are bound by their bytes.  Returns the plain parse's and
    the model's counts."""
    errs, seconds, counts = finish()
    walk = [dict(c, steps=c["episodes"] + c["steps"]) for c in counts["hc_parse"]]
    for e, name in zip(entries, HC_PASSES):
        e["max_abs_err"] = max(errs[name], errs.get(f"{name}:segments", 0))
        e["plain_ms"] = seconds[name] * 1e3 * scale[name]
        if name == "opt_chain":
            settle_chain_entry(e, longest, clock)
        elif name == "hc_parse":
            segment_step_bound(e, counts["hc_parse:segments"], walk, clock)
    return {"parse_of_picked_rows": counts["hc_parse"],
            "segments_of_picked_rows": _schedule_summary(counts["hc_parse:segments"])}


def _schedule_summary(model: list) -> list:
    """The segment models' tallies without their per-state lists."""
    return [{k: v for k, v in c.items() if k not in ("linked_states", "walks", "walk_steps")}
            | {"slowest_walk_steps": max(c["walk_steps"], default=0)} for c in model]


def opt_memory(data: bytes, dev) -> dict:
    """The device memory of one level 10 compress of ``data``, independent
    and chained: the peak `max_memory_allocated` above what was held
    before, per payload byte, beside the OPT tables' bytes per block byte
    (`encode_opt.TABLE_BYTES` per window byte: a chained block's window
    holds its 64 KB prefix too)."""
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import encode_opt

    out = {}
    for name, chained in (("independent", False), ("chained", True)):
        settings = frame.EncoderSettings(compression_level=10, chain_blocks=chained)
        _, peak = _compress_peak(data, settings, dev)
        window = 2 * BLOCK if chained else BLOCK
        out[name] = {"peak_bytes": peak, "peak_per_payload_byte": peak / len(data),
                     "table_bytes_per_block_byte": encode_opt.TABLE_BYTES * window / BLOCK}
    return out


def opt_pass_ms(base_d, starts, src_offs, lens, bcap: int, level: int, iters: int = 2):
    """Each level 10-11 pass's time per call on a batch of windows: CUDA
    events between the wrappers' calls, as `hc_pass_ms`.  Returns ({pass:
    ms}, the passes' output)."""
    import torch
    from lz4_tpu_torch.ops import encode_opt
    from lz4_tpu_torch.ops.encode_hc import level_arm

    _, depth, sufficient, _ = level_arm(level)
    total = dict.fromkeys(SPEC_PASSES, 0.0)
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        prev = encode_opt.opt_chain(base_d, starts, lens)
        ev[1].record()
        matches = encode_opt.opt_matches(base_d, starts, src_offs, lens, prev, depth)
        ev[2].record()
        got = encode_opt.opt_parse_spec(base_d, starts, src_offs, lens, prev, matches, bcap,
                                        depth, sufficient)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(SPEC_PASSES):
            total[name] += ev[i].elapsed_time(ev[i + 1])
        del prev, matches
    return {k: v / iters for k, v in total.items()}, got


def _opt_moved(windows, got) -> dict:
    """The bytes each OPT pass must move on a batch of windows (``got``
    their output): its windows and tables read once, its table or the
    compressed bytes written once, the per-row values."""
    _, _, wso, wln = windows
    nb = len(wln)
    total = int(wln.sum())
    block = int((wln - wso).sum())
    clen = int(got[1].sum())
    return {"opt_chain": total + 4 * total + 20 * nb,
            "opt_matches": total + 4 * total + 8 * total + 24 * nb,
            "opt_parse": block + 8 * block + clen + 32 * nb,
            "opt_parse_spec": block + 8 * block + clen + 32 * nb}


def phase_hc_times(data: bytes, dev, seed: int = 0):
    """Kernel D's serial HC and OPT arms, the HC passes and the OPT passes
    at their paths' shapes: 256 rows of 64 KB (kernel B's rows, the
    independent path) and 256 chained windows.  The serial HC arm at level
    9 and the serial OPT arm at levels 10 and 12 (and 11 on the independent
    rows), the passes' references: CUDA-event times, the plain version on
    four rows of the timed launch spread over the batch, two of them past
    the 132 resident CTAs (taken by a CTA that had already encoded a row),
    held byte for byte to the launch's output and timed, scaled to the
    batch.  Levels 9, 10 and 12 on both paths and 11 on the independent
    rows: the whole output of the passes held to the serial arm's on all
    256 rows, the passes' call timed with CUDA events and each pass (levels
    9-11: CUDA events between the passes; level 12: the profiler's device
    time), each pass held to its plain version on the same four rows (the
    plain versions in a pool started after the timings) and its plain time
    scaled to the batch.  Bounds: the bytes each function must move, and
    the HC passes' and the level 10-11 parse's dependent steps.  Returns
    the `kernels` entries and the per-level summaries."""
    import torch
    from lz4_tpu_torch.ops import encode_hc_passes, encode_opt, encode_stream
    from lz4_tpu_torch.parallel.blocks import split_blocks

    t0 = time.perf_counter()
    held = hold_chain_edges(dev, seed)
    print(f"[hc times] opt_chain equal to its plain version at its segment edges "
          f"({encode_opt.CHAIN_SEGMENT} positions a segment): {held} positions in "
          f"{time.perf_counter() - t0:.1f} s")
    bufs, lens = split_blocks(data, BLOCK)
    nb = bufs.shape[0]
    payload_h = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    st, offs, wl = chained_windows(len(data), BLOCK)
    picks = [q * nb // 4 + nb // 4 - 1 for q in range(4)]
    width = bufs.shape[1]
    clock = float(_nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    windows = {  # each path's rows as kernel D's windows
        "independent": (bufs.reshape(-1), torch.arange(nb, dtype=torch.int64) * width,
                        torch.zeros(nb, dtype=torch.int32), lens),
        "chained": (payload_h, st, offs, wl),
    }
    replaces = {"independent": "lz4_tpu/ops/encode_pallas5.py:1922",
                "chained": "lz4_tpu/ops/encode_pallas_stream.py:266"}
    entries, held, serial_out = [], [], {}
    summary = {"L9": {}, "L10": {}, "L11": {}, "L12": {}}
    for level, arm, serial in ((9, "hc", encode_stream.encode_windows_hc_serial),
                               (10, "opt", encode_stream.encode_windows_opt_serial)):
        for path, row_bytes in (("independent", 12), ("chained", 24)):
            base, wst, wso, wln = windows[path]
            base_d = base.to(dev)

            def run():
                return serial(base_d, wst, wso, wln, BLOCK, level)

            got = run()
            ms = _cuda_ms(run, 2)
            t0 = time.perf_counter()
            want = encode_stream.encode_windows_plain(
                base, wst[picks], wso[picks], wln[picks], BLOCK, level)
            plain_ms = (time.perf_counter() - t0) * 1e3 / len(picks) * nb
            err = _max_abs_err([t[picks] for t in got], want)
            _require(err == 0, f"encode_windows_{arm} on the L{level} {path} "
                     f"path's rows {picks}: kernel != plain")
            clen = int(got[1].sum())
            # the payload read once, the compressed bytes written once, and
            # the per-row lengths, flags (and for D starts and prefixes)
            moved = len(data) + clen + row_bytes * nb
            entry = {
                "name": f"encode_windows_{arm}:{path}", "route": "cuda",
                "source": "lz4_tpu_torch/ops/csrc/encode_stream.cu",
                "replaces": f"{replaces[path]} ({arm.upper()} arm, level {level})",
                "path": f"L{level}_{path}", "held": path, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": None}
            serial_out[(level, path)] = got
            if arm == "hc":
                entry["role"] = ("the serial reference of the HC passes: its count, "
                                 "read around the L9 path's run, must be 0")
            else:
                entry["role"] = ("the serial reference of the OPT passes: its count, "
                                 "read around the L10, L11 and L12 paths' runs, must be 0")
                # the serial arm at level 12 (and 11), the passes' reference
                for other in (12, 11) if path == "independent" else (12,):
                    def at(other=other):
                        return encode_stream.encode_windows_opt_serial(
                            base_d, wst, wso, wln, BLOCK, other)

                    serial_out[(other, path)] = at()
                    entry[f"ms_L{other}"] = _cuda_ms(at, 2)
            entries.append(entry)
            print(f"[hc times] encode_windows_{arm} level {level}, {path}: "
                  f"{ms:.3f} ms over {nb} rows, {clen} compressed bytes; rows "
                  f"{picks} equal to the plain version"
                  + "".join(f"; level {lv} {entry[f'ms_L{lv}']:.3f} ms" for lv in (11, 12)
                            if f"ms_L{lv}" in entry))
    for path, rows in windows.items():  # the HC passes at level 9
        base, wst, wso, wln = rows
        base_d = base.to(dev)

        def run():
            return encode_stream.encode_windows(base_d, wst, wso, wln, BLOCK, 9)

        got = run()
        torch.cuda.synchronize()
        stats = _path_stats(encode_hc_passes.hc_parse, encode_opt.SEGMENT_ROUNDS)
        err = _max_abs_err(got, serial_out[(9, path)])
        _require(err == 0, f"level 9 {path}: the passes' output != the serial HC arm's")
        whole_ms = _cuda_ms(run, 2)
        pass_ms, _ = hc_pass_ms(base_d, wst, wso, wln, BLOCK)
        hc = hc_pass_entries(f"L9_{path}", path, replaces[path], rows, got, pass_ms, clock)
        hc[2].update(stats)
        hc[0]["library_ms"] = chain_library_ms(base_d, wst, wln, hold=path == "independent")
        entries += hc
        summary["L9"][path] = {
            "passes_call_ms": whole_ms, "pass_ms": pass_ms,
            "serial_ms": next(e["ms"] for e in entries
                              if e["name"] == f"encode_windows_hc:{path}"),
            "rows_equal_to_serial": nb, "max_abs_err": err,
            "segment": encode_hc_passes.HC_SEGMENT, "overlap": encode_hc_passes.HC_OVERLAP}
        held.append(("L9", path, rows, hc, hold_hc_passes))
        print(f"[hc times] level 9 {path}: passes {whole_ms:.3f} ms per call ("
              + ", ".join(f"{k} {v:.3f}" for k, v in pass_ms.items())
              + f"), all {nb} rows equal to the serial HC arm's")
    for level, path in ((10, "independent"), (10, "chained"), (11, "independent")):
        rows = windows[path]
        base, wst, wso, wln = rows
        base_d = base.to(dev)

        def run():
            return encode_stream.encode_windows(base_d, wst, wso, wln, BLOCK, level)

        got = run()
        torch.cuda.synchronize()
        stats = _path_stats(encode_opt.opt_parse_spec, encode_opt.SEGMENT_ROUNDS)
        err = _max_abs_err(got, serial_out[(level, path)])
        _require(err == 0, f"level {level} {path}: the passes' output != the serial OPT arm's")
        whole_ms = _cuda_ms(run, 2)
        pass_ms, _ = opt_pass_ms(base_d, wst, wso, wln, BLOCK, level)
        moved = _opt_moved(rows, got)
        ents = [{
            "name": f"{name}:L{level}_{path}", "route": "cuda",
            "source": "lz4_tpu_torch/ops/csrc/encode_opt.cu",
            "replaces": (f"{replaces[path]} (OPT arm at level {level}; "
                         "lz4_tpu/ops/encode_pallas5.py:1172 opt_body)"),
            "path": f"L{level}_{path}", "held": path, "max_abs_err": 0,
            "ms": pass_ms[name], "plain_ms": None,
            "bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "byte_bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3,
            "library_ms": None} for name in SPEC_PASSES]
        ents[0]["library_ms"] = chain_library_ms(base_d, wst, wln)
        ents[2].update(stats)
        entries += ents
        serial_ms = next(e for e in entries if e["name"] == f"encode_windows_opt:{path}")
        summary[f"L{level}"][path] = {
            "passes_call_ms": whole_ms, "pass_ms": pass_ms,
            "serial_ms": serial_ms["ms" if level == 10 else f"ms_L{level}"],
            "rows_equal_to_serial": nb, "max_abs_err": err}
        held.append((f"L{level}", path, rows, ents,
                     lambda *a, level=level: hold_opt_passes(*a, level=level)))
        print(f"[hc times] level {level} {path}: passes {whole_ms:.3f} ms per call ("
              + ", ".join(f"{k} {v:.3f}" for k, v in pass_ms.items())
              + f"), all {nb} rows equal to the serial OPT arm's")
    for path, (base, wst, wso, wln) in windows.items():
        base_d = base.to(dev)

        def run():
            return encode_stream.encode_windows(base_d, wst, wso, wln, BLOCK, 12)

        got = run()
        torch.cuda.synchronize()
        err = _max_abs_err(got, serial_out[(12, path)])
        _require(err == 0, f"level 12 {path}: the passes' output != the serial arm's")
        whole_ms = _cuda_ms(run, 2)
        kernel_ms, _ = _device_ms_by(run, lambda: {
            kernel: getattr(encode_opt, name).launches
            for kernel, name in OPT_KERNELS.items()}, 2)
        pass_ms = {name: sum(ms for kernel, ms in kernel_ms.items()
                             if OPT_KERNELS[kernel] == name) for name in OPT_PASSES}
        moved = _opt_moved(windows[path], got)
        for name in OPT_PASSES:
            entries.append({
                "name": f"{name}:{path}", "route": "cuda",
                "source": "lz4_tpu_torch/ops/csrc/encode_opt.cu",
                "replaces": (f"{replaces[path]} (OPT arm at level 12; "
                             "lz4_tpu/ops/encode_pallas5.py:1172 opt_body)"),
                "path": f"L12_{path}", "held": path, "max_abs_err": 0,
                "ms": pass_ms[name], "plain_ms": None,
                "bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "byte_bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3,
                "library_ms": None})
        entries[-3]["library_ms"] = chain_library_ms(base_d, wst, wln)
        summary["L12"][path] = {"passes_call_ms": whole_ms, "pass_device_ms": pass_ms,
                                "chain_kernel_device_ms": {
                                    k: kernel_ms[k] for k in ("opt_chain_walk",
                                                              "opt_chain_join")},
                                "rows_equal_to_serial": nb, "max_abs_err": err}
        held.append(("L12", path, windows[path], entries[-3:], hold_opt_passes))
        print(f"[hc times] level 12 {path}: passes {whole_ms:.3f} ms per call "
              f"(device: " + ", ".join(f"{k} {v:.3f}" for k, v in pass_ms.items())
              + f"), all {nb} rows equal to the serial OPT arm's")
    with plain_pool() as pool:
        finishes = [(lv, path, ents, hold(*rows, BLOCK, picks, dev, pool))
                    for lv, path, rows, ents, hold in held]
        for lv, path, ents, finish in finishes:
            if lv == "L9":
                summary[lv][path].update(settle_hc_entries(
                    ents, finish, dict.fromkeys(HC_PASSES, nb / len(picks)), clock,
                    int(windows[path][3].max())))
                print(f"[hc times] level 9 {path}: each pass equal to its plain "
                      f"version on rows {picks}; bounds " + ", ".join(
                          f"{e['name']} {e['bound_ms']:.4f} ms ({e['bound_by']})"
                          for e in ents))
                continue
            summary[lv][path].update(settle_opt_entries(
                ents, finish, nb / len(picks), clock, int(windows[path][3].max())))
            print(f"[hc times] level {lv[1:]} {path}: each pass equal to its plain "
                  f"version on rows {picks}; {summary[lv][path]['given_up']} searches "
                  "given up; step bounds " + ", ".join(
                      f"{e['name']} {e['step_bound_ms']:.4f} ms" for e in ents)
                  + f" (one walk of each whole row: {ents[-1]['serial_step_ms']:.3f} ms)")
    return entries, summary


def settle_opt_entries(entries, finish, scale: float, clock: float, longest: int) -> dict:
    """Fill the OPT passes' entries from their plain versions on the held
    rows (`hold_opt_passes`): max_abs_err, the plain time scaled to the
    batch (times ``scale``; level 12's parse the serial plain parse's, the
    parse by rounds' beside it as `rounds_model_ms`), and the
    dependent-step bounds, one L1 round trip (L1_CYCLES at the card's top
    clock) a step: the chain pass's segment model over the longest row
    (``longest`` positions, `settle_chain_entry`), the match pass's slowest
    held search (its chain steps plus its measures' word and byte
    compares, `most_steps`), level 12's parse's slowest held row
    (`opt_parse_rounds_row`'s `steps`, one thread's serial walk of it
    beside as `serial_step_ms`), the level 10-11 parse's schedule by
    segments on the held rows (`segment_step_bound`: `opt_parse_segments_
    plain`'s tallies, a walk's steps the parse by rounds' `steps`).  A step
    bound above the bytes' is the bound (`bound_by` "operations").
    Returns the summary's counts."""
    errs, seconds, given_up, counts = finish()
    parse = entries[-1]["name"].split(":")[0]
    model = parse + ":rounds" if parse + ":rounds" in counts else parse
    step_ms = L1_CYCLES / clock * 1e3
    steps = {"opt_matches": max(c["most_steps"] for c in counts["opt_matches"]),
             parse: max(c["steps"] for c in counts[model])}
    for e in entries:
        name = e["name"].split(":")[0]
        e["max_abs_err"] = max(errs[name], errs.get(f"{name}:segments", 0))
        e["plain_ms"] = seconds[name] * 1e3 * scale
        if name == "opt_chain":
            settle_chain_entry(e, longest, clock)
            continue
        if name == "opt_parse_spec":
            segment_step_bound(e, counts["opt_parse_spec:segments"], counts[model], clock)
            continue
        e["steps"] = steps[name]
        e["step_bound_ms"] = steps[name] * step_ms
        if e["step_bound_ms"] > e["bound_ms"]:
            e["bound_ms"], e["bound_by"] = e["step_bound_ms"], "operations"
    e = entries[-1]
    if model != parse:
        e["serial_step_ms"] = max(c["serial_steps"] for c in counts[model]) * step_ms
        e["rounds_model_ms"] = seconds[model] * 1e3 * scale
    summary = {"given_up": given_up, "matches_of_picked_rows": counts["opt_matches"],
               "parse_of_picked_rows": counts[model]}
    if "opt_parse_spec:segments" in counts:
        summary["segments_of_picked_rows"] = _schedule_summary(
            counts["opt_parse_spec:segments"])
    return summary


def _path_stats(parse, rounds: int) -> dict:
    """The schedule of a parse by segments' last launch (``parse.stats``,
    `encode_opt.segment_stats`): its rounds, each round's walks, the
    tail's walks, the links kept; read after a path's run."""
    from lz4_tpu_torch.ops import encode_opt

    got = encode_opt.segment_stats(parse.stats, rounds)
    _require(got["overflow"] == 0, f"{parse.__name__}: a walk overflowed its records")
    _require(got["links_behind_frontier"] == 0,
             f"{parse.__name__}: a link behind the frontier")
    return {"rounds": got["rounds"], "walks_per_round": got["walks_per_round"][:got["rounds"]],
            "tail_walks": got["tail_walks"], "links": got["links"]}


def _cli_hc(level: int = 9):
    """`lz4 -9`'s settings (``level`` 10 or 11: `lz4 -10`, `lz4 -11`): the
    command line's defaults (independent 4 MB blocks, a content checksum)
    at that level."""
    from lz4_tpu_torch import frame

    return frame.EncoderSettings(chain_blocks=False, block_size=CLI_BLOCK,
                                 content_checksum=True, compression_level=level)


def _compress_peak(data: bytes, settings, dev):
    """One `frame.compress` of ``data`` and the device memory it allocates
    at its peak above what was held before."""
    import torch
    from lz4_tpu_torch import frame

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held_before = torch.cuda.memory_allocated(dev)
    blob = frame.compress(data, settings, device=dev)
    return blob, torch.cuda.max_memory_allocated(dev) - held_before


def _hold_cli_frame(blob: bytes, data: bytes, serial, lens, size: int, what: str) -> None:
    """Every block of ``blob``, a frame of ``data`` in independent blocks
    of ``size``, equal to the serial arm's output ``serial`` on the same
    rows (stored where that output does not shrink the block)."""
    from lz4_tpu_torch.frame.api import _scan_single_frame

    _, blocks, _ = _scan_single_frame(blob)
    _require(len(blocks) == len(lens), f"{what} frame: wrong number of blocks")
    out, clens = serial[0].cpu(), serial[1].cpu()
    for k, (off, length, stored) in enumerate(blocks):
        n, c = int(lens[k]), int(clens[k])
        want = data[k * size:k * size + n] if c >= n else out[k, :c].numpy().tobytes()
        _require(stored == (c >= n) and blob[off:off + length] == want,
                 f"{what} frame: block {k} != the serial arm's bytes")


def phase_cli_hc(data: bytes, dev, pool):
    """The `lz4 -9` path: --mb MiB through `frame.compress` /
    `frame.decompress` with `_cli_hc`'s settings (the HC passes, kernel A's
    passes, kernel E), counts set to 0 just before and read just after,
    exact and deterministic over three runs after a warm-up; the frame's
    blocks held byte for byte to the serial HC arm's output on the same
    rows (timed once); the passes timed on those rows (CUDA events between
    them), the parse's rounds and walks (`_path_stats`), the parse held to
    its plain version on the last row (noise, the most episodes); each pass
    on 256 KB of the first row (text, the most chain steps) and of the last,
    as rows of their own (the plain parse of the 4 MiB text row would take
    ~90 s); the parse's step bound its schedule's on those cuts
    (`encode_hc_passes.hc_parse_segments_plain`, its bytes held too).  The
    device memory one compress allocates at its peak, beside the HC passes'
    tables (prev, the deltas and the parse's records).  Returns the
    launches, the rates, the `kernels` entries and a summary."""
    import torch
    from lz4_tpu_torch.ops import decode, encode_hc_passes, encode_opt, encode_stream, xxh32
    from lz4_tpu_torch.parallel.blocks import split_blocks

    settings = _cli_hc()
    frames = []
    launches, e2e = _round_trips(data, settings, dev,
                                 _hc_counts(9) + [decode.decode_blocks, xxh32.xxh32_windows],
                                 ROW_PASSES, idle=_hc_idle(9), frames=frames)
    blob, peak = frames[0], e2e["compress_peak_allocated_bytes"]
    path_stats = _path_stats(encode_hc_passes.hc_parse, encode_opt.SEGMENT_ROUNDS)
    size = CLI_BLOCK
    bufs, lens = split_blocks(data, size)
    nb = bufs.shape[0]
    tables = 6 * int(lens.sum()) + encode_hc_passes.parse_scratch_bytes([0] * nb, lens)
    rows = (bufs.reshape(-1), torch.arange(nb, dtype=torch.int64) * bufs.shape[1],
            torch.zeros(nb, dtype=torch.int32), lens)
    base_d = rows[0].to(dev)
    clock = float(_nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    pass_ms, got = hc_pass_ms(base_d, *rows[1:], size, iters=1)
    t0 = time.perf_counter()
    serial = encode_stream.encode_windows_hc_serial(base_d, *rows[1:], size, 9)
    torch.cuda.synchronize()
    serial_ms = (time.perf_counter() - t0) * 1e3
    err = _max_abs_err(got, serial)
    _require(err == 0, "lz4 -9 rows: the passes' output != the serial HC arm's")
    _hold_cli_frame(blob, data, serial, lens, size, "lz4 -9")
    entries = hc_pass_entries("lz4_9", "independent", "lz4_tpu/ops/encode_pallas_stream.py:266",
                              rows, got, pass_ms, clock)
    entries[0]["library_ms"] = chain_library_ms(base_d, rows[1], rows[3])
    # 256 KB of the text row and of the noise row as rows of their own, after the 16
    cut = size // 16
    held = (rows[0], torch.cat([rows[1], rows[1][[0, nb - 1]]]),
            torch.cat([rows[2], rows[2][:2]]), torch.cat([lens, torch.tensor([cut, cut])]))
    finish = hold_hc_passes(*held, size, [nb, nb + 1], dev, pool, parse_picks=[nb - 1],
                            model_picks=[nb, nb + 1])
    summary = {"pass_ms": pass_ms, "passes_ms": sum(pass_ms.values()),
               "serial_ms": serial_ms, "rows_equal_to_serial": nb,
               "frame_equal_to_serial": True, "hc_table_bytes": tables,
               "hc_table_bytes_per_payload_byte": tables / len(data),
               "compress_peak_allocated_bytes": peak,
               "compress_peak_per_payload_byte": peak / len(data)}
    held_bytes = 2 * cut
    summary.update(settle_hc_entries(entries, finish, {
        "opt_chain": len(data) / held_bytes, "hc_deltas": len(data) / held_bytes,
        "hc_parse": len(data) / (held_bytes + int(lens[nb - 1]))}, clock,
        int(lens.max())))
    entries[2].update(path_stats)
    summary["parse_schedule"] = path_stats
    summary["long_repeats"] = hc_repeat_rows(size, dev)
    print(f"[lz4 -9] {len(data)} bytes -> {e2e['frame_bytes']} bytes (ratio "
          f"{len(data) / e2e['frame_bytes']:.4f}), round trip exact, deterministic, "
          f"launches {launches}; median {e2e['compress_GBps_median']:.4f} GB/s "
          f"compress, {e2e['decompress_GBps_median']:.4f} GB/s decompress; passes "
          + ", ".join(f"{k} {v:.3f}" for k, v in pass_ms.items())
          + f" ms, the serial HC arm {serial_ms:.1f} ms on the same {nb} rows, "
          f"every block of the frame equal to its output; each pass equal to its "
          f"plain version (the parse on the last row and the cuts); a compress "
          f"allocates {peak} bytes at its peak, the HC tables {tables}")
    return launches, e2e, entries, summary


def hc_repeat_rows(size: int, dev) -> dict:
    """The HC passes at level 9 on two rows of ``size`` bytes of long
    repeats, zeros and a 3-byte pattern, where every walk's first search
    measures the repeat to the row's end on one thread: each pass's time
    (`hc_pass_ms`), the parse's schedule, the output equal to the serial
    HC arm's."""
    import torch
    from lz4_tpu_torch.ops import encode_hc_passes, encode_opt, encode_stream

    pattern = torch.tensor(list(b"abc"), dtype=torch.uint8).repeat(size // 3 + 1)[:size]
    base = torch.cat([torch.zeros(size, dtype=torch.uint8), pattern]).to(dev)
    rows = (torch.tensor([0, size]), torch.zeros(2, dtype=torch.int32),
            torch.tensor([size, size], dtype=torch.int32))
    pass_ms, got = hc_pass_ms(base, *rows, size)
    stats = _path_stats(encode_hc_passes.hc_parse, encode_opt.SEGMENT_ROUNDS)
    serial = encode_stream.encode_windows_hc_serial(base, *rows, size, 9)
    _require(_max_abs_err(got, serial) == 0,
             "long repeats: the HC passes' output != the serial HC arm's")
    return {"row_bytes": size, "rows": ["zeros", "abc"], "pass_ms": pass_ms,
            "parse_schedule": stats, "equal_to_serial": True}


def phase_cli_opt(data: bytes, dev, pool, level: int):
    """The `lz4 -10` or `lz4 -11` path (``level``): --mb MiB through
    `frame.compress` / `frame.decompress` with `_cli_hc(level)`'s settings
    (the level 10-11 passes, kernel A's passes, kernel E), counts set to 0
    just before and read just after, exact and deterministic over three
    runs after a warm-up, the serial OPT arm's count 0; the frame's blocks
    held byte for byte to the serial OPT arm's output on the same rows
    (timed once); the passes timed once on those rows (CUDA events between
    them); each pass run on 256 KB of the first row (text) and of the first
    records row, as rows of their own, and held there to its plain version
    (the plain match pass over a 4 MiB row would take minutes), and the
    match pass (at level 10) on the whole 4 MiB text, records and runs rows
    held on spans across its slice boundaries (`hold_match_spans`): the
    chain pass's step bound is the 4 MiB rows', the match pass's that of
    the held positions, the parse's the schedule's on the held cuts (16
    segments each, also held to the parse's schedule model,
    `encode_opt.opt_parse_segments_plain`), the launch's rounds and walks
    (`_path_stats`) beside.  The device memory a compress allocates at its peak, beside the OPT
    tables' bytes (`encode_opt.TABLE_BYTES` a block byte).  Returns the
    launches, the rates, the `kernels` entries and a summary."""
    import torch
    from lz4_tpu_torch.ops import decode, encode_opt, encode_stream, xxh32
    from lz4_tpu_torch.parallel.blocks import split_blocks

    label = f"lz4_{level}"
    settings = _cli_hc(level)
    frames = []
    launches, e2e = _round_trips(data, settings, dev,
                                 _hc_counts(level) + [decode.decode_blocks, xxh32.xxh32_windows],
                                 ROW_PASSES, idle=_hc_idle(level), frames=frames)
    blob, peak = frames[0], e2e["compress_peak_allocated_bytes"]
    path_stats = _path_stats(encode_opt.opt_parse_spec, encode_opt.SEGMENT_ROUNDS)
    size = CLI_BLOCK
    bufs, lens = split_blocks(data, size)
    nb = bufs.shape[0]
    rows = (bufs.reshape(-1), torch.arange(nb, dtype=torch.int64) * bufs.shape[1],
            torch.zeros(nb, dtype=torch.int32), lens)
    base_d = rows[0].to(dev)
    clock = float(_nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    pass_ms, got = opt_pass_ms(base_d, *rows[1:], size, level, iters=1)
    t0 = time.perf_counter()
    serial = encode_stream.encode_windows_opt_serial(base_d, *rows[1:], size, level)
    torch.cuda.synchronize()
    serial_ms = (time.perf_counter() - t0) * 1e3
    err = _max_abs_err(got, serial)
    _require(err == 0, f"lz4 -{level} rows: the passes' output != the serial OPT arm's")
    _hold_cli_frame(blob, data, serial, lens, size, f"lz4 -{level}")
    moved = _opt_moved(rows, got)
    entries = [{
        "name": f"{name}:{label}", "route": "cuda",
        "source": "lz4_tpu_torch/ops/csrc/encode_opt.cu",
        "replaces": ("lz4_tpu/ops/encode_pallas_stream.py:266 (OPT arm at level "
                     f"{level}; lz4_tpu/ops/encode_pallas5.py:1172 opt_body)"),
        "path": label, "held": "independent", "max_abs_err": 0,
        "ms": pass_ms[name], "plain_ms": None,
        "bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "byte_bound_ms": moved[name] / HBM_BYTES_PER_S * 1e3,
        "library_ms": None} for name in SPEC_PASSES]
    entries[0]["library_ms"] = chain_library_ms(base_d, rows[1], rows[3])
    # at level 10 the match pass on whole 4 MiB rows (text, records, runs),
    # held on spans of positions around slice boundaries and at the rows' ends
    spans = (hold_match_spans(rows, [0, nb // 4, nb // 2], level, dev, pool) if level == 10
             else lambda: {"rows": [], "positions": 0, "counts": []})
    # 256 KB of the first text row and the first records row as rows of their own
    cut = size // 16
    extra = [0, nb // 4]
    finish = hold_opt_passes(
        rows[0], rows[1][extra], rows[2][extra], torch.tensor([cut, cut], dtype=torch.int32),
        size, [0, 1], dev, pool, level=level)
    held = settle_opt_entries(entries, finish, len(data) / (2 * cut), clock, int(lens.max()))
    spans = spans()
    e = entries[1]  # the match pass: its slowest held search, on the cuts or the spans
    e["steps"] = max([e["steps"], *(c["most_steps"] for c in spans["counts"])])
    e["step_bound_ms"] = e["steps"] * L1_CYCLES / clock * 1e3
    if e["step_bound_ms"] > e["bound_ms"]:
        e["bound_ms"], e["bound_by"] = e["step_bound_ms"], "operations"
    e["step_bound_of"] = "the held 256 KB cuts and spans of the 4 MiB rows"
    e = entries[-1]
    e["step_bound_of"] = ("the schedule of the held 256 KB cuts of the text and records "
                          f"rows ({e['model_segments']} segments)")
    e.update(path_stats)
    given_up, counts = held["given_up"], held["parse_of_picked_rows"]
    tables = encode_opt.TABLE_BYTES * len(data)
    summary = {"pass_ms": pass_ms, "passes_ms": sum(pass_ms.values()),
               "serial_ms": serial_ms, "rows_equal_to_serial": nb,
               "frame_equal_to_serial": True, "opt_table_bytes": tables,
               "opt_table_bytes_per_payload_byte": tables / len(data),
               "compress_peak_allocated_bytes": peak,
               "compress_peak_per_payload_byte": peak / len(data),
               "given_up_in_held_cuts": given_up, "parse_of_held_cuts": counts,
               "matches_of_held_cuts": held["matches_of_picked_rows"],
               "segments_of_held_cuts": held["segments_of_picked_rows"],
               "matches_of_held_spans": spans, "parse_schedule": path_stats}
    print(f"[lz4 -{level}] {len(data)} bytes -> {e2e['frame_bytes']} bytes (ratio "
          f"{len(data) / e2e['frame_bytes']:.4f}), round trip exact, deterministic, "
          f"launches {launches}; median {e2e['compress_GBps_median']:.4f} GB/s "
          f"compress, {e2e['decompress_GBps_median']:.4f} GB/s decompress; passes "
          + ", ".join(f"{k} {v:.3f}" for k, v in pass_ms.items())
          + f" ms, the serial OPT arm {serial_ms:.1f} ms on the same {nb} rows, "
          f"every block of the frame equal to its output; each pass equal to its "
          f"plain version on 256 KB of the text and records rows, the match pass "
          f"on {spans['positions']} positions of the 4 MiB rows {spans['rows']} "
          f"around slice boundaries (step bounds " + ", ".join(
              f"{x['name']} {x['step_bound_ms']:.3f} ms" for x in entries)
          + f"); a compress allocates {peak} bytes at its peak, the OPT tables {tables}")
    return launches, e2e, entries, summary


def hold_match_spans(rows, picks, level: int, dev, pool):
    """The match pass (`encode_opt.opt_matches` at ``level``'s depth) on
    the whole rows ``picks`` of a batch of windows (``rows``: base, starts,
    src_offs, lens), held to its plain version on spans of positions: 256
    around the boundaries of slices 4 and 5 (the first whose staged deltas
    start above the row's start), of the middle slice, and the row's last
    1,024 positions (searches whose matches and patterns run to the row's
    end); the chain pass held whole.  The plain
    versions run on ``pool``.  Returns a function that waits for them and
    returns the held rows and positions and the plain match pass's counts
    per span."""
    import torch
    from lz4_tpu_torch.ops import encode_opt
    from lz4_tpu_torch.ops.encode_hc import level_arm

    depth = level_arm(level)[1]
    base, st, so, ln = rows
    st, so, ln = st[picks], so[picks], ln[picks]
    base_d = base.to(dev)
    prev = encode_opt.opt_chain(base_d, st, ln)
    matches = encode_opt.opt_matches(base_d, st, so, ln, prev, depth)
    torch.cuda.synchronize()
    toff, _ = encode_opt.table_offsets(ln)
    base_h = base.cpu()
    jobs, held = [], 0
    for j in range(len(picks)):
        a, t, n = int(st[j]), int(toff[j]), int(ln[j])
        row = base_h[a:a + n].numpy()
        pv = prev[t:t + n].cpu()
        mt = matches[t:t + n].cpu()
        jobs.append(("opt_chain", pv, None, _submit_timed(
            pool, encode_opt.opt_chain_plain, row, [0], ln[j:j + 1])))
        middle = n // encode_opt.SLICE // 2 * encode_opt.SLICE
        for p0, p1 in [(k - 128, k + 128) for k in (4 * encode_opt.SLICE, 5 * encode_opt.SLICE,
                                                    middle)] + [(n - 1024, n)]:
            held += p1 - p0
            jobs.append(("opt_matches", mt, (p0, p1), pool.submit(
                _timed_counted_call, f"{encode_opt.__name__}.opt_matches_plain",
                (row, [0], so[j:j + 1].numpy(), ln[j:j + 1].numpy(), pv.numpy(), depth),
                {"span": (p0, p1)})))

    def finish():
        counts = []
        for name, mine, span, fut in jobs:
            out, _ = fut.result()
            if span is None:
                _require(_max_abs_err([mine], [torch.from_numpy(out)]) == 0,
                         f"opt_chain on a 4 MiB row: kernel != plain")
                continue
            out, got = out
            p0, p1 = span
            _require(_max_abs_err([mine[p0:p1]], [torch.from_numpy(out)[p0:p1]]) == 0,
                     f"opt_matches on a 4 MiB row, positions [{p0}, {p1}): kernel != plain")
            counts.append({"span": list(span), **got[0]})
        return {"rows": list(picks), "positions": held, "counts": counts}

    return finish


XXH_LENGTHS = [0, 1, 3, 4, 15, 16, 17, 31, 32, 100, 1024, 4097, 65536]
# kernel E's dependent chain: a multiply-add, a rotate and a multiply per
# 16-byte stripe, each waiting for the one before (an estimate, in cycles)
CHAIN_CYCLES_PER_STRIPE = 10
# kernel E's times before its redesign (PERF.md §6, H100 80GB HBM3, 700 W:
# the profiler's device time for rows and the streaming form, CUDA events
# for the window), printed beside this run's in brackets and not in the
# `kernels` line: this run does not measure them (`xxhbench.py --parent`
# times both kernels in turns)
XXH32_BEFORE_MS = {"xxh32_windows:rows": 0.0463, "xxh32_windows:stream": 41.782,
                   "xxh32_stripes": 0.6519}


def _stripe_cycles(entry: dict, stripes: int, clock: float) -> dict:
    """Kernel E's `kernels` entry with its measured cycles a stripe (its
    time at the card's top SM clock over the longest window's stripes)."""
    entry["cycles_per_stripe"] = entry["ms"] * 1e-3 * clock / stripes
    return entry


def _device_ms(fn, kernel: str, count, iters: int):
    """The device time of `kernel` per call of `fn` (torch.profiler), for a
    kernel shorter than its wrapper's host time: the wrapper's copies of
    its window table to the card synchronise the stream, so CUDA events
    around its calls would time the host.  ``count()`` reads the wrapper's
    launch count of it.  Returns (ms, the launches the profiler recorded)."""
    ms, seen = _device_ms_by(fn, lambda: {kernel: count()}, iters)
    return ms[kernel], seen[kernel]


def _device_ms_by(fn, counts, iters: int):
    """The device time per call of `fn` of each kernel that ``counts()``
    names (torch.profiler), and the launches of each that the profiler
    recorded over ``iters`` calls.  ``counts()`` reads the wrappers' launch
    counts of those kernels; their growth over one call is each kernel's
    launches per call.  The profiler drops events now and then, so a
    kernel's time per call is its recorded total over its recorded
    launches, times its launches per call; a record short of ``iters``
    times that is printed.  Every kernel must have been recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = counts()
    fn()
    torch.cuda.synchronize()
    per_call = {k: n - before[k] for k, n in counts().items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys(per_call, 0.0)
    seen = dict.fromkeys(per_call, 0)
    for e in prof.key_averages():
        for k in per_call:
            if k in e.key:
                totals[k] += e.self_device_time_total
                seen[k] += e.count
    ms = {}
    for k, n in per_call.items():
        _require(n > 0, f"a call launched no {k}")
        _require(seen[k] > 0 and totals[k] > 0, f"the profiler saw no {k} launch")
        if seen[k] != iters * n:
            print(f"[profiler] recorded {seen[k]} of {iters * n} {k} launches")
        ms[k] = totals[k] / seen[k] * n / 1e3
    return ms, seen


def _timed_plain_call(qualname: str, args, kwargs):
    """`_plain_call` in a worker, with its time on the worker's clock (the
    module imported before the clock starts: a fresh worker's first import
    of torch takes seconds)."""
    import importlib

    importlib.import_module(qualname.rsplit(".", 1)[0])
    t0 = time.perf_counter()
    out = _plain_call(qualname, args, kwargs)
    return out, time.perf_counter() - t0


def _timed_counted_call(qualname: str, args, kwargs):
    """`_timed_plain_call` of a plain version that fills a ``counts`` list:
    ((output, its per-row counts), seconds)."""
    counts = []
    out, seconds = _timed_plain_call(qualname, args, {**kwargs, "counts": counts})
    return (out, counts), seconds


def xxh32_windows_in_pool(pool, data: bytes):
    """The plain hashes of kernel E's long windows, on `pool`: 1 MiB and
    4 MiB windows at unaligned starts, the whole --mb payload (the timed
    window), and the host hash (`lz4_tpu_torch.xxh32`, the route kernel E
    replaces) on 4 MiB.  Returns (windows, futures)."""
    from lz4_tpu_torch.ops import xxh32

    flat = np.frombuffer(data, np.uint8)
    windows = [(3, 1 << 20), (1001, 4 << 20), (0, len(data))]
    qual = f"{xxh32.__name__}.{xxh32.xxh32_windows_plain.__name__}"
    futures = [pool.submit(_timed_plain_call, qual, (flat[a:a + n], [0], [n]), {})
               for a, n in windows]
    futures.append(pool.submit(_timed_plain_call, "lz4_tpu_torch.xxh32.xxh32",
                               (data[:4 << 20],), {}))
    return windows, futures


def phase_xxh32(data: bytes, rng, dev, windows, futures):
    """Kernel E against its plain version, and its times at the checksum
    paths' two shapes: 1,024 rows of 64 KB (block checksums) and the whole
    payload as one window (a content checksum).  Returns its two `kernels`
    entries and the host hash's seconds on 4 MiB."""
    import torch
    from lz4_tpu_torch.ops import xxh32
    from lz4_tpu_torch.parallel.blocks import split_blocks

    worst = 0

    def hold(what, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        err = _max_abs_err([got], [want])
        _require(err == 0, f"xxh32 {what}: kernel != plain")
        worst = max(worst, err)
        print(f"[xxh32] {what}: {want.numel()} hashes equal")

    bufs = torch.from_numpy(rng.integers(0, 256, (len(XXH_LENGTHS), 65536), dtype=np.uint8))
    lens = torch.tensor(XXH_LENGTHS, dtype=torch.int32)
    hold(f"rows of {XXH_LENGTHS} bytes", xxh32.xxh32_blocks(bufs.to(dev), lens),
         xxh32.xxh32_blocks_plain(bufs, lens))
    flat = torch.from_numpy(rng.integers(0, 256, 300000, dtype=np.uint8))
    starts = [a + k for a in (0, 150001) for k in range(16)]
    wl = [XXH_LENGTHS[k % len(XXH_LENGTHS)] for k in range(len(starts))]
    hold("windows at starts 0-15 and 150,001-150,016 mod 16",
         xxh32.xxh32_windows(flat.to(dev), starts, wl),
         xxh32.xxh32_windows_plain(flat, starts, wl))

    # the block-checksum shape: every row of the timed launch held
    rows, row_lens = split_blocks(data, BLOCK)
    rows_d = rows.to(dev)
    got = xxh32.xxh32_blocks(rows_d, row_lens)
    rows_call_ms = _cuda_ms(lambda: xxh32.xxh32_blocks(rows_d, row_lens), 20)
    rows_ms, _ = _device_ms(lambda: xxh32.xxh32_blocks(rows_d, row_lens),
                            "xxh32_windows", lambda: xxh32.xxh32_windows.launches, 20)
    t0 = time.perf_counter()
    want = xxh32.xxh32_blocks_plain(rows, row_lens)
    rows_plain_ms = (time.perf_counter() - t0) * 1e3
    hold(f"all {rows.shape[0]} rows of the timed 64 KB batch", got, want)

    # the content-checksum shape: the payload as one window
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    gots = [xxh32.xxh32_windows(payload, [a], [n]) for a, n in windows]
    stream_ms = _cuda_ms(lambda: xxh32.xxh32_windows(payload, [0], [len(data)]), 5)
    plain_s = []
    for (a, n), g, fut in zip(windows, gots, futures):
        out, seconds = fut.result()
        plain_s.append(seconds)
        hold(f"one window of {n} bytes at {a}", g, torch.from_numpy(out))
    _, host_s = futures[len(windows)].result()

    clock = float(_nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    nb = rows.shape[0]
    entries = []
    for name, ms, plain_ms, path, moved, stripes in (
        ("xxh32_windows:rows", rows_ms, rows_plain_ms, "independent_both",
         int(row_lens.sum()) + 16 * nb, BLOCK // 16),
        ("xxh32_windows:stream", stream_ms, plain_s[-1] * 1e3, "cli_default",
         len(data) + 16, len(data) // 16),
    ):
        # bytes: each window's bytes read once, its int64 start and int32
        # length read and its hash written; chain: the longest window's
        # stripes one after another at the card's top clock
        byte_ms = moved / HBM_BYTES_PER_S * 1e3
        chain_ms = stripes * CHAIN_CYCLES_PER_STRIPE / clock * 1e3
        entries.append(_stripe_cycles({
            "name": name, "route": "cuda",
            "source": "lz4_tpu_torch/ops/csrc/xxh32.cu",
            "replaces": "lz4_tpu/ops/xxh32_pallas.py:121", "path": path,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, chain_ms),
            "bound_by": "bytes" if byte_ms >= chain_ms else "operations",
            "byte_bound_ms": byte_ms, "chain_bound_ms": chain_ms,
            "library_ms": None}, stripes, clock))
    for e in entries:
        e["max_abs_err"] = worst
    entries[0]["call_ms"] = rows_call_ms
    rows_e, stream_e = entries
    print(f"[xxh32] {rows_ms:.4f} ms [{XXH32_BEFORE_MS[rows_e['name']]}] per {nb} rows "
          f"of 64 KB on the device ({rows_call_ms:.4f} ms per wrapper call), "
          f"{stream_ms:.3f} ms [{XXH32_BEFORE_MS[stream_e['name']]}] per {len(data)}-byte "
          f"window; "
          f"{rows_e['cycles_per_stripe']:.2f} / {stream_e['cycles_per_stripe']:.2f} cycles "
          f"a stripe (bound {CHAIN_CYCLES_PER_STRIPE}; max SM clock {clock / 1e6:.0f} MHz); "
          f"plain {rows_plain_ms:.1f} ms and {plain_s[-1] * 1e3:.1f} ms; the "
          f"host hash it replaces: {host_s:.3f} s per 4 MiB")
    return entries, host_s


def phase_checksum_paths(data: bytes, dev):
    """The three checksummed round trips; `_round_trips` fails a path that
    never launches kernel E, as for every kernel it counts.  Each path is
    then profiled once (`profile_path`): how many ms of E's device time
    overlap kernel D and the copies, on compress and on decompress (its
    content hashes run on E's side stream)."""
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import decode, decode_stream, encode, encode_stream, xxh32

    launches, e2e, profiles = {}, {}, {}
    for name, payload, settings, counts, kernels, traced in (
        ("cli_default", data, _cli_default(),
         [encode_stream.encode_blocks_stream, decode.decode_blocks], ROW_PASSES,
         ("encode_windows", "rows_gather")),
        ("independent_both", data,
         frame.EncoderSettings(chain_blocks=False, block_checksum=True,
                               content_checksum=True),
         [encode.encode_blocks, decode.decode_blocks], ("decode_rows",),
         ("encode_windows", "decode_rows")),
        ("chained_both", data,
         frame.EncoderSettings(block_checksum=True, content_checksum=True),
         [encode_stream.encode_blocks_stream, decode_stream.decode_chain], (),
         ("encode_windows", "chain_parse")),
    ):
        got, rates = _round_trips(payload, settings, dev,
                                  counts + [xxh32.xxh32_windows], kernels)
        launches[name], e2e[name] = got, rates
        print(f"[checksums] {name}: {len(payload)} bytes -> "
              f"{rates['frame_bytes']} bytes, round trip exact, deterministic, "
              f"launches {got}; median {rates['compress_GBps_median']:.4f} GB/s "
              f"compress, {rates['decompress_GBps_median']:.4f} GB/s decompress")
        need = {k: 1 for k in traced}
        need["xxh32_windows"] = got["xxh32_windows"]
        profiles[name] = profile_path(payload, dev, settings, need, attempts=5)
        over = profiles[name]["overlap_by_events"] = stream_overlaps(payload, dev, settings)
        print(f"[checksums] {name}: kernel E on its side stream, ms of its device "
              f"time overlapping D / the copies (CUDA events): compress "
              f"{over['compress']['with_encode_ms']:.3f} / "
              f"{over['compress']['with_copies_ms']:.3f} of "
              f"{over['compress']['xxh32_ms']:.3f}; decompress "
              f"{over['decompress']['with_encode_ms']:.3f} / "
              f"{over['decompress']['with_copies_ms']:.3f} of "
              f"{over['decompress']['xxh32_ms']:.3f}")
    return launches, e2e, profiles


STREAM_WRITE = 1 << 20  # the streaming path's write and read size
SMALL_WRITE = 64 << 10  # ... and its small calls


def _limited_bytes(comp: bytes, limit: int) -> int:
    """The compressed bytes a partial decode at ``limit`` reads: the
    sequences walked until the output reaches the limit (or the block
    ends), for the limited decode's byte bound."""
    ip, op, n = 0, 0, len(comp)
    while ip < n:
        token = comp[ip]
        ip += 1
        ll = token >> 4
        if ll == 15:
            while ip < n:
                ip += 1
                ll += comp[ip - 1]
                if comp[ip - 1] != 255:
                    break
        if op + ll >= limit:
            return ip + (limit - op)
        ip += ll
        op += ll
        if ip >= n:
            break
        ip += 2
        ml = (token & 15) + 4
        if (token & 15) == 15:
            while ip < n:
                ip += 1
                ml += comp[ip - 1]
                if comp[ip - 1] != 255:
                    break
        op += ml
        if op >= limit:
            break
    return min(ip, n)


def stripes_update_both(flat, flat_d, a: int, n: int, tail: bytes, accs):
    """`stripes_update` (kernel E's streaming form, the wrapper a stream's
    content hash calls) over flat[a : a + n] after the carried bytes
    ``tail``, from the accumulators ``accs`` (uint32 values), on the card
    (``flat_d``, flat's copy there) and on its CPU route: each state read
    back as (accumulators, tail bytes), (card, cpu)."""
    from lz4_tpu_torch.ops import xxh32

    out = []
    for f in (flat_d, flat):
        state, carried = xxh32.stripes_state(accs, tail, f.device)
        state, carried = xxh32.stripes_update(state, carried, f[a:a + n])
        out.append(xxh32.stripes_read(state, carried))
    return out


def _stripes_err(card, cpu) -> int:
    """The largest difference of two `stripes_update_both` states'
    accumulators; their tails must be equal."""
    _require(card[1] == cpu[1], "stripes_update: the carried tails differ")
    return max(abs(g - w) for g, w in zip(card[0], cpu[0]))


def hold_stripes(rng, dev) -> int:
    """Kernel E's streaming form (`stripes_update`) against its CPU route
    on windows at starts and lengths 1, 15, 16 and 17, with and without a
    carried tail, and on a 4 MiB window (a CLI-default pull's update) after
    a carried 9-byte tail, from random accumulators; and `XXH32.update` on
    CUDA tensors of 1, 15, 16, 17 and longer splits (a tail carried across
    device updates and from a host update) against the one-shot host hash,
    and of 4 MiB after a carried tail against the plain hash."""
    import torch
    from lz4_tpu_torch.ops import xxh32

    host = importlib.import_module("lz4_tpu_torch.xxh32")
    raw = rng.integers(0, 256, 300000, dtype=np.uint8)
    flat = torch.from_numpy(raw)
    flat_d = flat.to(dev)
    worst = 0
    cases = [(a, n, t) for a in (0, 1, 15, 16, 17)
             for n in (0, 1, 15, 16, 17, 33, 65537, 250001) for t in (0, 9)]
    for a, n, t in cases:
        accs = [int(x) for x in rng.integers(0, 1 << 32, 4, dtype=np.uint64)]
        tail = rng.integers(0, 256, t, dtype=np.uint8).tobytes()
        worst = max(worst, _stripes_err(*stripes_update_both(flat, flat_d, a, n, tail, accs)))
    # a CLI-default pull's update: 4 MiB after a carried 9-byte tail
    big = rng.integers(0, 256, (4 << 20) + 9, dtype=np.uint8)
    big_h = torch.from_numpy(big)
    big_d = big_h.to(dev)
    accs = [int(x) for x in rng.integers(0, 1 << 32, 4, dtype=np.uint64)]
    worst = max(worst, _stripes_err(*stripes_update_both(
        big_h, big_d, 9, 4 << 20, big[:9].tobytes(), accs)))
    _require(worst == 0, "stripes_update: kernel != its CPU route")
    h = host.XXH32()
    h.update(big[:9].tobytes())
    h.update(big_d[9:])
    _require(h.digest() == xxh32.as_uint32(
        xxh32.xxh32_windows_plain(big_h, [0], [big.size]))[0],
        "XXH32 over a 4 MiB device update after a carried tail != the plain hash")
    for splits, total in (([1, 15, 16, 17], 20000), ([17, 16, 15, 1], 20000),
                          ([3, 65536, 5, 100000], raw.size)):
        h = host.XXH32()
        h.update(raw[:7].tobytes())  # a host update's tail carried over
        pos, k = 7, 0
        while pos < total:
            n = splits[k % len(splits)]
            h.update(flat_d[pos:min(pos + n, total)])
            pos, k = pos + n, k + 1
        _require(h.digest() == host.xxh32(raw[:total].tobytes()),
                 f"XXH32 over device updates of {splits} != the one-shot hash")
    print(f"[stream] stripes_update: {len(cases)} windows at starts and lengths "
          f"1/15/16/17 and a 4 MiB window after a 9-byte tail equal to its CPU route; XXH32 "
          f"over device updates of 1, 15, 16 and 17 bytes equal to the host hash, "
          f"over 4 MiB after a 9-byte tail to the plain hash")
    return worst


def hold_limited_decode(data: bytes, rng, dev):
    """Kernel A's one-warp route with output limits against its plain
    version: sequence-writer rows (overlapping matches, long runs) with and
    without dictionaries, limits at random points (inside literal runs and
    overlapping matches), past the end and 0; 64 KB rows of the mix; and
    rows malformed after the limit (cut short or with their last bytes
    flipped).  Returns (max_abs_err, rows, limits) for the timing."""
    import torch
    from lz4_tpu_torch import block
    from lz4_tpu_torch.ops import decode
    from lz4_tpu_torch.parallel.blocks import comp_capacity

    rows, windows, limits, after = [], [], [], []
    for k in range(12):
        wlen = int(rng.choice([0, 100, 65536]))
        window = rng.integers(0, 256, wlen, dtype=np.uint8).tobytes()
        c, o = write_stream(rng, window, BLOCK)
        for lim in (0, 1, int(rng.integers(1, len(o) + 1)), len(o) + 10):
            rows.append(c)
            windows.append(window)
            limits.append(lim)
    for k in range(8):
        raw = data[k * 8 * BLOCK:k * 8 * BLOCK + BLOCK]
        c = block.encode(raw, device=dev)
        lim = int(rng.integers(1, BLOCK))
        cut = bytearray(c[:len(c) // 2])
        flipped = bytearray(c)
        flipped[-8:] = bytes(8)
        for row, l in ((c, lim), (bytes(cut), min(lim, 2000)), (bytes(flipped), 1000),
                       (bytes(cut), BLOCK)):
            if l < BLOCK and row is not c:
                after.append(len(rows))
            rows.append(row)
            windows.append(b"")
            limits.append(l)
    comps, clens = _stage(rows, comp_capacity(BLOCK))
    dicts = torch.zeros((len(rows), 65536), dtype=torch.uint8)
    dlens = torch.tensor([len(w) for w in windows], dtype=torch.int32)
    for i, w in enumerate(windows):
        if w:
            dicts[i, 65536 - len(w):] = torch.frombuffer(bytearray(w), dtype=torch.uint8)
    lim = torch.tensor(limits, dtype=torch.int32)
    got = decode.decode_blocks(comps.to(dev), clens.to(dev), BLOCK, dicts.to(dev),
                               dlens.to(dev), limits=lim)
    torch.cuda.synchronize()
    want = decode.decode_blocks_plain(comps, clens, BLOCK, dicts, dlens, limits=lim)
    err = _max_abs_err(got, want)
    _require(err == 0, "decode with limits: kernel != plain")
    _require(not bool(want[2][after].any()), "a row malformed after its limit was refused")
    _require(bool(want[2].any()), "no row was malformed before its limit")
    print(f"[stream] decode_rows with limits: {len(rows)} rows equal to the plain "
          f"version ({int((want[2] != 0).sum())} flagged, malformed before their "
          f"limits; the {len(after)} rows malformed after their limits decoded)")
    return err


def offset_stream(rng, window: bytes, limit: int, offsets=range(1, 41)):
    """A valid LZ4 block and the bytes it decodes to, its matches at each
    of ``offsets`` in turn (1-31 overlap their own output) and, where the
    right-aligned `window` allows, one match in four starting in the window
    and running on into the output, another anywhere in the window."""
    comp, hist = bytearray(), bytearray(window)
    k = 0
    while True:
        ll = int(rng.choice([0, 1, 3, 15, 16, 40]))
        ml = int(rng.choice([4, 5, 17, 19, 33, 64, 300]))
        if not hist:
            ll = max(ll, 1)  # something to match against
        at = len(hist) - len(window) + ll  # the match's output position
        off = offsets[k % len(offsets)]
        if window and k % 4 == 3:  # from the window on into the output
            off = at + 1 + int(rng.integers(0, min(len(window), 64)))
            ml = max(ml, off - at + 8)
        elif window and k % 4 == 1:  # anywhere in the window
            off = at + 1 + int(rng.integers(0, len(window)))
        off = min(off, len(hist) + ll, 65535)
        if at + ml + 300 > limit:
            break
        k += 1
        comp.append((min(ll, 15) << 4) | min(ml - 4, 15))
        if ll >= 15:
            _vle(comp, ll - 15)
        lits = rng.integers(0, 256, ll, dtype=np.uint8).tobytes()
        comp += lits + off.to_bytes(2, "little")
        if ml >= 19:
            _vle(comp, ml - 19)
        hist += lits
        for _ in range(ml):
            hist.append(hist[-off])
    ll = int(rng.integers(0, 20))
    lits = rng.integers(0, 256, ll, dtype=np.uint8).tobytes()
    comp.append(min(ll, 15) << 4)
    if ll >= 15:
        _vle(comp, ll - 15)
    comp += lits
    hist += lits
    return bytes(comp), bytes(hist[len(window):])


def sequence_edges(comp: bytes) -> list:
    """Each sequence's output position after its literal run and after its
    match, for a valid block: the limits that fall on those edges."""
    edges, ip, op = [], 0, 0
    while ip < len(comp):
        token = comp[ip]
        ip += 1
        ll = token >> 4
        if ll == 15:
            while True:
                ip += 1
                ll += comp[ip - 1]
                if comp[ip - 1] != 255:
                    break
        ip += ll
        op += ll
        if ip >= len(comp):
            edges.append((op, op))
            break
        ip += 2
        ml = (token & 15) + 4
        if token & 15 == 15:
            while True:
                ip += 1
                ml += comp[ip - 1]
                if comp[ip - 1] != 255:
                    break
        edges.append((op, op + ml))
        op += ml
    return edges


def warp_edge_batches(seed: int, encode_row) -> list:
    """The one-warp route's edge rows, as batches of (name, rows, out_cap,
    windows or None, limits or None): offset streams (offsets 1-40, matches
    from the dictionary into the output) at dictionary lengths 0, 1, 100
    and 65,536; limits inside a literal run, inside a match, on a sequence
    end, at 0 and past the end; a row at compress_bound(64 KB) (random
    bytes: one literal run longer than the ring holds), a 64 KB row of
    zeros, literal runs longer than the ring followed by matches; rows of
    the mix at out_cap 16, 1,000 and 65,535, and at 4,096 with limits
    above it and up to it; rows of 0 and 1 byte and every
    corrupt kind; rows of up to 1 MiB of output (one of 900,000 bytes with
    runs of 300,000 random bytes) on the route's output-in-place form.  ``encode_row(raw)`` compresses one row
    (the card's encoder in `chip_smoke.py`, the plain one in the tests)."""
    rng = np.random.default_rng(seed)
    mix = make_corpus(4 * BLOCK, seed)
    windows, rows, outs = [], [], []
    for wlen in (0, 1, 100, 65536):
        window = rng.integers(0, 256, wlen, dtype=np.uint8).tobytes()
        c, o = offset_stream(rng, window, BLOCK)
        windows.append(window)
        rows.append(c)
        outs.append(o)
    batches = [("offsets", rows, BLOCK, windows, None)]
    lrows, lwins, lims = [], [], []
    for c, w, o in zip(rows, windows, outs):
        edges = sequence_edges(c)
        lit = next(a for a, b in edges if a >= 2)  # a run long enough to cut
        match = next(b for a, b in edges if b - a >= 2 and a > 0)
        for lim in (0, lit - 1, match - 1, edges[len(edges) // 2][1], len(o), BLOCK):
            lrows.append(c)
            lwins.append(w)
            lims.append(lim)
    batches.append(("limits", lrows, BLOCK, lwins, lims))
    noise = encode_row(rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes())
    zeros = encode_row(bytes(BLOCK))
    texts = [encode_row(mix[k * BLOCK:(k + 1) * BLOCK]) for k in range(4)]
    # literal runs longer than the ring, each then a match: the parse goes
    # past ring stages it never reads
    run = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    long_runs = encode_row(run + run[:5000] + run[7:30007] + run[:9000])
    batches.append(("bounds", [noise, zeros, long_runs] + texts, BLOCK, None, None))
    for cap in (16, 1000, 65535):
        cut = [encode_row(mix[k * BLOCK:k * BLOCK + cap]) for k in range(4)]
        batches.append((f"out_cap {cap}", cut + corrupt_rows(cut[0]), cap, None, None))
    batches.append(("limits past out_cap", texts[:2] + [noise, long_runs], 4096, None,
                    [5000, 65536, 4096, 100]))
    batches.append(("short and corrupt", [b"", b"\x00", b"\x10a", b"\x10"]
                    + corrupt_rows(texts[0]) + corrupt_rows(noise), BLOCK, None, None))
    big_run = rng.integers(0, 256, 300000, dtype=np.uint8).tobytes()
    big = texts[:2] + corrupt_rows(texts[1])[:3] + [
        encode_row(big_run + mix[:200000] + big_run[:100000] + big_run)]
    batches.append(("1 MiB out_cap", big, 1 << 20, None, None))
    batches.append(("1 MiB out_cap, limits", big, 1 << 20, None,
                    [1000, 70000, 200, 1 << 20, 5, 650000]))
    return batches


def hold_warp_edges(dev, seed: int) -> int:
    """Kernel A's one-warp route against its plain version on
    `warp_edge_batches`, max_abs_err over the whole output tensor, lens and
    errs: each batch's rows 1-15 bytes into their 16-byte chunks (rows of a
    width that is not a multiple of 16, in a view 1-15 bytes into its
    tensor).  Returns the largest difference (0)."""
    import torch
    from lz4_tpu_torch import block
    from lz4_tpu_torch.ops import decode

    worst, n = 0, 0
    batches = warp_edge_batches(seed, lambda raw: block.encode(raw, device=dev))
    for k, (name, rows, out_cap, windows, limits) in enumerate(batches):
        lead = 1 + k % 15
        width = max(len(r) for r in rows) + 21 + (k % 2)
        width += (width % 16 == 0)
        flat = torch.zeros(lead + len(rows) * width, dtype=torch.uint8)
        for i, r in enumerate(rows):
            if r:
                at = lead + i * width
                flat[at:at + len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
        comps = flat[lead:].view(len(rows), width)
        clens = torch.tensor([len(r) for r in rows], dtype=torch.int32)
        dicts = dls = None
        if windows is not None:
            dflat = torch.zeros(lead + len(rows) * 65536, dtype=torch.uint8)
            dicts = dflat[lead:].view(len(rows), 65536)
            for i, w in enumerate(windows):
                if w:
                    dicts[i, 65536 - len(w):] = torch.frombuffer(bytearray(w), dtype=torch.uint8)
            dls = torch.tensor([len(w) for w in windows], dtype=torch.int32)
        lim = None if limits is None else torch.tensor(limits, dtype=torch.int32)
        want = decode.decode_blocks_plain(comps, clens, out_cap, dicts, dls, limits=lim)
        cflat = flat.to(dev)
        args = (cflat[lead:].view(len(rows), width), clens.to(dev), out_cap,
                None if dicts is None else dflat.to(dev)[lead:].view(len(rows), 65536),
                None if dls is None else dls.to(dev),
                None if lim is None else lim.to(dev))
        got = decode._launch_warp(*args)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        _require(err == 0, f"one-warp route, edge batch {name!r}: kernel != plain")
        worst = max(worst, err)
        n += len(rows)
    print(f"[edges] one-warp route: {n} edge rows in {len(batches)} batches equal to the "
          f"plain version over the whole output (offsets 1-40 and dictionary reach, limits "
          f"on the edges, compress_bound, out_cap 16/1,000/65,535, 0 and 1 byte, the "
          f"corrupt kinds, 1 MiB out_cap), rows 1-15 bytes into their chunks")
    return worst


def _stream_file(data: bytes, settings, dev, size: int = STREAM_WRITE):
    """`LZ4FrameFile` writes of ``size`` bytes, then reads of as many:
    (frame, write seconds, read seconds)."""
    import io
    import torch
    from lz4_tpu_torch import frame

    sink = io.BytesIO()
    t0 = time.perf_counter()
    with frame.open(sink, "wb", settings=settings, device=dev) as f:
        for a in range(0, len(data), size):
            f.write(data[a:a + size])
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    blob = sink.getvalue()
    parts = []
    t0 = time.perf_counter()
    with frame.open(io.BytesIO(blob), "rb", device=dev) as f:
        while True:
            chunk = f.read(size)
            if not chunk:
                break
            parts.append(chunk)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    _require(b"".join(parts) == data, "streaming round trip is not exact")
    return blob, write_s, read_s


def _counted(counts, kernels, idle, fn):
    """``fn()`` with every count of ``counts`` and ``idle`` (wrappers) and
    of kernel A's ``kernels`` set to 0 just before and read just after;
    each of ``counts`` and ``kernels`` must be above 0, each of ``idle`` 0.
    Returns (fn's result, the counts)."""
    from lz4_tpu_torch.ops import decode

    for f in (*counts, *idle):
        f.launches = 0
    for k in decode.kernel_launches:
        decode.kernel_launches[k] = 0
    out = fn()
    got = {f.__name__: f.launches for f in counts}
    got.update({k: decode.kernel_launches[k] for k in kernels})
    for name, n in got.items():
        _require(n > 0, f"path never launched {name}")
    for f in idle:
        _require(f.launches == 0, f"path launched {f.__name__} {f.launches} times")
        got[f.__name__] = 0
    return out, got


def legacy_frame(data: bytes, dev) -> bytes:
    """The lz4 CLI's legacy frame (`lz4 -l`) of ``data``: its magic, then
    each 8 MiB block's u32 length and LZ4 block (encoded on the card)."""
    from lz4_tpu_torch import block

    parts = [struct.pack("<I", 0x184C2102)]
    for a in range(0, len(data), 8 << 20):
        c = block.encode(data[a:a + (8 << 20)], device=dev)
        parts += [struct.pack("<I", len(c)), c]
    return b"".join(parts)


def phase_streaming(data: bytes, rng, dev):
    """The streaming path and the other host-surface paths on the card:
    LZ4FrameFile at the `lz4` CLI default and chained with both checksums
    (1 MiB writes and reads, each frame equal to the one-shot frame), a
    three-frame stream with a skippable frame, a 16 MiB legacy frame, a
    ChainDecoder over a chained frame's blocks (C's batch form), and
    `partial_decode`, `pickle` and `legacy.wrap` round trips; kernel E's
    streaming form and kernel A's limited route held to their plain
    versions and timed.  Returns (launches, rates, kernel entries)."""
    import torch
    from lz4_tpu_torch import block, frame, legacy, pickle, unpickle
    from lz4_tpu_torch.block.incremental import ChainDecoder
    from lz4_tpu_torch.frame.api import _scan_single_frame
    from lz4_tpu_torch.ops import decode, decode_stream, encode_stream, xxh32
    from lz4_tpu_torch.parallel.blocks import comp_capacity

    host = importlib.import_module("lz4_tpu_torch.xxh32")
    t_phase = time.perf_counter()
    stripes_err = hold_stripes(rng, dev)
    limit_err = hold_limited_decode(data, rng, dev)
    idle = (host.host_stripes,)
    launches, rates = {}, {}
    cli_counts = [encode_stream.encode_blocks_stream, decode.decode_blocks,
                  xxh32.stripes_update]
    for name, settings, counts, kernels, size in (
        ("stream_cli_default", _cli_default(), cli_counts, ROW_PASSES, STREAM_WRITE),
        # 64 KiB calls: a Linux pipe's buffer and shutil.copyfileobj's chunk
        ("stream_cli_default_64k", _cli_default(), cli_counts, ROW_PASSES,
         SMALL_WRITE),
        # 12 MiB of extra memory: the writer holds four 4 MiB blocks and
        # encodes them in one launch (the frame is the same)
        ("stream_cli_default_extra",
         dataclasses.replace(_cli_default(), extra_memory=12 << 20),
         cli_counts, ROW_PASSES, STREAM_WRITE),
        ("stream_chained_both",
         frame.EncoderSettings(block_checksum=True, content_checksum=True),
         [encode_stream.encode_blocks_stream, decode_stream.decode_chain,
          xxh32.xxh32_windows, xxh32.stripes_update], (), STREAM_WRITE),
    ):
        t0 = time.perf_counter()
        one_shot = frame.compress(data, settings, device=dev)
        t1 = time.perf_counter()
        _require(frame.decompress(one_shot, device=dev) == data, "one-shot round trip")
        t2 = time.perf_counter()
        (blob, write_s, read_s), launches[name] = _counted(
            counts, kernels, idle, lambda: _stream_file(data, settings, dev, size))
        _require(blob == one_shot, f"{name}: the streamed frame != the one-shot frame")
        rates[name] = {
            "bytes": len(data), "frame_bytes": len(blob), "call_bytes": size,
            "write_GBps": len(data) / write_s / 1e9,
            "read_GBps": len(data) / read_s / 1e9,
            "one_shot_compress_GBps": len(data) / (t1 - t0) / 1e9,
            "one_shot_decompress_GBps": len(data) / (t2 - t1) / 1e9}
        print(f"[stream] {name}: {len(data)} bytes in {size}-byte writes "
              f"-> {len(blob)} bytes, equal to the one-shot frame, read back exact; "
              f"write {rates[name]['write_GBps']:.4f} GB/s, read "
              f"{rates[name]['read_GBps']:.4f} GB/s (one-shot "
              f"{rates[name]['one_shot_compress_GBps']:.4f} / "
              f"{rates[name]['one_shot_decompress_GBps']:.4f}); launches {launches[name]}")

    # three frames, a skippable frame between the first two
    q = 16 << 20
    parts = [frame.compress(data[:q], _cli_default(), device=dev),
             frame.skippable_frame(b"metadata", nibble=5),
             frame.compress(data[q:2 * q], frame.EncoderSettings(content_checksum=True),
                            device=dev),
             frame.compress(data[2 * q:3 * q], frame.EncoderSettings(chain_blocks=False),
                            device=dev)]
    stream = b"".join(parts)
    t0 = time.perf_counter()
    got, launches["multi_frame"] = _counted(
        [decode.decode_blocks, decode_stream.decode_chain, xxh32.stripes_update],
        (), idle, lambda: frame.decompress(stream, device=dev))
    rates["multi_frame"] = {"bytes": 3 * q,
                            "decompress_GBps": 3 * q / (time.perf_counter() - t0) / 1e9}
    _require(got == data[:3 * q], "three-frame stream did not decode exactly")
    print(f"[stream] three frames and a skippable frame ({len(stream)} bytes) "
          f"decoded exact, {rates['multi_frame']['decompress_GBps']:.4f} GB/s; "
          f"launches {launches['multi_frame']}")

    # a 16 MiB legacy frame: two 8 MiB blocks on A's passes
    leg = legacy_frame(data[:q], dev)
    t0 = time.perf_counter()
    got, launches["legacy_frame"] = _counted(
        [decode.decode_blocks], ROW_PASSES, idle, lambda: frame.decompress(leg, device=dev))
    rates["legacy_frame"] = {"bytes": q,
                             "decompress_GBps": q / (time.perf_counter() - t0) / 1e9}
    _require(got == data[:q], "legacy frame did not decode exactly")
    print(f"[stream] legacy frame of {q} bytes decoded exact, "
          f"{rates['legacy_frame']['decompress_GBps']:.4f} GB/s; "
          f"launches {launches['legacy_frame']}")

    # C's batch form: a ChainDecoder over a chained frame's blocks
    chained = frame.compress(data[:2 << 20], device=dev)
    _, blocks, _ = _scan_single_frame(chained)

    def chain_decode():
        dec = ChainDecoder(BLOCK, device=dev)
        return b"".join(dec.inject_block(chained[o:o + n]) if st
                        else dec.decode_block(chained[o:o + n]) for o, n, st in blocks)

    one_row = ROUTE_KERNELS[decode.route(1, BLOCK)]  # a lone 64 KB row's route
    got, launches["chain_decoder"] = _counted(
        [decode_stream.decode_blocks_stream], one_row, idle, chain_decode)
    _require(got == data[:2 << 20], "ChainDecoder did not decode exactly")

    # one block's partial decode, pickles and wraps
    comp64 = block.encode(data[:BLOCK], device=dev)

    def host_apis():
        for lim in (0, 1, 4097, BLOCK):
            _require(block.partial_decode(comp64, lim, device=dev) == data[:lim],
                     f"partial_decode at {lim}")
        _require(unpickle(pickle(data[:1 << 20], device=dev), device=dev)
                 == data[:1 << 20], "pickle round trip")
        _require(legacy.unwrap(legacy.wrap_hc(data[:BLOCK], device=dev), device=dev)
                 == data[:BLOCK], "legacy wrap round trip")
        return legacy.decode(legacy.encode(data[:4 << 20], device=dev), device=dev)

    got, launches["host_apis"] = _counted(
        [encode_stream.encode_blocks_stream, decode.decode_blocks],
        ("decode_rows", "decode_rows_limit"), idle, host_apis)
    _require(got == data[:4 << 20], "legacy stream round trip")
    # one block's decode and one partial decode, each alone: the route the
    # rule gives a lone row, and the one-warp route for a limit
    got, launches["block_decode"] = _counted(
        [decode.decode_blocks], one_row, idle,
        lambda: block.decode(comp64, target_length=BLOCK, device=dev))
    _require(got == data[:BLOCK], "block.decode")
    got, launches["partial_decode"] = _counted(
        [decode.decode_blocks], ("decode_rows", "decode_rows_limit"), idle,
        lambda: block.partial_decode(comp64, 4097, device=dev))
    _require(got == data[:4097], "partial_decode")
    paths = {p: {"rule": "warp" if p == "partial_decode" else decode.route(1, BLOCK),
                 "launches": {k: launches[p].get(k, 0) for k in ("decode_rows", *ROW_PASSES)}}
             for p in ("chain_decoder", "block_decode", "partial_decode")}
    for p, v in paths.items():
        ran = "warp" if v["launches"]["decode_rows"] else "rows"
        _require(ran == v["rule"] and (v["launches"]["rows_gather"] > 0) == (ran == "rows"),
                 f"{p} launched the {ran} route, not the rule's {v['rule']}")
    print(json.dumps({"routes": {"paths": paths}}))
    print(f"[stream] ChainDecoder over {len(blocks)} blocks exact, launches "
          f"{launches['chain_decoder']}; partial_decode, pickle, legacy wrap and "
          f"stream exact, launches {launches['host_apis']}")

    # times at the paths' shapes: a 1 MiB update of the content hash, one
    # 64 KB block's partial decode to half its length, one 64 KB block with
    # a 64 KB dictionary (a ChainDecoder's)
    clock = float(_nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    win = torch.frombuffer(bytearray(data[:STREAM_WRITE + 16]), dtype=torch.uint8)
    win_d = win.to(dev)
    seeded = list(xxh32._SEEDED)
    accs_d, tail_d = xxh32.stripes_state(seeded, b"", dev)
    side = xxh32.side_stream(dev)

    def stripes_fn():  # one update, the caller's stream made to wait for it
        xxh32.stripes_update(accs_d, tail_d, win_d[:STREAM_WRITE])
        torch.cuda.current_stream(dev).wait_stream(side)

    stripes_ms, stripes_seen = _device_ms(
        stripes_fn, "xxh32_windows", lambda: xxh32.stripes_update.launches, 20)
    stripes_call_ms = _cuda_ms(stripes_fn, 20)
    accs_c, tail_c = xxh32.stripes_state(seeded, b"", "cpu")
    t0 = time.perf_counter()
    xxh32.stripes_update(accs_c, tail_c, win[:STREAM_WRITE])
    stripes_plain_ms = (time.perf_counter() - t0) * 1e3
    # the timed update from the seed, and 1 MiB updates at odd starts, with
    # and without a carried tail, against the CPU route
    for a, tail in ((0, b""), (1, b""), (15, b""), (9, data[:7]), (3, data[:15])):
        stripes_err = max(stripes_err, _stripes_err(*stripes_update_both(
            win, win_d, a, STREAM_WRITE, tail, seeded)))
    _require(stripes_err == 0, "stripes_update on a 1 MiB update: kernel != its CPU route")
    byte_ms = (STREAM_WRITE + 32) / HBM_BYTES_PER_S * 1e3
    chain_ms = STREAM_WRITE // 16 * CHAIN_CYCLES_PER_STRIPE / clock * 1e3
    limit = BLOCK // 2
    rows_a = lambda: decode.kernel_launches["decode_rows"]  # noqa: E731
    comps, clens = _stage([comp64], comp_capacity(BLOCK))
    lim = torch.tensor([limit], dtype=torch.int32)
    comps_d, clens_d, lim_d = comps.to(dev), clens.to(dev), lim.to(dev)
    limit_fn = lambda: decode.decode_blocks(comps_d, clens_d, BLOCK, limits=lim_d)  # noqa: E731
    limit_ms, limit_seen = _device_ms(limit_fn, "decode_rows", rows_a, 20)
    limit_call_ms = _cuda_ms(limit_fn, 20)
    t0 = time.perf_counter()
    decode.decode_blocks_plain(comps, clens, BLOCK, limits=lim)
    limit_plain_ms = (time.perf_counter() - t0) * 1e3
    limit_bytes = _limited_bytes(comp64, limit) + limit
    limit_steps = warp_step_bound([comp64], clock, limit)
    d_comp = block.encode(data[BLOCK:2 * BLOCK], dictionary=data[:BLOCK], device=dev)
    dcomps, dclens = _stage([d_comp], comp_capacity(BLOCK))
    dicts = torch.frombuffer(bytearray(data[:BLOCK]), dtype=torch.uint8).reshape(1, BLOCK)
    dlens = torch.tensor([BLOCK], dtype=torch.int32)
    args_d = [t.to(dev) for t in (dcomps, dclens)]
    dict_d = [t.to(dev) for t in (dicts, dlens)]
    t0 = time.perf_counter()
    want = decode_stream.decode_blocks_stream(dcomps, dclens, BLOCK, dicts, dlens)
    dict_plain_ms = (time.perf_counter() - t0) * 1e3
    _require(want[0][0].numpy().tobytes() == data[BLOCK:2 * BLOCK],
             "decode_blocks_stream's plain version with a dictionary")
    dict_bytes = len(d_comp) + 2 * BLOCK
    dict_steps = warp_step_bound([d_comp], clock, window=data[:BLOCK])
    dict_byte_ms = dict_bytes / HBM_BYTES_PER_S * 1e3
    dict_routes = {}
    for name, kernels in ROUTE_KERNELS.items():  # C's batch form on each route
        def route_fn(name=name):
            return decode._decode(name, args_d[0], args_d[1], BLOCK, dict_d[0], dict_d[1])[0]

        ms, seen = _device_ms_by(
            route_fn, lambda k=kernels: {p: decode.kernel_launches[p] for p in k}, 20)
        got = route_fn()
        dict_routes[name] = {"ms": sum(ms.values()), "kernel_ms": ms, "seen": seen,
                             "call_ms": _call_ms(route_fn, 20),
                             "max_abs_err": _max_abs_err(got, want)}
        _require(dict_routes[name]["max_abs_err"] == 0,
                 f"decode_blocks_stream with a dictionary on the {name} route: kernel != plain")
    entries = [
        _stripe_cycles(
            {"name": "xxh32_stripes", "route": "cuda", "wrapper": "stripes_update",
             "source": "lz4_tpu_torch/ops/csrc/xxh32.cu",
             "replaces": "lz4_tpu/ops/xxh32_pallas.py:121",
             "launches": launches["stream_cli_default"]["stripes_update"],
             "max_abs_err": stripes_err, "ms": stripes_ms, "plain_ms": stripes_plain_ms,
             "bound_ms": max(byte_ms, chain_ms),
             "bound_by": "bytes" if byte_ms >= chain_ms else "operations",
             "byte_bound_ms": byte_ms, "chain_bound_ms": chain_ms, "library_ms": None,
             "launches_chained_both": launches["stream_chained_both"]["stripes_update"],
             "call_ms": stripes_call_ms, "profiled_launches": stripes_seen},
            STREAM_WRITE // 16, clock),
        _step_bound(
            {"name": "decode_blocks:limit", "route": "cuda",
             "source": "lz4_tpu_torch/ops/csrc/decode.cu",
             "replaces": "lz4_tpu/ops/decode_pallas6.py:643",
             "launches": launches["host_apis"]["decode_rows_limit"],
             "max_abs_err": limit_err, "ms": limit_ms, "plain_ms": limit_plain_ms,
             "bound_ms": limit_bytes / HBM_BYTES_PER_S * 1e3, "rule": "warp",
             "paths": {"partial_decode": paths["partial_decode"]},
             "library_ms": None, "call_ms": limit_call_ms, "profiled_launches": limit_seen},
            limit_steps),
    ] + [
        # the one-warp route's bound counts its schedule's steps; the passes
        # parse every position at once, their bound is the bytes'
        (_step_bound if name == "warp" else lambda e, _: e)(
            {"name": f"decode_blocks_stream:{name}", "route": "cuda",
             "source": "lz4_tpu_torch/ops/csrc/decode.cu",
             "replaces": "lz4_tpu/ops/decode_pallas_stream.py:636",
             "launches": launches["chain_decoder"].get(
                 "decode_rows" if name == "warp" else "rows_gather", 0),
             "rule": decode.route(1, BLOCK), "paths": {
                 p: paths[p] for p in ("chain_decoder", "block_decode")},
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "kernel_ms": r["kernel_ms"],
             "plain_ms": dict_plain_ms, "bound_ms": dict_byte_ms, "bound_by": "bytes",
             "library_ms": None, "call_ms": r["call_ms"], "profiled_launches": r["seen"]},
            dict_steps)
        for name, r in dict_routes.items()
    ]
    print(f"[stream] device time per launch (profiled launches of 20; CUDA events "
          f"per wrapper call): stripes_update {stripes_ms:.4f} ms "
          f"[{XXH32_BEFORE_MS['xxh32_stripes']}] per 1 MiB update "
          f"({stripes_seen}; {stripes_call_ms:.4f}; plain {stripes_plain_ms:.1f} ms, "
          f"chain bound {chain_ms:.4f}); decode_rows with a limit {limit_ms:.4f} ms "
          f"per 64 KB row to {limit} bytes ({limit_seen}; {limit_call_ms:.4f}; plain "
          f"{limit_plain_ms:.1f}); with a 64 KB dictionary " + ", ".join(
              f"the {k} route {r['ms']:.4f} ms ({r['call_ms']:.4f} per call)"
              for k, r in dict_routes.items())
          + f" (plain {dict_plain_ms:.1f}); phase {time.perf_counter() - t_phase:.1f} s")
    return launches, rates, entries


DENSE_LEVELS = (0, 3, 9, 12)


def dense_rows(data: bytes, rng, rows: int = 4):
    """``rows`` 64 KB rows of the mix, one from each quarter in turn, staged
    as the dense encoder takes them (uint8 [rows, 64 KB + 1024] on the
    CPU) with their lengths."""
    import torch

    q = len(data) // 4
    bufs = torch.zeros((rows, BLOCK + 1024), dtype=torch.uint8)
    for i in range(rows):
        at = (i % 4) * q + int(rng.integers(0, q - BLOCK))
        bufs[i, :BLOCK] = torch.frombuffer(bytearray(data[at:at + BLOCK]),
                                           dtype=torch.uint8)
    return bufs, torch.full((rows,), BLOCK, dtype=torch.int32)


def hold_dense_rows(data: bytes, rng, dev) -> dict:
    """X1 at levels 0, 3, 9 and 12 and X2 on its output and a flipped copy
    of one row, on ``dev`` against the same functions on the CPU: out bytes,
    lengths and error counts.  Returns each one's max_abs_err."""
    import torch
    from lz4_tpu_torch.ops import encode_dense
    from lz4_tpu_torch.parallel import blocks as pb

    bufs, lens = dense_rows(data, rng)
    worst = {"X1": 0, "X2": 0}
    streams = []
    for level in DENSE_LEVELS:
        depth = encode_dense.level_to_depth(level)
        got = pb.batched_encode(bufs.to(dev), lens.to(dev), BLOCK, depth)
        want = pb.batched_encode(bufs, lens, BLOCK, depth)
        worst["X1"] = max(worst["X1"], _max_abs_err(got, want))
        out, olens = want
        streams += [out[i, :int(olens[i])].numpy().tobytes() for i in range(len(lens))]
    bad = bytearray(streams[0])
    bad[len(bad) // 3] ^= 0x10
    streams.append(bytes(bad))
    comps = torch.zeros((len(streams), pb.comp_capacity(BLOCK)), dtype=torch.uint8)
    for i, s in enumerate(streams):
        comps[i, :len(s)] = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    clens = torch.tensor([len(s) for s in streams], dtype=torch.int32)
    got = pb.batched_decode(comps.to(dev), clens.to(dev), BLOCK)
    want = pb.batched_decode(comps, clens, BLOCK)
    worst["X2"] = _max_abs_err(got, want)
    out, olens, errs = (t.cpu() for t in got)
    for i in range(len(streams) - 1):
        _require(int(errs[i]) == 0 and int(olens[i]) == BLOCK
                 and torch.equal(out[i], bufs[i % len(lens), :BLOCK]),
                 f"X2 did not decode X1's row {i}")
    _require(worst == {"X1": 0, "X2": 0}, f"the dense codecs on the card differ "
             f"from their CPU run: {worst}")
    return worst


def unbounded_decodes(rng, dev) -> list:
    """`block.decode` with no bound on ``dev`` of three blocks that decode
    only at the first, second and third of X2's output caps (4, 32 and 255
    times the block's length): each equal to its payload and to the CPU's,
    and tried at exactly k + 1 caps.  Returns each one's sizes and time."""
    from lz4_tpu_torch import block
    from lz4_tpu_torch.ops import decode_dense
    from lz4_tpu_torch.ops.common import bucket

    noise = rng.integers(0, 256, 1900, dtype=np.uint8).tobytes()
    got = []
    for k, zeros in enumerate((0, 30000, 300000)):
        raw = noise + bytes(zeros)
        comp = block.encode(raw, device=dev)
        caps = sorted({bucket(max(64, len(comp) * f)) for f in (4, 32, 255)})
        _require(len(caps) == 3 and (k == 0 or caps[k - 1] < len(raw)) and len(raw) <= caps[k],
                 f"block {k} does not need cap {k} of {caps}")
        decode_dense.decode_block_fixed.launches = 0
        t0 = time.perf_counter()
        back = block.decode(comp, device=dev)
        seconds = time.perf_counter() - t0
        tries = decode_dense.decode_block_fixed.launches
        _require(back == raw and tries == k + 1,
                 f"unbounded decode {k}: exact {back == raw}, {tries} caps tried")
        _require(block.decode(comp, device="cpu") == raw, f"unbounded decode {k} on the CPU")
        got.append({"comp_bytes": len(comp), "bytes": len(raw), "caps": caps,
                    "caps_tried": tries, "s": seconds})
    return got


def _dense_counts():
    from lz4_tpu_torch.ops import chain, decode_dense, encode_dense

    return (encode_dense.encode_block_fixed, decode_dense.decode_block_fixed,
            chain.materialize_chain)


def dense_mesh_path(data: bytes, dev):
    """`frame.compress/decompress(mesh=make_mesh([dev, dev]))` at FAST
    independent 64 KB over ``data``: a warm-up, then three timed round
    trips, the counts set to 0 just before the first and read just after
    it (X1, X2 and X3 must run, kernels B's and A's wrappers must not);
    exact and deterministic, and the frame of the first 1 MiB equal to the
    same call's on a mesh of two CPU devices.  Returns (launches, e2e)."""
    import torch
    from lz4_tpu_torch import frame, parallel
    from lz4_tpu_torch.ops import decode, encode

    mesh = parallel.make_mesh([dev, dev])
    settings = frame.EncoderSettings(chain_blocks=False)
    warm = data[:4 * BLOCK]
    _require(frame.decompress(frame.compress(warm, settings, mesh=mesh), mesh=mesh) == warm,
             "mesh warm-up round trip")
    counts = _dense_counts()
    idle = (encode.encode_blocks, decode.decode_blocks)
    for fn in counts + idle:
        fn.launches = 0
    times, blob, launches = [], None, None
    for _ in range(3):
        t0 = time.perf_counter()
        b = frame.compress(data, settings, mesh=mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = frame.decompress(b, mesh=mesh)
        times.append((t1 - t0, time.perf_counter() - t1))
        if launches is None:
            launches = {fn.__name__: fn.launches for fn in counts + idle}
        _require(back == data, "mesh round trip is not exact")
        _require(blob is None or b == blob, "mesh compress is not deterministic")
        blob = b
    for fn in counts:
        _require(launches[fn.__name__] > 0, f"mesh path never launched {fn.__name__}")
    for fn in idle:
        _require(launches[fn.__name__] == 0, f"mesh path launched {fn.__name__}")
    head = data[:1 << 20]
    cpu_mesh = parallel.make_mesh(["cpu", "cpu"])
    _require(frame.compress(head, settings, mesh=mesh)
             == frame.compress(head, settings, mesh=cpu_mesh),
             "the card's mesh frame differs from the CPU mesh's")
    c_s = sorted(t[0] for t in times)[1]
    d_s = sorted(t[1] for t in times)[1]
    return launches, {
        "bytes": len(data), "frame_bytes": len(blob), "mesh": [str(d) for d in mesh.devices],
        "compress_s": [t[0] for t in times], "decompress_s": [t[1] for t in times],
        "compress_GBps_median": len(data) / c_s / 1e9,
        "decompress_GBps_median": len(data) / d_s / 1e9,
    }


def _peak_bytes(fn) -> int:
    """The device memory ``fn()`` takes above what was allocated before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def dense_group_times(data: bytes, dev, launches: dict, worst: dict) -> list:
    """X1, X2 and X3 timed on one row group of the mesh path's shapes (CUDA
    events, a warm-up first), with each group's peak device memory beside
    its estimate and each one's byte bound: the rows read once and the
    output written once over 3.35 TB/s."""
    import torch
    from lz4_tpu_torch import parallel
    from lz4_tpu_torch.constants import compress_bound
    from lz4_tpu_torch.ops import chain
    from lz4_tpu_torch.ops.common import align1024
    from lz4_tpu_torch.parallel import blocks as pb

    enc_rows = pb.group_rows(pb._encode_row_bytes(BLOCK, 1))
    bufs, lens = pb.split_blocks(data[:enc_rows * BLOCK], BLOCK)
    bufs, lens = bufs.to(dev), lens.to(dev)
    x1_ms = _cuda_ms(lambda: pb.batched_encode(bufs, lens, BLOCK, 1), 3)
    x1_peak = _peak_bytes(lambda: pb.batched_encode(bufs, lens, BLOCK, 1))
    cap = pb.comp_capacity(BLOCK)
    dec_rows = pb.group_rows(pb._decode_row_bytes(cap, BLOCK))
    blocks = parallel.encode_blocks(data[:dec_rows * BLOCK], BLOCK,
                                    mesh=parallel.make_mesh([dev]))
    comps = torch.zeros((len(blocks), cap), dtype=torch.uint8)
    for i, b in enumerate(blocks):
        comps[i, :len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    comps = comps.to(dev)
    clens = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=dev)
    x2_ms = _cuda_ms(lambda: pb.batched_decode(comps, clens, BLOCK), 3)
    x2_peak = _peak_bytes(lambda: pb.batched_decode(comps, clens, BLOCK))
    # X3's work does not depend on its data: the same gathers for any nxt
    shapes = {"X1": (enc_rows, BLOCK + 1024, BLOCK // 4 + 4),
              "X2": (dec_rows, cap, cap // 3 + 2)}
    x3 = {}
    for owner, (rows, m, steps) in shapes.items():
        nxt = (torch.arange(m, dtype=torch.int32, device=dev) + 1).clamp(max=m - 1)
        nxt = nxt.expand(rows, m).contiguous()
        out_w = 1 << max(1, (steps - 1).bit_length())
        x3[owner] = (_cuda_ms(lambda: chain.materialize_chain(nxt, steps), 3),
                     4 * rows * (m + out_w))
    ocap = align1024(compress_bound(BLOCK))
    entry = {"route": "torch", "bound_by": "bytes", "library_ms": None}
    return [
        {"name": "X1 encode_block_fixed", **entry,
         "source": "lz4_tpu_torch/ops/encode_dense.py",
         "replaces": "lz4_tpu/ops/encode_jax.py:307", "rows_per_group": enc_rows,
         "ms": x1_ms, "bound_ms": enc_rows * (BLOCK + 1024 + ocap) / HBM_BYTES_PER_S * 1e3,
         "launches": launches["encode_block_fixed"], "max_abs_err": worst["X1"],
         "peak_bytes_per_row": x1_peak / enc_rows,
         "estimate_bytes_per_row": pb._encode_row_bytes(BLOCK, 1)},
        {"name": "X2 decode_block_fixed", **entry,
         "source": "lz4_tpu_torch/ops/decode_dense.py",
         "replaces": "lz4_tpu/ops/decode_jax.py:195", "rows_per_group": dec_rows,
         "ms": x2_ms,
         "bound_ms": (int(clens.sum()) + dec_rows * BLOCK) / HBM_BYTES_PER_S * 1e3,
         "launches": launches["decode_block_fixed"], "max_abs_err": worst["X2"],
         "peak_bytes_per_row": x2_peak / dec_rows,
         "estimate_bytes_per_row": pb._decode_row_bytes(cap, BLOCK)},
        *({"name": f"X3 materialize_chain (in {owner})", **entry,
           "source": "lz4_tpu_torch/ops/chain.py",
           "replaces": "lz4_tpu/ops/chain.py:29", "rows_per_group": shapes[owner][0],
           "ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "launches": launches["materialize_chain"],
           "max_abs_err": max(worst.values())}
          for owner, (ms, nbytes) in x3.items()),
    ]


MULTIHOST_WORKER = r"""
import os, sys
sys.path.insert(0, os.getcwd())
from lz4_tpu_torch.frame import EncoderSettings
from lz4_tpu_torch.parallel import multihost
import torch.distributed as dist
assert multihost.init_from_env()
import random
data = random.Random(77).randbytes(9_000) * 40  # tests/test_multihost.py's payload
out = os.environ["LZ4TPU_SMOKE_OUT"] + f".{dist.get_rank()}"
blob = multihost.compress_distributed(data, block_size=65536, level=0)
assert multihost.decompress_distributed(blob) == data
chained = multihost.compress_distributed(
    data, settings=EncoderSettings(chain_blocks=True, block_size=65536))
with open(out, "wb") as f:
    f.write(blob)
with open(out + ".chained", "wb") as f:
    f.write(chained)
dist.destroy_process_group()
"""


def multihost_pair(dev) -> dict:
    """`multihost.compress_distributed` and `decompress_distributed` in two
    processes on the card (gloo on localhost; NCCL refuses two ranks on
    one card), on the 360 KB payload of tests/test_multihost.py: both
    processes' frames, independent and chained, equal this process's
    single-process frames on ``dev``, and the distributed decode returns
    the payload.  Each process has a time limit and is stopped on the way
    out."""
    import socket
    import tempfile
    from lz4_tpu_torch import frame

    data = random.Random(77).randbytes(9_000) * 40
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame")
        procs = [subprocess.Popen(
            [sys.executable, "-c", MULTIHOST_WORKER],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, LZ4TPU_COORDINATOR=f"127.0.0.1:{port}",
                     LZ4TPU_NUM_PROCESSES="2", LZ4TPU_PROCESS_ID=str(rank),
                     LZ4TPU_SMOKE_OUT=out),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=180)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, p in enumerate(procs):
            _require(p.returncode == 0,
                     f"multihost process {rank} failed:\n{logs[rank][-2000:]}")
        blobs = [open(f"{out}.{r}", "rb").read() for r in range(2)]
        chained = [open(f"{out}.{r}.chained", "rb").read() for r in range(2)]
    seconds = time.perf_counter() - t0
    single = frame.compress(data, frame.EncoderSettings(
        chain_blocks=False, block_size=BLOCK), device=dev)
    single_chained = frame.compress(data, frame.EncoderSettings(
        chain_blocks=True, block_size=BLOCK), device=dev)
    _require(blobs[0] == blobs[1] == single,
             "the distributed frame differs from the single-process frame")
    _require(chained[0] == chained[1] == single_chained,
             "the distributed chained frame differs from the single-process frame")
    _require(frame.decompress(chained[0], device=dev) == data, "chained round trip")
    return {"processes": 2, "backend": "gloo", "bytes": len(data),
            "frame_bytes": len(single), "chained_frame_bytes": len(single_chained),
            "s": seconds}


def phase_dense(data: bytes, rng, dev):
    """The dense codecs X1-X3 and their callers on the card: X1/X2 held to
    their CPU run (`hold_dense_rows`), the mesh path (`dense_mesh_path`),
    each timed on a row group (`dense_group_times`), unbounded
    `block.decode`s (`unbounded_decodes`) and two processes over gloo
    (`multihost_pair`).  Returns the `dense` line's object."""
    t0 = time.perf_counter()
    worst = hold_dense_rows(data, rng, dev)
    launches, e2e = dense_mesh_path(data, dev)
    entries = dense_group_times(data, dev, launches, worst)
    unbounded = unbounded_decodes(rng, dev)
    pair = multihost_pair(dev)
    seconds = time.perf_counter() - t0
    print(f"[dense] X1/X2 equal to their CPU run, mesh round trip exact "
          f"({e2e['compress_GBps_median']:.4f} / {e2e['decompress_GBps_median']:.4f} "
          f"GB/s), unbounded decodes and two processes exact, in {seconds:.1f} s")
    return {"mesh_e2e": e2e, "mesh_launches": launches, "x": entries,
            "unbounded_decode": unbounded, "multihost": pair, "seconds": seconds}


CONTINUE = dict(geometry="canonical", content_checksum=True)  # kernel F's path


def continue_edge_frames(seed: int):
    """Kernel F's edge frames, by block size: [(block_size, [payloads])].
    Blocks of 10 bytes (every block under 13 bytes: literals, the table
    untouched); of 4,096 bytes with a block of random bytes (stored raw,
    its inserts carried), a run, records and a last block of 7 bytes; of
    64 KB with a noise block, 64 KB of zeros, a last block of 12 bytes, and
    an exact multiple of the block size (these three sizes with the window
    staged in shared memory); of 256 KB (the window read from the payload)
    over the four quarters of the mix and a last block of 5 bytes."""
    corpus = make_corpus(1 << 20, seed + 7)
    q = len(corpus) // 4
    text, records, runs = corpus[:q], corpus[q:2 * q], corpus[2 * q:3 * q]
    rng = np.random.default_rng(seed + 7)
    noise = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    return [
        (10, [text[:1000] + runs[:503]]),
        (4096, [text[:5 * 4096] + noise[:4096] + runs[:8192] + records[:4096] + text[:7]]),
        (BLOCK, [text[:2 * BLOCK] + noise + bytes(BLOCK) + records[:BLOCK] + runs[:12],
                 corpus[:4 * BLOCK]]),
        (4 * BLOCK, [corpus + runs[:5]]),
    ]


def _continue_warp(payload: bytes, block_size: int):
    """The warp model of kernel F over one frame, in a worker: (blocks,
    each block's [probe_steps, sequences], seconds)."""
    from lz4_tpu_torch.ops import encode_continue

    t0 = time.perf_counter()
    steps = []
    blocks = encode_continue.continue_blocks_warp(payload, block_size, steps=steps)
    return blocks, [[c["probe_steps"], c["sequences"]] for c in steps], \
        time.perf_counter() - t0


def _continue_rows(out, clens) -> list:
    out, clens = out.cpu(), clens.cpu()
    return [out[k, :int(clens[k])].numpy().tobytes() for k in range(clens.numel())]


# (max_rounds, blocks a window) of each run of `hold_continue_rounds`: the
# default, the serial tail alone, one round, and windows of 5 blocks
CONTINUE_RUNS = ((None, None), (0, None), (1, None), (None, 5))


@contextlib.contextmanager
def _continue_window(blocks):
    """Kernel F and its model with windows of ``blocks`` blocks (None: as
    they are), for the `with` block."""
    from lz4_tpu_torch.ops import encode_continue

    was = encode_continue.WINDOW_BLOCKS
    encode_continue.WINDOW_BLOCKS = blocks or was
    try:
        yield
    finally:
        encode_continue.WINDOW_BLOCKS = was


def _continue_rounds(payload: bytes, block_size: int, max_rounds, window):
    """Kernel F's CPU model of its rounds over one frame, in a worker:
    (blocks, stats)."""
    from lz4_tpu_torch.ops import encode_continue

    stats: dict = {}
    with _continue_window(window):
        blocks = encode_continue.continue_blocks_rounds(
            payload, block_size, max_rounds=max_rounds, stats=stats)
    return blocks, stats


def _submit_continue_rounds(pool, payload: bytes, bs: int) -> list:
    """The CPU model of kernel F's rounds on one frame for each run of
    `CONTINUE_RUNS`, submitted to the worker pool."""
    from lz4_tpu_torch.ops import encode_continue

    return [(r, w, pool.submit(_continue_rounds, payload, bs,
                               encode_continue.MAX_ROUNDS if r is None else r, w))
            for r, w in CONTINUE_RUNS]


def hold_continue_rounds(payload_d, bs: int, models: list, serial: list) -> int:
    """Kernel F on one frame (on the card) at the default `max_rounds`, at 0
    (the serial tail alone), at 1 and in windows of 5 blocks, each against
    its model of rounds (``models``, `_submit_continue_rounds`: bytes; the
    rounds, the blocks walked in each, where the tail began, each block's
    walks) and against the serial plain version's blocks.  Returns the
    max_abs_err."""
    from lz4_tpu_torch.ops import encode_continue

    worst = 0
    for r, w, model in models:
        stats: dict = {}
        with _continue_window(w):
            rows = _continue_rows(*encode_continue.encode_continue(
                payload_d, bs, max_rounds=encode_continue.MAX_ROUNDS if r is None else r,
                stats=stats))
        blocks, want = model.result()
        worst = max(worst, int(rows != serial), int(blocks != serial), int(stats != want))
    return worst


def hold_continue_edges(dev, seed: int, pool) -> int:
    """Kernel F against its serial plain version (bytes, lengths) and its
    warp model (each block's probe steps and sequences) on the edge frames,
    one launch a frame, its rounds against their model at the default
    `max_rounds`, 0 and 1 (`hold_continue_rounds`), and `frame.compress` on
    the card against the CPU route's frame; the plain versions all
    submitted first.  Returns the max_abs_err."""
    import torch
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import encode_continue

    jobs = [(bs, p, _submit_timed(pool, encode_continue.continue_blocks_plain, p, bs),
             pool.submit(_continue_warp, p, bs), _submit_continue_rounds(pool, p, bs))
            for bs, payloads in continue_edge_frames(seed) for p in payloads]
    worst = 0
    for bs, p, serial, warp, models in jobs:
        payload_d = torch.frombuffer(bytearray(p), dtype=torch.uint8).to(dev)
        steps = torch.zeros((-(-len(p) // bs), 2), dtype=torch.int32, device=dev)
        rows = _continue_rows(*encode_continue.encode_continue(payload_d, bs, steps=steps))
        blocks, counts, _ = warp.result()
        serial = serial.result()[0]
        worst = max(worst, int(rows != serial), int(rows != blocks),
                    _max_abs_err([steps], [torch.tensor(counts, dtype=torch.int32)]),
                    hold_continue_rounds(payload_d, bs, models, serial))
        if bs != BLOCK:  # a frame's block size
            continue
        settings = frame.EncoderSettings(**CONTINUE)
        card = frame.compress(p, settings, device=dev)
        worst = max(worst, int(card != frame.compress(p, settings, device="cpu")))
        _require(frame.decompress(card, device=dev) == p,
                 "a canonical chained edge frame does not round-trip")
    _require(worst == 0, f"kernel F != its plain versions on the edge frames ({worst})")
    return worst


# the frames on which phase 18 times kernel F beside its 16 MiB frame of
# 64 KB blocks of the mix: (name, block size, data)
CONTINUE_FRAMES = (("noise", BLOCK, "noise"), ("256KiB", 256 << 10, "mix"),
                   ("4MiB", 4 << 20, "mix"))
# the caps at which phase 18 times F on that frame, beside the default and 0
CONTINUE_SWEEP = (16, 24, 64)


def noise_corpus(total_bytes: int, seed: int) -> bytes:
    """``total_bytes`` of the mix's noise quarter: 16 byte values, uniform."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, total_bytes) * 13).astype(np.uint8).tobytes()


def _view(data: bytes, lead: int, dev):
    """``data`` on the card as a view that starts ``lead`` bytes into its
    tensor."""
    import torch

    return torch.frombuffer(bytearray(bytes(lead) + data), dtype=torch.uint8).to(dev)[lead:]


def _continue_bound(steps, moved: int, clock: float) -> dict:
    """Kernel F's bound on one frame: the larger of its bytes (``moved``)
    over the card's memory rate and its slowest block's probe steps and
    sequences (``steps``, the kernel's counts) at 32 cycles each, the serial
    schedule's (every block's steps) beside it."""
    per_block = steps.sum(dim=1)
    total = steps.sum(dim=0).tolist()
    step_ms = int(per_block.max()) * L1_CYCLES / clock * 1e3
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(byte_ms, step_ms),
            "bound_by": "bytes" if byte_ms >= step_ms else "operations",
            "byte_bound_ms": byte_ms, "step_bound_ms": step_ms,
            "serial_step_bound_ms": (total[0] + total[1]) * L1_CYCLES / clock * 1e3,
            "slowest_block_steps": int(per_block.max()), "probe_steps": total[0],
            "sequences": total[1]}


def time_continue_frame(data: bytes, bs: int, dev, plain_f, clock: float) -> dict:
    """Kernel F on one frame of ``bs``-byte blocks: timed by CUDA events at
    the default `max_rounds`, at 0 (the serial schedule) and with no cap,
    the blocks at all three and on a view that starts 1 byte into its
    tensor held to the serial plain version (``plain_f``, a `_submit_timed`
    future); its rounds, re-walks by quarter and bound
    (`_continue_bound`)."""
    import torch
    from lz4_tpu_torch.ops import encode_continue

    view = _view(data, 1, dev)
    payload = view.clone()
    nb = -(-len(data) // bs)
    steps = torch.zeros((nb, 2), dtype=torch.int32, device=dev)

    def run(max_rounds=encode_continue.MAX_ROUNDS, src=payload, stats=None):
        return encode_continue.encode_continue(src, bs, steps=steps, max_rounds=max_rounds,
                                               stats=stats)

    stats: dict = {}
    out, clens = run(stats=stats)
    rows = _continue_rows(out, clens)
    ms = _cuda_ms(run, 1)
    serial_ms = _cuda_ms(lambda: run(0), 1)
    uncapped_ms = _cuda_ms(lambda: run(None), 1)
    plain = plain_f.result()[0]
    err = max(int(rows != plain), *(int(_continue_rows(*run(r)) != plain) for r in (0, None)),
              int(_continue_rows(*run(src=view)) != plain))
    bound = _continue_bound(steps, len(data) + int(clens.sum()) + 12 * nb, clock)
    return {"block_size": bs, "ms": ms, "serial_schedule_ms": serial_ms,
            "uncapped_ms": uncapped_ms, "max_abs_err": err,
            "rounds": stats["rounds"], "walked": stats["walked"], "tail": stats["tail"],
            "rewalks_max_walks_by_quarter": _by_quarter(stats["walks"]), **bound}


def _by_quarter(walks: list) -> list:
    """Per quarter of a frame of the mix: [its blocks' re-walks, the most
    walks of one of its blocks]."""
    q = len(walks) / 4
    parts = [walks[round(i * q):round((i + 1) * q)] for i in range(4)]
    return [[sum(w - 1 for w in part), max(part, default=0)] for part in parts]


def phase_canonical_chained(dev, seed: int, pool) -> tuple:
    """Canonical chained FAST frames (kernel F): the edge frames
    (`hold_continue_edges`), its rounds against their model on 1 MiB of
    the mix (`hold_continue_rounds`: every quarter in 16 blocks), then a
    16 MiB frame of 64 KB blocks with a content checksum through
    `frame.compress/decompress`, counts set to 0 just before and read just
    after (F once a compress, kernels D and B never, E and the chained
    decoder at least once), exact and deterministic over three runs after a
    warm-up; every block, at the default `max_rounds`, at 0 and at 1, equal
    to `continue_blocks_plain` over the whole frame (in a worker, timed: the
    entry's plain_ms) and to the warp model's, each block's steps to the
    warp model's, and every block of the first 1 MiB to
    `continue_blocks_plain` on that 1 MiB alone (block k reads nothing past
    its own end); the rounds and the re-walks by quarter of the mix; F
    timed by CUDA events at the default and at `max_rounds=0` (the serial
    schedule), its bound the larger of the bytes over 3.35 TB/s and the
    slowest block's probe steps and sequences (the kernel's own counts,
    held to the warp model's) at 32 cycles each, the serial schedule's
    bound (every block's steps) beside it; F at the caps of
    `CONTINUE_SWEEP`, on 1 MiB of the mix at views 1 and 3 bytes into
    their tensors, and on the frames of `CONTINUE_FRAMES`
    (`time_continue_frame`).  Returns (the `kernels` entry, the
    `canonical_chained` line)."""
    import torch
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import (
        decode_stream, encode, encode_continue, encode_stream, xxh32,
    )

    t0 = time.perf_counter()
    data = make_corpus(16 << 20, seed)
    plain_f = _submit_timed(pool, encode_continue.continue_blocks_plain, data, BLOCK)
    warp_f = pool.submit(_continue_warp, data, BLOCK)
    prefix_f = _submit_timed(pool, encode_continue.continue_blocks_plain, data[:1 << 20], BLOCK)
    mix = make_corpus(1 << 20, seed + 1)
    mix_f = (_submit_timed(pool, encode_continue.continue_blocks_plain, mix, BLOCK),
             _submit_continue_rounds(pool, mix, BLOCK))
    others = {"noise": noise_corpus(16 << 20, seed + 2), "mix": data}
    others_f = [(name, bs, others[kind],
                 _submit_timed(pool, encode_continue.continue_blocks_plain, others[kind], bs))
                for name, bs, kind in CONTINUE_FRAMES]
    edge_err = hold_continue_edges(dev, seed, pool)
    mix_plain = mix_f[0].result()[0]
    mix_err = max(hold_continue_rounds(_view(mix, 0, dev), BLOCK, mix_f[1], mix_plain),
                  *(int(_continue_rows(*encode_continue.encode_continue(
                      _view(mix, lead, dev), BLOCK)) != mix_plain) for lead in (1, 3)))
    settings = frame.EncoderSettings(**CONTINUE)
    launches, e2e = _round_trips(
        data, settings, dev,
        [encode_continue.encode_continue, decode_stream.decode_chain, xxh32.xxh32_windows],
        idle=(encode_stream.encode_blocks_stream, encode.encode_blocks))
    _require(launches["encode_continue"] == 1,
             f"a compress launched kernel F {launches['encode_continue']} times, not once")
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    nb = -(-len(data) // BLOCK)
    steps = torch.zeros((nb, 2), dtype=torch.int32, device=dev)

    def run(max_rounds=encode_continue.MAX_ROUNDS, stats=None):
        return encode_continue.encode_continue(payload, BLOCK, steps=steps,
                                               max_rounds=max_rounds, stats=stats)

    stats: dict = {}
    out, clens = run(stats=stats)
    rows = _continue_rows(out, clens)
    ms = _cuda_ms(run, 1)
    serial_ms = _cuda_ms(lambda: run(0), 1)
    sweep = {r: _cuda_ms(lambda: run(r), 1) for r in CONTINUE_SWEEP}
    sweep[encode_continue.MAX_ROUNDS] = ms
    capped = [_continue_rows(*run(r)) for r in (0, 1, *CONTINUE_SWEEP)]
    plain, plain_s = plain_f.result()
    wblocks, wsteps, _ = warp_f.result()
    prefix = prefix_f.result()[0]
    clock = float(_nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    frames = {name: time_continue_frame(payload_b, bs, dev, f, clock)
              for name, bs, payload_b, f in others_f}
    err = max(edge_err, mix_err, int(rows != plain), int(wblocks != plain),
              *(int(c != plain) for c in capped), int(rows[:len(prefix)] != prefix),
              _max_abs_err([steps], [torch.tensor(wsteps, dtype=torch.int32)]),
              *(f["max_abs_err"] for f in frames.values()))
    _require(err == 0, "kernel F's blocks != continue_blocks_plain's (the frame at max_rounds "
                       "default, 0, 1 and the sweep's, its first MiB, 1 MiB of the mix on "
                       "views at 0, 1 and 3 bytes, the edge frames, the noise, 256 KB and "
                       "4 MB frames)")
    # the payload read once, each block's bytes, length and two counts written once
    bound = _continue_bound(steps, len(data) + int(clens.sum()) + 12 * nb, clock)
    slowest, total = bound["slowest_block_steps"], [bound["probe_steps"], bound["sequences"]]
    serial_step_ms = bound["serial_step_bound_ms"]
    quarters = _by_quarter(stats["walks"])
    entry = {"name": "encode_continue", "route": "cuda",
             "source": "lz4_tpu_torch/ops/csrc/encode_continue.cu",
             "replaces": "lz4_tpu/frame/api.py:313", "shape": f"1 frame x {nb} x 64KiB",
             "launches": launches["encode_continue"], "max_abs_err": err, "ms": ms,
             "plain_ms": plain_s * 1e3, **bound, "serial_schedule_ms": serial_ms,
             "rounds": stats["rounds"], "walked": stats["walked"], "tail": stats["tail"],
             "rewalks_max_walks_by_quarter": quarters, "max_rounds_ms": sweep,
             "frames": frames, "library_ms": None}
    line = {**e2e, "launches": launches, "F_ms": ms, "F_serial_ms": serial_ms,
            "F_bound_ms": entry["bound_ms"], "F_serial_bound_ms": serial_step_ms,
            "rounds": stats["rounds"], "tail": stats["tail"],
            "rewalks_max_walks_by_quarter": quarters, "F_max_rounds_ms": sweep,
            "F_frames": {k: {x: f[x] for x in ("ms", "serial_schedule_ms", "uncapped_ms",
                                               "rounds", "tail", "bound_ms",
                                               "serial_step_bound_ms")}
                         for k, f in frames.items()},
            "seconds": time.perf_counter() - t0}
    print(f"[continue] 16 MiB canonical chained frame: round trip exact, deterministic, "
          f"launches {launches}; median {e2e['compress_GBps_median']:.4f} GB/s compress, "
          f"{e2e['decompress_GBps_median']:.4f} GB/s decompress; F {ms:.3f} ms in "
          f"{stats['rounds']} rounds (blocks walked per round {stats['walked']}, serial tail "
          f"from block {stats['tail']}; re-walks and most walks of a block by quarter "
          f"(text, records, runs, noise) {quarters}), {serial_ms:.3f} ms at max_rounds=0; "
          f"bound {entry['bound_ms']:.3f} ms (the slowest block's {slowest} steps; the "
          f"serial schedule's {total[0]} probe steps and {total[1]} sequences: "
          f"{serial_step_ms:.3f} ms); every block at max_rounds {encode_continue.MAX_ROUNDS}, "
          f"0 and 1, the first 1 MiB alone, and at those and in windows of 5 blocks 1 MiB "
          f"of the mix and the edge frames, equal to the plain versions (the serial one "
          f"{plain_s:.1f} s over the frame), "
          f"in {line['seconds']:.1f} s")
    print(f"[continue] F at max_rounds {sorted(sweep)}: "
          f"{[round(sweep[r], 3) for r in sorted(sweep)]} ms; "
          + "; ".join(f"{k} ({f['block_size']} B blocks): {f['ms']:.3f} ms in {f['rounds']} "
                      f"rounds (walked {f['walked']}, tail from {f['tail']}), "
                      f"{f['serial_schedule_ms']:.3f} at max_rounds=0, "
                      f"{f['uncapped_ms']:.3f} with no cap, bound "
                      f"{f['bound_ms']:.3f} (serial {f['serial_step_bound_ms']:.3f})"
                      for k, f in frames.items()))
    return entry, line


HASH5_EDGES = [0, 1, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x100000000, 0xFFFFFFFFFF,
               0x1122334455, 0xDEADBEEF01]


def hash5_vectors(seed: int) -> np.ndarray:
    """The 40-bit values of `experiments/tests/test_canon_hash32.py`: its 11
    edges, 20,000 values from default_rng(20260820), every low byte with 16
    tails from default_rng(7), the Pallas test's 4,096 values; then 2^20
    more from ``seed``."""
    parts = [np.array(HASH5_EDGES, np.uint64),
             np.random.default_rng(20260820).integers(0, 1 << 40, 20000, dtype=np.uint64)]
    tails = np.random.default_rng(7)
    parts += [(tails.integers(0, 1 << 32, 16, dtype=np.uint64) << np.uint64(8)) | np.uint64(b0)
              for b0 in range(256)]
    parts.append(np.random.default_rng(20260820).integers(0, 1 << 40, 4096, dtype=np.uint64))
    parts.append(np.random.default_rng(seed).integers(0, 1 << 40, 1 << 20, dtype=np.uint64))
    return np.concatenate(parts)


def _queued_ms(fn, iters: int) -> float:
    """The device time per call of a short kernel's wrapper that does not
    synchronise: CUDA events around ``iters`` calls queued behind a 25 ms
    device sleep, so that the card runs them back to back while the host is
    still queueing (no profiler: CUPTI drops such short launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_hash5(dev, seed: int) -> dict:
    """`hash5_rows` (the byU32 hash kernels D and F call) against its plain
    version on `hash5_vectors`, its launches counted from 0 over that
    call, timed by `_queued_ms`.  Returns the `kernels` entry."""
    import torch
    from lz4_tpu_torch.ops import encode_continue

    values = torch.from_numpy(hash5_vectors(seed))
    values_d = values.to(dev)
    encode_continue.hash5_rows.launches = 0
    got = encode_continue.hash5_rows(values_d)
    launches = encode_continue.hash5_rows.launches
    t0 = time.perf_counter()
    want = encode_continue.hash5_rows_plain(values)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_abs_err([got], [want])
    _require(err == 0 and launches == 1, f"hash5_rows != its plain version ({err})")
    ms = _queued_ms(lambda: encode_continue.hash5_rows(values_d), 20)
    n = values.numel()
    print(f"[hash5] hash5_rows over {n} values equal to its plain version: "
          f"{ms:.4f} ms of device time")
    return {"name": "hash5_rows", "route": "cuda",
            "source": "lz4_tpu_torch/ops/csrc/encode_continue.cu",
            "replaces": "experiments/tests/test_canon_hash32.py:90", "shape": f"{n} values",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 12 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None}


def _ubench_plain(name: str, n: int, seed: int):
    from lz4_tpu_torch.ops import ubench

    return ubench.plain(name, n, seed)


def phase_ubench(dev, seed: int, pool) -> dict:
    """Every micro-benchmark of `csrc/ubench.cu`: cycles per iteration as
    the slope of its loop's clock64() span between N1 and N2 iterations,
    its accumulators at N1 held to the plain version (in the pool).
    Returns the `ubench` line."""
    from lz4_tpu_torch.ops import ubench

    t0 = time.perf_counter()
    futures = {name: pool.submit(_ubench_plain, name, ubench.N1, seed)
               for name in ubench.BENCHES}
    got = {name: ubench.slope(name, seed, dev) for name in ubench.BENCHES}
    for name, f in futures.items():
        _require(got[name].pop("acc") == f.result(),
                 f"ubench {name}: the kernel's accumulators != the plain version's")
    line = {"N1": ubench.N1, "N2": ubench.N2,
            "sm_clock_max_MHz": float(_nvidia_smi("clocks.max.sm", "nounits")),
            "cycles_per_iter": {k: v["cycles_per_iter"] for k, v in got.items()},
            "spans": {k: [v["cycles_n1"], v["cycles_n2"]] for k, v in got.items()},
            "ubench_py_line": {k: v[1] for k, v in ubench.BENCHES.items()},
            "launches": dict(ubench.kernel_launches), "acc_equal": True,
            "seconds": time.perf_counter() - t0}
    print(f"[ubench] {len(got)} kernels, accumulators equal to the plain versions, "
          f"in {line['seconds']:.1f} s: " + ", ".join(
              f"{k} {v:.2f}" for k, v in line["cycles_per_iter"].items()))
    return line


def _nvidia_smi(query: str, *fmt: str) -> str:
    """The first card's `nvidia-smi --query-gpu` fields, as CSV."""
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader") + fmt)],
        capture_output=True, text=True, timeout=60,
    )
    _require(res.returncode == 0 and res.stdout.strip(), "nvidia-smi failed")
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    return _nvidia_smi("name,power.limit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=64, help="main-path payload, MiB")
    args = ap.parse_args(argv)
    faulthandler.enable()  # a fatal signal prints the Python stack
    sys.stdout.reconfigure(line_buffering=True)  # a crash loses no line

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lz4_tpu_torch import frame  # fails outside the repo

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    phase_build()
    t0 = time.perf_counter()
    data = make_corpus(args.mb << 20, args.seed)
    data16 = make_corpus(16 << 20, args.seed + 1)
    print(f"[data] {len(data)} + {len(data16)} bytes in "
          f"{time.perf_counter() - t0:.1f} s")
    enc_err, enc_outs = phase_encode(sample_rows(data, rng), dev)
    streams = enc_outs[("canonical", 1)] + enc_outs[("dense", 8)]
    dec_err = phase_decode(streams, rng, dev)
    stream_err, big = phase_encode_stream(data16, rng, dev)
    dec_err = max(dec_err, phase_decode_big(big, rng, dev))
    chain_err, chain_pass_err, chain_plain_ms, blob16 = phase_decode_chain(
        data16, rng, dev)
    launches, e2e = phase_main_path(data, dev)
    chained_launches, chained_e2e = phase_chained_path(data, dev)
    big_launches, big_e2e = phase_big_blocks(data, dev)
    with plain_pool() as pool:
        fast_err_d, fast_err_a = phase_fast_edges(data16, rng, dev, pool)
        fast_kernels, fast_summary = phase_fast_rows(data, dev, pool)
    print(json.dumps({"fast_rows": fast_summary,
                      "fast_edges_max_abs_err": {"D": fast_err_d, "A": fast_err_a}}))
    kernels = phase_times_stream(data16, blob16, chain_plain_ms, dev, data)
    kernels[-1]["pass_max_abs_err"] = chain_pass_err
    print(json.dumps(profile_path(
        data, dev, frame.EncoderSettings(chain_blocks=False),
        ("encode_windows", "decode_rows"))))
    print(json.dumps({"chained": profile_path(
        data, dev, frame.EncoderSettings(), ("encode_windows", "chain_parse", "chain_gather"))}))
    print(json.dumps({"big_blocks": profile_path(
        data, dev, frame.EncoderSettings(chain_blocks=False, block_size=1 << 20),
        ("encode_windows", "rows_gather"))}))
    launches.update(chained_launches)
    for k, err in zip(kernels, (stream_err, chain_err)):
        k["launches"] = launches[k["name"]]
        k["max_abs_err"] = err
    t0 = time.perf_counter()
    with plain_pool() as pool:
        xxh_windows, xxh_futures = xxh32_windows_in_pool(pool, data)
        hc_err = {"independent": phase_hc_encode(data, rng, dev, pool),
                  "chained": phase_hc_stream(data16, rng, dev, pool)}
        check_hc_frame(data16, dev, pool)
        print(f"[hc] kernels B and D held to their plain versions in "
              f"{time.perf_counter() - t0:.1f} s")
        xxh_kernels, host_xxh32_s = phase_xxh32(
            data, rng, dev, xxh_windows, xxh_futures)
    hc_launches, hc_e2e = phase_hc_paths(data16, dev)
    hc_kernels, hc_times = phase_hc_times(data16, dev, args.seed)
    cli_opt = {}
    with plain_pool() as pool:
        t0 = time.perf_counter()
        cli_hc_launches, cli_hc_e2e, cli_hc_kernels, cli_hc = phase_cli_hc(data, dev, pool)
        cli_hc["phase_s"] = time.perf_counter() - t0
        print(f"[lz4 -9] phase {cli_hc['phase_s']:.1f} s")
        for level in (10, 11):
            t0 = time.perf_counter()
            got = phase_cli_opt(data, dev, pool, level)
            hc_launches[f"lz4_{level}"] = got[0]
            cli_hc_kernels += got[2]
            cli_opt[f"lz4_{level}"] = {"e2e": got[1], **got[3],
                                       "phase_s": time.perf_counter() - t0}
            print(f"[lz4 -{level}] phase {cli_opt[f'lz4_{level}']['phase_s']:.1f} s")
    hc_launches["lz4_9"] = cli_hc_launches
    for k in hc_kernels + cli_hc_kernels:  # the serial HC arm: 0 on the L9 paths
        fn = k["name"].split(":")[0]
        k["launches"] = hc_launches[k.pop("path")][fn]
        k["max_abs_err"] = max(k["max_abs_err"], hc_err[k.pop("held")].get(fn, 0))
    kernels += hc_kernels + cli_hc_kernels
    print(json.dumps({"hc9": hc_times["L9"], "opt10": hc_times["L10"],
                      "opt11": hc_times["L11"], "opt12": hc_times["L12"]}))
    print(json.dumps({"opt10_memory": opt_memory(data16, dev)}))
    print(json.dumps({"e2e_hc_cli": cli_hc_e2e, "lz4_9": cli_hc, **cli_opt}))
    hc = ("opt_chain_walk", "hc_deltas_rows", "hc_seg_walks")
    opt = ("opt_chain_walk", "opt_matches_rows")
    print(json.dumps({"cli_hc": profile_path(
        data, dev, _cli_hc(), hc + ("rows_gather", "xxh32_windows"))}))
    print(json.dumps({"hc_L9_chained": profile_path(
        data16, dev, frame.EncoderSettings(compression_level=9), hc + ("chain_parse",))}))
    print(json.dumps({"hc_L10_independent": profile_path(
        data16, dev, frame.EncoderSettings(compression_level=10, chain_blocks=False),
        opt + ("opt_seg_walks", "decode_rows"))}))
    print(json.dumps({"hc_L12_independent": profile_path(
        data16, dev, frame.EncoderSettings(compression_level=12, chain_blocks=False),
        opt + ("opt_parse_rows", "decode_rows"))}))
    print(json.dumps({"hc_L12_chained": profile_path(
        data16, dev, frame.EncoderSettings(compression_level=12),
        opt + ("opt_parse_rows", "chain_parse"))}))
    print(json.dumps({"e2e": e2e, "e2e_chained": chained_e2e,
                      "e2e_big_blocks": big_e2e,
                      "big_blocks_launches": big_launches}))
    cs_launches, cs_e2e, cs_profiles = phase_checksum_paths(data, dev)
    st_launches, st_rates, st_kernels = phase_streaming(data, rng, dev)
    dense = phase_dense(data16, rng, dev)
    with plain_pool() as pool:
        continue_entry, continue_line = phase_canonical_chained(dev, args.seed, pool)
        hash5_entry = phase_hash5(dev, args.seed)
        ubench_line = phase_ubench(dev, args.seed, pool)
    for k in xxh_kernels:
        k["launches"] = cs_launches[k.pop("path")]["xxh32_windows"]
    kernels += xxh_kernels
    for k in fast_kernels:  # each shape's path: the main path, 1 MiB, CLI default
        name, _, label = k["name"].partition(":")
        counts = {"": launches, "1MiB": big_launches,
                  "4MiB": cs_launches["cli_default"]}[label]
        key = name
        if name.startswith("rows_"):  # each pass's own launches (rows_jump: rounds)
            counts = cs_launches["cli_default"]
        elif name == "decode_blocks":  # the passes: calls, each kernel's own beside
            k["kernel_launches"] = {p: counts[p] for p in ROW_PASSES}
        k["launches"] = counts[key]
        if name == "encode_blocks":
            k["max_abs_err"] = max(k["max_abs_err"], enc_err, fast_err_d)
        elif name in ("decode_rows", "decode_blocks") or name.startswith("rows_"):
            k["max_abs_err"] = max(k["max_abs_err"], dec_err, *fast_err_a.values())
        else:
            k["max_abs_err"] = max(k["max_abs_err"], fast_err_d, stream_err)
    kernels = fast_kernels + kernels + st_kernels + [continue_entry, hash5_entry]
    print(json.dumps({"cli_default": cs_profiles["cli_default"],
                      "independent_both": cs_profiles["independent_both"],
                      "chained_both": cs_profiles["chained_both"]}))
    print(json.dumps({"e2e_hc": hc_e2e, "hc_launches": hc_launches}))
    print(json.dumps({"e2e_checksums": cs_e2e, "checksum_launches": cs_launches,
                      "host_xxh32_4MiB_s": host_xxh32_s}))
    print(json.dumps({"e2e_streaming": st_rates, "streaming_launches": st_launches}))
    print(json.dumps({"dense": dense}))
    print(json.dumps({"canonical_chained": continue_line}))
    print(json.dumps({"ubench": ubench_line}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
