#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`lz4_tpu_torch`) on one card.

    python3 chip_smoke.py [--seed N] [--mb 64]

Phases, each fatal on failure:
1. build both kernels from `lz4_tpu_torch/ops/csrc/` and print each
   one's registers and shared memory (`nvcc -Xptxas -v`);
2. kernel B (FAST encode) against its plain version on sampled 64 KB rows
   of every part of the data mix plus 0-, 1- and 13-byte rows, canonical
   and dense, acceleration 1 and 8: equal bytes, lengths and flags;
3. kernel A (decode) against its plain version on phase 2's output,
   sequence-writer streams (overlapping matches, dictionary reach, long
   length extensions) with known output, and rows with flipped bits:
   equal lengths, flags and bytes;
4. the main path: `frame.compress(data, EncoderSettings(chain_blocks=False))`
   and `frame.decompress` on --mb MiB (1,024 blocks of 64 KB at the
   default), with every launch count set to 0 just before and read just
   after; the round trip must be exact, and so must a 4 MiB frame with
   block and content checksums;
5. times: each kernel over the whole batch (CUDA events), its plain
   version per row, its bound (bytes moved over 3.35 TB/s), and the end to
   end compress and decompress rates.

Prints a `kernels` JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, without a CUDA card or without the package beside it.  The data is
made with numpy from --seed; no PyTorch call computes LZ4, so there is no
library time to compare with (library_ms is null).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
BLOCK = 65536


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
    from lz4_tpu_torch.ops import build, encode

    t0 = time.perf_counter()
    logs = build.build(*build.KERNEL_SOURCES)
    print(f"[build] {len(logs)} sources in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if ("ptxas" in line or "spill" in line) and "Compile" not in line:
                print(f"[build] {name}.cu: {line.strip()}")
    print("[build] decode.cu: dynamic shared memory 0 bytes per CTA")
    for geometry in ("canonical", "dense"):
        print(f"[build] encode.cu: dynamic shared memory "
              f"{encode.shared_bytes(geometry)} bytes per CTA ({geometry})")


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
        torch.cuda.synchronize()
        want = decode.decode_blocks_plain(comps, clens, out_cap)
        err = _max_abs_err(got, want)
        _require(err == 0, f"decode out_cap={out_cap}: kernel != plain")
        worst = max(worst, err)
        print(f"[decode] out_cap={out_cap}: {len(rows)} rows equal "
              f"({int((want[2] != 0).sum())} flagged), flips {len(flipped)}")
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
    got = decode.decode_blocks(comps.to(dev), clens.to(dev), BLOCK, dicts.to(dev), dlens.to(dev))
    torch.cuda.synchronize()
    want = decode.decode_blocks_plain(comps, clens, BLOCK, dicts, dlens)
    err = _max_abs_err(got, want)
    _require(err == 0, "decode with dictionaries: kernel != plain")
    worst = max(worst, err)
    out, lens, errs = (t.cpu() for t in got)
    for i, o in enumerate(expect):
        _require(int(errs[i]) == 0 and out[i, :int(lens[i])].numpy().tobytes() == o,
                 f"sequence-writer row {i} did not decode to its expected bytes")
    print(f"[decode] {len(synth)} sequence-writer rows with dictionaries equal "
          f"and exact")
    return worst


def phase_main_path(data: bytes, dev):
    from lz4_tpu_torch import frame
    from lz4_tpu_torch.ops import decode, encode

    settings = frame.EncoderSettings(chain_blocks=False)
    warm = frame.compress(data[:4 * BLOCK], settings, device=dev)
    _require(frame.decompress(warm, device=dev) == data[:4 * BLOCK], "warm-up round trip")
    encode.encode_blocks.launches = 0
    decode.decode_blocks.launches = 0
    t0 = time.perf_counter()
    blob = frame.compress(data, settings, device=dev)
    t1 = time.perf_counter()
    back = frame.decompress(blob, device=dev)
    t2 = time.perf_counter()
    launches = {"encode_blocks": encode.encode_blocks.launches,
                "decode_blocks": decode.decode_blocks.launches}
    _require(back == data, "main path round trip is not exact")
    for name, n in launches.items():
        _require(n > 0, f"main path never launched {name}")
    times = [(t1 - t0, t2 - t1)]
    for _ in range(2):
        t0 = time.perf_counter()
        b2 = frame.compress(data, settings, device=dev)
        t1 = time.perf_counter()
        frame.decompress(b2, device=dev)
        times.append((t1 - t0, time.perf_counter() - t1))
        _require(b2 == blob, "compress is not deterministic")
    print(f"[main] {len(data)} bytes -> {len(blob)} bytes "
          f"(ratio {len(data) / len(blob):.4f}), round trip exact, "
          f"launches {launches}")
    checked = frame.EncoderSettings(chain_blocks=False, block_checksum=True,
                                    content_checksum=True)
    small = data[:4 << 20]
    _require(frame.decompress(frame.compress(small, checked, device=dev),
                              device=dev) == small,
             "4 MiB checksummed round trip is not exact")
    print("[main] 4 MiB frame with block and content checksums: exact")
    c_s = sorted(t[0] for t in times)[1]
    d_s = sorted(t[1] for t in times)[1]
    return launches, {
        "bytes": len(data), "frame_bytes": len(blob),
        "compress_s": [t[0] for t in times], "decompress_s": [t[1] for t in times],
        "compress_GBps_median": len(data) / c_s / 1e9,
        "decompress_GBps_median": len(data) / d_s / 1e9,
    }


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


def phase_times(data: bytes, dev):
    import torch
    from lz4_tpu_torch.ops import decode, encode
    from lz4_tpu_torch.parallel.blocks import comp_capacity, split_blocks

    bufs, lens = split_blocks(data, BLOCK)
    nb = bufs.shape[0]
    bufs_d, lens_d = bufs.to(dev), lens.to(dev)
    out, clens, _ = encode.encode_blocks(bufs_d, lens_d, BLOCK)
    cap = comp_capacity(BLOCK)
    comps = torch.zeros((nb, cap), dtype=torch.uint8, device=dev)
    comps[:, :out.shape[1]] = out
    enc_ms = _cuda_ms(lambda: encode.encode_blocks(bufs_d, lens_d, BLOCK), 5)
    dec_ms = _cuda_ms(lambda: decode.decode_blocks(comps, clens, BLOCK), 5)
    # plain versions on one row of each quarter, scaled to the batch
    picks = [q * nb // 4 for q in range(4)]
    t0 = time.perf_counter()
    encode.encode_blocks_plain(bufs[picks], lens[picks], BLOCK)
    enc_plain_ms = (time.perf_counter() - t0) * 1e3 / len(picks) * nb
    comps_h, clens_h = comps[picks].cpu(), clens[picks].cpu()
    t0 = time.perf_counter()
    decode.decode_blocks_plain(comps_h, clens_h, BLOCK)
    dec_plain_ms = (time.perf_counter() - t0) * 1e3 / len(picks) * nb
    # bytes each function must move: the rows' real bytes read once and
    # written once, plus the int32 length and flag vectors
    raw, packed = int(lens.sum()), int(clens.sum())
    enc_bytes = raw + packed + 12 * nb
    dec_bytes = packed + raw + 12 * nb
    print(f"[times] encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms over {nb} rows "
          f"({raw} raw bytes, {packed} compressed)")
    return [
        {"name": "encode_blocks", "route": "cuda",
         "source": "lz4_tpu_torch/ops/csrc/encode.cu",
         "replaces": "lz4_tpu/ops/encode_pallas5.py:1922",
         "ms": enc_ms, "plain_ms": enc_plain_ms,
         "bound_ms": enc_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        {"name": "decode_blocks", "route": "cuda",
         "source": "lz4_tpu_torch/ops/csrc/decode.cu",
         "replaces": "lz4_tpu/ops/decode_pallas6.py:643",
         "ms": dec_ms, "plain_ms": dec_plain_ms,
         "bound_ms": dec_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
    ]


def profile_main_path(data: bytes, dev) -> dict:
    """Device time by name over one compress + decompress of the main path
    (torch.profiler), and the device's busy share of the host's wall time.
    A report, not a check: a profiler that cannot trace the card yields
    "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lz4_tpu_torch import frame

    settings = frame.EncoderSettings(chain_blocks=False)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            frame.decompress(frame.compress(data, settings, device=dev), device=dev)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        device_us = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device_us[e.key] = device_us.get(e.key, 0.0) + e.self_device_time_total
    except Exception as e:  # the report must not end the run
        return {"profile": f"not measured ({e!r})"}
    busy = sum(device_us.values())
    if not busy:
        return {"profile": "not measured (no device events)"}
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    return {"profile": {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                        "device_busy_share": busy / wall_us,
                        "device_ms_by_name": {k[:60]: v / 1e3 for k, v in top}}}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _require(res.returncode == 0 and res.stdout.strip(), "nvidia-smi failed")
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=64, help="main-path payload, MiB")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import lz4_tpu_torch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    phase_build()
    t0 = time.perf_counter()
    data = make_corpus(args.mb << 20, args.seed)
    print(f"[data] {len(data)} bytes in {time.perf_counter() - t0:.1f} s")
    enc_err, enc_outs = phase_encode(sample_rows(data, rng), dev)
    streams = enc_outs[("canonical", 1)] + enc_outs[("dense", 8)]
    dec_err = phase_decode(streams, rng, dev)
    launches, e2e = phase_main_path(data, dev)
    kernels = phase_times(data, dev)
    print(json.dumps(profile_main_path(data, dev)))
    for k, err in zip(kernels, (enc_err, dec_err)):
        k["launches"] = launches[k["name"]]
        k["max_abs_err"] = err
    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
