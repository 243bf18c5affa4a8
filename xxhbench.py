#!/usr/bin/env python3
"""Kernel E (xxHash32, `lz4_tpu_torch/ops/csrc/xxh32.cu`) on one card: this
tree's kernel against another tree's, in turns, at the three shapes the
checksummed paths give it, and the chain's instructions in its SASS.

    python3 xxhbench.py [--parent DIR] [--latency] [--iters 5]
                        [--e2e-parent FULL] [--e2e-mb 64] [--checksum-paths]
                        [--seed 0]

Shapes: 1,024 rows of 64 KB of the bench mix (`chip_smoke.make_corpus`,
64 MiB) as windows of one flat tensor (block checksums), the 64 MiB as one
window (a content checksum), and the streaming form (`lz4t_xxh32_stripes`)
on a 1 MiB update (a stream's content hash in 1 MiB writes).  Each kernel
is timed with CUDA events around ``--iters`` launches of its C entry point
on arguments already on the card, in the order parent, this tree, this
tree, parent, every output equal to this tree's and to the plain version.
Beside each time: the cycles a stripe (the time at the card's top SM clock
over the longest window's stripes) and the bound (the larger of the bytes
over 3.35 TB/s and the chain at `chip_smoke.CHAIN_CYCLES_PER_STRIPE`).
``--parent`` is an unpacked tree whose `lz4_tpu_torch/ops/csrc/xxh32.cu`
has the same C entry points, e.g. `git archive HEAD~1
lz4_tpu_torch/ops/csrc | tar -x -C build/parent`.  ``--latency`` times, on one
warp with `clock64`, dependent chains of a stripe's instructions as this
kernel and the one before it run them, and of an IMAD and an SHF alone.
``--e2e-parent FULL`` (a whole unpacked commit) times the checksummed
paths' round trips (the `lz4` CLI default, 64 KB independent and chained
with both checksums) and the same geometries without checksums, the
parent's tree and this one each in its own process, in turns.
``--checksum-paths`` builds every kernel and runs `chip_smoke.py`'s
checksum paths alone (`phase_checksum_paths` on 64 MiB of the mix: their
e2e rates, one profile of each and E's overlaps with D and the copies),
in a process that has traced nothing before.  The SASS (`cuobjdump -sass` on the
built library) is searched for the stripe loop: the longest run of stripes
whose carried register goes through exactly one IMAD by P1 and one SHF by
13 a stripe, with its first lines quoted.  Prints one JSON line per shape
and one for the SASS, then the card's name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

BLOCK = 65536
UPDATE = 1 << 20  # the streaming form's update
HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "xxhbench"
P1 = 2654435761


def _build(builds: dict) -> dict:
    """Each {name: source} compiled into its own library, one nvcc each,
    all started together: {name: library}."""
    from lz4_tpu_torch.ops import build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in builds.items():
        lib = OUT / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build._FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        cs._require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
    return {name: lib for name, (lib, _) in procs.items()}


# dependent chains of the card's integer instructions, one warp, timed with
# clock64: what a stripe's chain costs without loads (`--latency`)
LATENCY_SRC = r"""
#include <cstdint>
constexpr uint32_t kP1 = 2654435761u, kP2 = 2246822519u;
template <int K>
__global__ void chain(uint32_t* out, long long* cycles, int n, uint32_t seed) {
  uint32_t m[8], r = seed ^ threadIdx.x;
  for (int i = 0; i < 8; ++i) m[i] = seed * (2 * i + 1) + threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      const uint32_t w = m[k & 7];
      if (K == 0) r = __funnelshift_l(r * kP1 + w, r * kP1 + w, 13);  // this kernel's stripe
      if (K == 1) r = r * kP1 + w;                                    // an IMAD
      if (K == 2) r = __funnelshift_l(r, w, 13);                      // an SHF
      if (K == 3) {                                                   // the stripe before
        const uint32_t a = r + w * kP2;
        r = __funnelshift_l(a, a, 13) * kP1;
      }
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = r;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}
extern "C" int lz4t_chain(int k, int n, uint32_t seed, void* out, void* cycles) {
  uint32_t* o = static_cast<uint32_t*>(out);
  long long* c = static_cast<long long*>(cycles);
  if (k == 0) chain<0><<<1, 32>>>(o, c, n, seed);
  if (k == 1) chain<1><<<1, 32>>>(o, c, n, seed);
  if (k == 2) chain<2><<<1, 32>>>(o, c, n, seed);
  if (k == 3) chain<3><<<1, 32>>>(o, c, n, seed);
  return static_cast<int>(cudaGetLastError());
}
"""
# (ptxas folds the multiply by P1 of the stripe before, written as its
# kernel wrote it, into the next stripe's IMAD when the words are in
# registers: the same two instructions)
CHAINS = ("stripe: IMAD, SHF", "IMAD", "SHF", "stripe before, as written")


def bench_latency(dev) -> dict:
    """Cycles per step of each chain of `LATENCY_SRC`: the slope between
    1,000 and 2,000 iterations of 64 steps."""
    import torch

    src = OUT / "latency.cu"
    OUT.mkdir(parents=True, exist_ok=True)
    src.write_text(LATENCY_SRC)
    lib = ctypes.CDLL(str(_build({"latency": src})["latency"]))
    lib.lz4t_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                               ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty(32, dtype=torch.int32, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    res = {}
    for k, name in enumerate(CHAINS):
        got = {}
        for n in (1000, 2000):
            cs._require(lib.lz4t_chain(k, n, 12345, out.data_ptr(), cyc.data_ptr()) == 0,
                        "chain launch")
            torch.cuda.synchronize()
            got[n] = int(cyc.item())
        res[name] = (got[2000] - got[1000]) / (1000 * 64)
    return {"cycles_per_step": res}


def _load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn in (lib.lz4t_xxh32, lib.lz4t_xxh32_stripes):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _runner(lib, entry: str, flat, starts, lens, out):
    """A function that enqueues one launch of ``entry`` of ``lib``."""
    import torch

    stream = torch.cuda.current_stream(flat.device).cuda_stream
    fn = getattr(lib, entry)
    args = (flat.data_ptr(), starts.data_ptr(), lens.data_ptr(), out.data_ptr(),
            starts.numel(), stream)

    def run():
        rc = fn(*args)
        cs._require(rc == 0, f"{entry}: CUDA error {rc}")

    return run


def bench_shape(name, entry, flat, starts, lens, init, want, libs, iters, clock, moved,
                stripes) -> dict:
    """Each library's ``entry`` timed in turns on the same inputs, then run
    once more with its output set to ``init`` (the streaming form's
    accumulators are updated in place) and held to ``want``."""
    import torch

    outs = {k: init.clone() for k in libs}
    runs = {k: _runner(lib, entry, flat, starts, lens, outs[k]) for k, lib in libs.items()}
    order = ["parent", "new", "new", "parent"] if "parent" in runs else ["new", "new"]
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(cs._cuda_ms(runs[k], iters))
    for k, out in outs.items():  # once more from ``init``, held
        out.copy_(init)
        runs[k]()
    torch.cuda.synchronize()
    for k, out in outs.items():
        cs._require(torch.equal(out.cpu(), want), f"{name}: {k} != the plain version")
    chain_ms = stripes * cs.CHAIN_CYCLES_PER_STRIPE / clock * 1e3
    byte_ms = moved / cs.HBM_BYTES_PER_S * 1e3
    return {"shape": name, "ms": times,
            "cycles_per_stripe": {k: min(v) * 1e-3 * clock / stripes for k, v in times.items()},
            "chain_bound_ms": chain_ms, "byte_bound_ms": byte_ms,
            "bound_ms": max(chain_ms, byte_ms),
            "bound_by": "operations" if chain_ms >= byte_ms else "bytes", "max_abs_err": 0}


def sass_text(lib: Path) -> str:
    """`cuobjdump -sass` of a built library."""
    found = subprocess.run(["bash", "-c", "command -v cuobjdump"], capture_output=True,
                           text=True).stdout.strip() or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([found, "-sass", str(lib)], capture_output=True, text=True)
    cs._require(res.returncode == 0, f"cuobjdump failed: {res.stderr}")
    return res.stdout


def sass_chain(sass: str) -> dict:
    """The stripe loop in the SASS of each form of `xxh32_windows`: the
    longest run of stripes in which the carried register goes through one
    IMAD by P1 (adding the word's product) and then one SHF.L.W by 13, the
    SHF's result the next IMAD's operand, with the run's first lines."""
    funcs = re.split(r"\n\s*Function : ", sass)
    p1 = {hex(P1), f"-{hex((1 << 32) - P1)}"}  # as cuobjdump may print it
    out = {}
    for body in funcs[1:]:
        fname = body.split("\n", 1)[0].strip()
        if "xxh32_windows" not in fname:
            continue
        lines = [ln.split(";")[0].split("*/", 1)[-1].strip()
                 for ln in body.splitlines() if "/*" in ln and ";" in ln]
        best, run, start, best_start, carried = 0, 0, 0, 0, None
        i = 0
        while i < len(lines):
            ins = lines[i]
            m = re.match(r"(?:@!?P\d )?IMAD R(\d+), R(\d+), (\S+), R(\d+)", ins)
            if m and m.group(3).rstrip(",") in p1:
                dst, src = m.group(1), m.group(2)
                # the next instruction touching dst must be its SHF by 13
                k = next((k for k in range(i + 1, min(i + 12, len(lines)))
                          if re.search(rf"\bR{dst}\b", lines[k])), None)
                s = k is not None and re.match(
                    rf"(?:@!?P\d )?SHF\.L\.W\.U32(\.HI)? R(\d+), R{dst}, 0xd, R{dst}",
                    lines[k])
                if s:
                    if carried is not None and src == carried:
                        run += 1
                    else:
                        run, start = 1, i
                    carried = s.group(2)
                    if run > best:
                        best, best_start = run, start
            i += 1
        out[fname[:80]] = {"longest_run_of_stripes": best,
                           "lines": lines[best_start:best_start + 8]}
    return out


# one process's round trips of the checksummed paths and the same
# geometries without checksums, from the root of a tree (``sys.argv``: MiB,
# repetitions); prints one JSON line of GB/s medians
E2E_WORKER = r"""
import json, statistics, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from lz4_tpu_torch import frame

mb, reps = int(sys.argv[1]), int(sys.argv[2])
data = cs.make_corpus(mb << 20, 0)
paths = {
    "cli_default": cs._cli_default(),
    "independent_both": frame.EncoderSettings(chain_blocks=False, block_checksum=True,
                                              content_checksum=True),
    "chained_both": frame.EncoderSettings(block_checksum=True, content_checksum=True),
    "independent": frame.EncoderSettings(chain_blocks=False),
    "chained": frame.EncoderSettings(),
}
out = {}
for name, settings in paths.items():
    blob = frame.compress(data, settings)
    assert frame.decompress(blob) == data
    c, d = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = frame.compress(data, settings)
        t1 = time.perf_counter()
        back = frame.decompress(blob)
        d.append(time.perf_counter() - t1)
        c.append(t1 - t0)
        assert back == data
    out[name] = {"compress_GBps": len(data) / statistics.median(c) / 1e9,
                 "decompress_GBps": len(data) / statistics.median(d) / 1e9,
                 "frame_bytes": len(blob)}
print(json.dumps(out))
"""


def bench_e2e(parent_tree: Path, mb: int, reps: int) -> dict:
    """The checksummed paths' e2e rates, and the same geometries' without
    checksums, of the parent's whole tree and this one, each in its own
    process, in turns (parent, this tree, this tree, parent): each rate the
    median of ``reps`` round trips over ``mb`` MiB of the mix; frames of
    both trees equal."""
    runs = {"parent": [], "new": []}
    for k in ("parent", "new", "new", "parent"):
        tree = parent_tree if k == "parent" else HERE
        res = subprocess.run([sys.executable, "-c", E2E_WORKER, str(mb), str(reps)],
                             cwd=tree, capture_output=True, text=True)
        cs._require(res.returncode == 0, f"e2e worker ({k}) failed:\n{res.stderr[-3000:]}")
        runs[k].append(json.loads(res.stdout.strip().splitlines()[-1]))
    for name, got in runs["new"][0].items():
        cs._require(got["frame_bytes"] == runs["parent"][0][name]["frame_bytes"],
                    f"{name}: the trees' frames differ in length")
    return {"e2e_in_turns": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--e2e-parent", type=Path, default=None,
                    help="a whole unpacked parent tree: e2e rates in turns")
    ap.add_argument("--e2e-mb", type=int, default=64)
    ap.add_argument("--latency", action="store_true",
                    help="time dependent chains of the chain's instructions")
    ap.add_argument("--checksum-paths", action="store_true",
                    help="run chip_smoke's checksum paths alone, profiles included")
    ap.add_argument("--sass-out", type=Path, default=None,
                    help="write this tree's whole SASS of kernel E here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("xxhbench: no CUDA device", file=sys.stderr)
        return 2
    from lz4_tpu_torch.ops import build, xxh32

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    log = build.build("xxh32")["xxh32"]
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    new = build._library("xxh32")
    libs = {"new": _load(new)}
    builds = {}
    if args.parent is not None:
        builds["parent"] = args.parent.resolve() / "lz4_tpu_torch" / "ops" / "csrc" / "xxh32.cu"
    libs.update({name: _load(lib) for name, lib in _build(builds).items()})
    print(f"[build] in {time.perf_counter() - t0:.1f} s")
    sass = sass_text(new)
    if args.sass_out is not None:
        args.sass_out.parent.mkdir(parents=True, exist_ok=True)
        args.sass_out.write_text(sass)
    print(json.dumps({"sass": sass_chain(sass)}))
    if args.latency:
        print(json.dumps(bench_latency(dev)))

    clock = float(cs._nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    data = cs.make_corpus(64 << 20, args.seed)
    host = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    flat = host.to(dev)
    nb = len(data) // BLOCK
    i64 = dict(dtype=torch.int64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    # block checksums: 1,024 rows of 64 KB
    starts = torch.arange(nb, **i64) * BLOCK
    lens = torch.full((nb,), BLOCK, **i32)
    t1 = time.perf_counter()
    want = xxh32.xxh32_windows_plain(host, starts.cpu(), lens.cpu())
    print(f"[plain] rows in {time.perf_counter() - t1:.1f} s")
    print(json.dumps(bench_shape(
        f"{nb}x64KB", "lz4t_xxh32", flat, starts, lens, torch.empty(nb, **i32), want, libs,
        args.iters, clock, len(data) + 12 * nb, BLOCK // 16)))

    # a content checksum: the 64 MiB as one window
    t1 = time.perf_counter()
    want = xxh32.xxh32_windows_plain(host, [0], [len(data)])
    print(f"[plain] window in {time.perf_counter() - t1:.1f} s")
    print(json.dumps(bench_shape(
        "64MiB", "lz4t_xxh32", flat, torch.zeros(1, **i64), torch.full((1,), len(data), **i32),
        torch.empty(1, **i32), want, libs, args.iters, clock, len(data) + 16,
        len(data) // 16)))

    # a stream's update: 1 MiB from seeded accumulators, at byte 0 (a
    # stream written in 1 MiB calls) and at byte 9 (after a carried tail)
    accs = torch.tensor(xxh32._as_int32(xxh32._SEEDED), **i32)
    for start in (0, 9):
        want = xxh32.xxh32_stripes_plain(host, start, UPDATE, xxh32._SEEDED)
        print(json.dumps(bench_shape(
            f"stripes_1MiB_at_{start}", "lz4t_xxh32_stripes", flat,
            torch.full((1,), start, **i64), torch.full((1,), UPDATE, **i32), accs, want,
            libs, args.iters * 4, clock, UPDATE + 32, UPDATE // 16)))
    if args.e2e_parent is not None:
        print(json.dumps(bench_e2e(args.e2e_parent.resolve(), args.e2e_mb, 3)))
    if args.checksum_paths:
        cs.phase_build()
        launches, e2e, profiles = cs.phase_checksum_paths(data, dev)
        print(json.dumps({"checksum_paths": {"launches": launches, "e2e": e2e,
                                             "profiles": profiles}}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
