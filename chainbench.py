#!/usr/bin/env python3
"""The chain pass (`encode_opt.opt_chain`) on one card: this tree's
segmented kernels against another tree's chain kernel, in turns, at the
shapes the HC and OPT paths give it.

    python3 chainbench.py [--parent DIR] [--segments 8192,32768] [--seed 1]

Shapes: 16 MiB of the bench mix (`chip_smoke.make_corpus`) as 256
independent 64 KB rows and as 256 chained 128 KB windows, and 64 MiB as
16 rows of 4 MiB (`lz4 -9`/`-10`/`-11`).  Each kernel is timed with CUDA
events around launches of its C entry point on arguments already on the
card (`--iters` a time), in the order parent, this tree, each
`--segments` build of this tree, this tree, parent; each output equal to
this tree's.  Beside them: the wrapper's call (its row tables copied to
the card), the walk's and the join's device time (profiler), the sort
formulation (`chip_smoke.chain_by_sort`, `library_ms`, held equal once),
the bytes bound, the segment model's dependent steps
(`encode_opt.chain_steps`) and the one-warp schedule's 32-position steps
(`serial_step_ms`), and the device memory one call allocates at its peak.
`--parent` is an unpacked tree whose `lz4_tpu_torch/ops/csrc/encode_opt.cu`
has the one-warp-per-row entry point (`lz4t_opt_chain(base, starts, lens,
toff, prev, nrows, stream)`).  `--memory DIR` also reads, for the whole
tree DIR (an unpacked commit) and this one, each in a process of its own
with that tree's `chip_smoke.py`, the device memory a compress allocates
at its peak: `opt_memory` (level 10, 16 MiB, independent and chained) and
the `lz4 -9` path over 64 MiB.  Prints one JSON line per shape and tree,
then the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

BLOCK = 65536
HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "chainbench"


def _build(sources: dict) -> dict:
    """nvcc of each {name: (source, extra flags)} into `build/chainbench/`,
    all at once, with the port's flags.  Returns {name: library path}."""
    from lz4_tpu_torch.ops import build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, extra) in sources.items():
        lib = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build._FLAGS, *extra, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        cs._require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for j, line in enumerate(lines):  # each chain kernel's registers and spills
            if "Compiling entry function" in line and "opt_chain" in line:
                kernel = "walk" if "opt_chain_walk" in line else (
                    "join" if "opt_chain_join" in line else "rows")
                for rest in lines[j + 1:j + 4]:
                    if "Used" in rest or "spill" in rest:
                        print(f"[build] {name} opt_chain_{kernel}: {rest.split(':', 1)[-1].strip()}")
        libs[name] = lib
    return libs


def _shapes(seed: int):
    import torch

    data16 = cs.make_corpus(16 << 20, seed)
    data64 = cs.make_corpus(64 << 20, seed)
    p16 = torch.frombuffer(bytearray(data16), dtype=torch.uint8)
    p64 = torch.frombuffer(bytearray(data64), dtype=torch.uint8)
    nb = len(data16) // BLOCK
    st, _, wl = cs.chained_windows(len(data16), BLOCK)
    return {
        "independent_64KB": (p16, torch.arange(nb, dtype=torch.int64) * BLOCK,
                             torch.full((nb,), BLOCK, dtype=torch.int32)),
        "chained_128KB": (p16, st, wl),
        "rows_4MiB": (p64, torch.arange(16, dtype=torch.int64) * (4 << 20),
                      torch.full((16,), 4 << 20, dtype=torch.int32)),
    }


def _launcher(lib_path: Path, segment: int | None, base_d, st, ln, dev):
    """A function that enqueues one chain pass of a built library on the
    rows, its arguments already on the card, and the prev it fills
    (``segment`` None: the one-warp entry point)."""
    import torch
    from lz4_tpu_torch.ops import encode_opt

    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    toff, total = encode_opt.table_offsets(ln)
    st_d, ln_d, toff_d = st.to(dev), ln.to(dev), toff.to(dev)
    prev = torch.empty(total, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = len(ln)
    if segment is None:
        lib.lz4t_opt_chain.argtypes = [p, p, p, p, p, i, p]
        args = (base_d.data_ptr(), st_d.data_ptr(), ln_d.data_ptr(), toff_d.data_ptr(),
                prev.data_ptr(), nb, stream)
    else:
        lib.lz4t_opt_chain.argtypes = [p, p, p, p, p, p, p, p, i, i, p]
        lib.lz4t_opt_chain_segment.restype = ctypes.c_int
        cs._require(lib.lz4t_opt_chain_segment() == segment, f"{lib_path}: segment")
        segoff, tables = encode_opt.chain_tables(ln, segment)
        segoff_d = segoff.to(dev)
        scratch = torch.empty((2, max(tables, 1), encode_opt.CHAIN_HASHES), dtype=torch.int16,
                              device=dev)
        args = (base_d.data_ptr(), st_d.data_ptr(), ln_d.data_ptr(), toff_d.data_ptr(),
                segoff_d.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                prev.data_ptr(), nb, int(ln.max()), stream)
    held = [t for t in (st_d, ln_d, toff_d) + ((segoff_d, scratch) if segment else ())]

    def run(held=held):  # the arguments' tensors live as long as the launcher
        rc = lib.lz4t_opt_chain(*args)
        cs._require(rc == 0, f"{lib_path.name}: CUDA error {rc}")

    return run, prev


def _peak(fn, dev) -> int:
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - held
    del out
    return peak


def bench_shape(name, rows, libs, segments, dev, iters: int, clock: float) -> dict:
    import torch
    from lz4_tpu_torch.ops import encode_opt

    base, st, ln = rows
    st = torch.as_tensor(st, dtype=torch.int64)
    ln = torch.as_tensor(ln, dtype=torch.int32)
    base_d = base.to(dev)
    runs = {"parent": _launcher(libs["parent"], None, base_d, st, ln, dev)} if "parent" in libs \
        else {}
    runs["new"] = _launcher(libs["new"], encode_opt.CHAIN_SEGMENT, base_d, st, ln, dev)
    for s in segments:
        runs[f"S{s}"] = _launcher(libs[f"S{s}"], s, base_d, st, ln, dev)
    order = [k for k in runs if k != "parent"]
    order = (["parent"] if "parent" in runs else []) + order + order[::-1] \
        + (["parent"] if "parent" in runs else [])
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(cs._cuda_ms(runs[k][0], iters))
    want = runs["new"][1]
    for k, (_, prev) in runs.items():
        cs._require(torch.equal(prev, want), f"{name}: {k}'s prev != this tree's")
    wrapper = encode_opt.opt_chain(base_d, st, ln)
    torch.cuda.synchronize()
    cs._require(torch.equal(wrapper, want), f"{name}: opt_chain != the launch")
    sort = cs.chain_by_sort(base_d, st, ln)
    cs._require(torch.equal(sort, want), f"{name}: the sort formulation != the kernel")
    del wrapper, sort
    wrapper_ms = cs._cuda_ms(lambda: encode_opt.opt_chain(base_d, st, ln), iters)
    library_ms = cs._cuda_ms(lambda: cs.chain_by_sort(base_d, st, ln), iters)
    kernel_ms, seen = cs._device_ms_by(
        lambda: encode_opt.opt_chain(base_d, st, ln),
        lambda: {k: encode_opt.opt_chain.launches for k in ("opt_chain_walk", "opt_chain_join")},
        iters)
    total = int(ln.sum())
    longest = int(ln.max())
    moved = total + 4 * total + 20 * len(ln)
    walk, nseg = encode_opt.chain_steps(longest)
    step_ms = cs.L1_CYCLES / clock * 1e3
    out = {
        "shape": name, "rows": len(ln), "positions": total,
        "segment": encode_opt.CHAIN_SEGMENT,
        "ms": {k: v for k, v in times.items()},
        "wrapper_ms": wrapper_ms, "device_ms": kernel_ms, "profiled_launches": seen,
        "library_ms": library_ms,
        "bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "steps": walk + nseg, "step_bound_ms": (walk + nseg) * step_ms,
        "serial_step_ms": -(-longest // 32) * step_ms,
        "peak_bytes": {
            "new": _peak(lambda: encode_opt.opt_chain(base_d, st, ln), dev),
            "library": _peak(lambda: cs.chain_by_sort(base_d, st, ln), dev),
            "prev_bytes": 4 * total,
            "scratch_bytes": sum(encode_opt.chain_scratch_bytes(int(n)) for n in ln)},
        "max_abs_err": 0,
    }
    for s in segments:
        walk_s, nseg_s = encode_opt.chain_steps(longest, s)
        out.setdefault("steps_at", {})[f"S{s}"] = walk_s + nseg_s
    return out


def memory_of(tree: Path, seed: int) -> dict:
    """In this process, from ``tree``'s own `chip_smoke.py` and package:
    the compress peaks of `opt_memory` and of the `lz4 -9` path."""
    import os

    import torch

    os.chdir(tree)
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules if m == "chip_smoke" or m.startswith("lz4_tpu_torch")]:
        del sys.modules[name]
    import chip_smoke as tree_cs

    dev = torch.device("cuda", 0)
    _, peak = tree_cs._compress_peak(tree_cs.make_corpus(64 << 20, seed), tree_cs._cli_hc(), dev)
    return {"tree": str(tree), "opt10_memory": tree_cs.opt_memory(
        tree_cs.make_corpus(16 << 20, seed), dev),
        "lz4_9_compress_peak_bytes": peak, "lz4_9_peak_per_payload_byte": peak / (64 << 20)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--memory", type=Path, default=None)
    ap.add_argument("--memory-of", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--segments", default="", help="other segment sizes to build and time")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chainbench: no CUDA device", file=sys.stderr)
        return 2
    from lz4_tpu_torch.ops import encode_opt

    if args.memory_of is not None:
        print(json.dumps(memory_of(args.memory_of.resolve(), args.seed)))
        return 0
    dev = torch.device("cuda", 0)
    src = HERE / "lz4_tpu_torch" / "ops" / "csrc" / "encode_opt.cu"
    segments = [int(x) for x in args.segments.split(",") if x]
    sources = {"new": (src, []),
               **{f"S{s}": (src, [f"-DLZ4T_CHAIN_SEGMENT={s}"]) for s in segments}}
    if args.parent is not None:
        sources["parent"] = (args.parent / "lz4_tpu_torch" / "ops" / "csrc" / "encode_opt.cu", [])
    t0 = time.perf_counter()
    libs = _build(sources)
    cs._require(encode_opt.chain_segment() == encode_opt.CHAIN_SEGMENT,
                "encode_opt.CHAIN_SEGMENT differs from the kernel's")
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s; the walk's "
          f"shared memory {encode_opt.shared_bytes()['opt_chain']} bytes per CTA, "
          f"{encode_opt.chain_ctas_per_sm()} CTAs an SM")
    clock = float(cs._nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    for name, rows in _shapes(args.seed).items():
        print(json.dumps(bench_shape(name, rows, libs, segments, dev, args.iters, clock)))
    if args.memory is not None:
        for tree in (args.memory.resolve(), HERE):
            out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--memory-of",
                                  str(tree), "--seed", str(args.seed)],
                                 capture_output=True, text=True)
            cs._require(out.returncode == 0, f"memory of {tree}:\n{out.stderr[-2000:]}")
            print(out.stdout.strip().splitlines()[-1])
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
