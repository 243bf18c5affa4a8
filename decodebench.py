#!/usr/bin/env python3
"""Kernel A's one-warp route (`decode.decode_rows`) on one card: this
tree's kernel against another tree's, in turns, and against the other
route (the parallel passes) at the row counts of the route rule.

    python3 decodebench.py [--parent DIR] [--seed 0] [--iters 5]

Shapes: N rows of 64 KB of the bench mix (`chip_smoke.make_corpus`, 64 MiB)
for N in `COUNTS`, spread evenly over the mix (one row: its first, text),
without and with a 64 KB dictionary (each row encoded with the 64 KB before
it as its dictionary), and rows decoded to a limit of 32 KB (a
`partial_decode`'s shape) at 1 and 1,024 rows; and both routes' wrapper
calls on rows of 128 KB and 1 MiB (the one-warp route's output in place).  Each kernel is timed with
CUDA events around `--iters` launches of its C entry point on arguments
already on the card, in the order parent, this tree, this tree, parent,
each output equal to this tree's.  Beside them: each route's
wrapper call (`decode._decode`, the host clock around the call and a
synchronize, the median of `--iters`): the times `decode.route`'s rule is
read from; both routes' outputs held equal, and one row of each shape to the
plain version; the step bound (the dependent steps of the plain model of
the schedule, `decode.schedule_steps`: window steps, and sequences and
length-extension bytes parsed one at a time; the slowest of at most
`STEP_ROWS` rows spread over the batch, at 32 cycles at the card's clock),
beside it one step per sequence and extension byte (`serial_step_ms`), and
the bytes bound.  `--parent` is an unpacked tree whose
`lz4_tpu_torch/ops/csrc/decode.cu` has the same one-warp entry point
(`lz4t_decode_warp(comps, stride, comp_lens, out, out_cap, dicts,
dict_lens, limits, lens, errs, nrows, stream)`), e.g.
`git archive HEAD~1 lz4_tpu_torch/ops/csrc | tar -x -C build/parent`.
Prints one JSON line per shape, then the card's name and power limit.
Needs a CUDA card.
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
COUNTS = (1, 4, 16, 64, 256, 1024)
# both routes' calls at these (out_cap, row counts)
ROUTE_SHAPES = ((BLOCK, (1, 2, 4, 8, 16, 64, 256, 1024)), (2 * BLOCK, (1, 16, 64, 128, 256, 512)),
                (4 * BLOCK, (16, 64, 128, 256)), (1 << 20, (1, 16, 64)))
# the step bound's rows: the slowest of at most this many, spread evenly
STEP_ROWS = 16
HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "decodebench"


def _build_parent(tree: Path) -> Path:
    from lz4_tpu_torch.ops import build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "parent_decode.so"
    proc = subprocess.run(
        [build._nvcc(), *build._FLAGS, "-o", str(lib),
         str(tree / "lz4_tpu_torch" / "ops" / "csrc" / "decode.cu")],
        capture_output=True, text=True)
    cs._require(proc.returncode == 0, f"nvcc failed for the parent:\n{proc.stdout}{proc.stderr}")
    return lib


def _rows(data: bytes, n: int, dev, with_dict: bool):
    """n rows of 64 KB spread over ``data``, compressed on the card (with
    the 64 KB before each as its dictionary): (comps, clens, dicts, dlens,
    raw rows) on the card."""
    import torch
    from lz4_tpu_torch.ops import encode, encode_stream
    from lz4_tpu_torch.parallel.blocks import comp_capacity

    nb = len(data) // BLOCK
    picks = [1 + k * (nb - 1) // n for k in range(n)] if with_dict else \
        [k * nb // n for k in range(n)]
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(nb, BLOCK)[picks]
    bufs = torch.zeros((n, BLOCK + 1024), dtype=torch.uint8)
    bufs[:, :BLOCK] = raw
    lens = torch.full((n,), BLOCK, dtype=torch.int32)
    dicts = dlens = None
    if with_dict:
        dicts = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(nb, BLOCK)[
            [p - 1 for p in picks]].contiguous().to(dev)
        dlens = torch.full((n,), BLOCK, dtype=torch.int32, device=dev)
        out, clens, _ = encode_stream.encode_blocks_stream(
            bufs.to(dev), lens.to(dev), BLOCK, dicts=dicts, dict_lens=dlens)
    else:
        out, clens, _ = encode.encode_blocks(bufs.to(dev), lens.to(dev), BLOCK)
    comps = torch.zeros((n, comp_capacity(BLOCK)), dtype=torch.uint8, device=dev)
    comps[:, :out.shape[1]] = out
    return comps, clens, dicts, dlens, raw


def _launcher(lib, comps, clens, dicts, dlens, limits):
    """A function that enqueues one launch of a built library's one-warp
    entry point, and its outputs."""
    import torch

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dev = comps.device
    n = comps.shape[0]
    out = torch.zeros((n, BLOCK), dtype=torch.uint8, device=dev)
    lens = torch.empty(n, dtype=torch.int32, device=dev)
    errs = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [comps.data_ptr(), comps.stride(0), clens.data_ptr(), out.data_ptr(), BLOCK,
            dicts.data_ptr() if dicts is not None else None,
            dlens.data_ptr() if dlens is not None else None,
            limits.data_ptr() if limits is not None else None,
            lens.data_ptr(), errs.data_ptr(), n, stream]
    lib.lz4t_decode_warp.argtypes = [p, ll, p, p, i, p, p, p, p, p, i, p]
    lib.lz4t_decode_warp.restype = ctypes.c_int

    def run():
        rc = lib.lz4t_decode_warp(*args)
        cs._require(rc == 0, f"CUDA error {rc}")

    return run, (out, lens, errs)


_call_ms = cs._call_ms


def bench_shape(name, comps, clens, dicts, dlens, limit, libs, dev, iters, clock) -> dict:
    import torch
    from lz4_tpu_torch.ops import decode

    n = comps.shape[0]
    limits = None if limit is None else torch.full((n,), limit, dtype=torch.int32, device=dev)
    runs = {k: _launcher(lib, comps, clens, dicts, dlens, limits) for k, lib in libs.items()}
    order = ["parent", "new", "new", "parent"] if "parent" in runs else ["new", "new"]
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(cs._cuda_ms(runs[k][0], iters))
    torch.cuda.synchronize()
    want = runs["new"][1]
    for k, (_, got) in runs.items():
        cs._require(cs._max_abs_err(got, want) == 0, f"{name}: {k} != this tree's kernel")
    lim_h = None if limits is None else limits.cpu()
    plain = decode.decode_blocks_plain(comps[:1].cpu(), clens[:1].cpu(), BLOCK,
                                       None if dicts is None else dicts[:1].cpu(),
                                       None if dlens is None else dlens[:1].cpu(),
                                       limits=None if lim_h is None else lim_h[:1])
    cs._require(cs._max_abs_err([t[:1] for t in want], plain) == 0,
                f"{name}: row 0 != the plain version")
    call = {"warp": _call_ms(lambda: decode._decode(
        "warp", comps, clens, BLOCK, dicts, dlens, limits=limits), iters)}
    if limits is None:
        rows = decode._decode("rows", comps, clens, BLOCK, dicts, dlens)[0]
        cs._require(cs._max_abs_err(rows, want) == 0, f"{name}: the passes != the one-warp route")
        call["rows"] = _call_ms(lambda: decode._decode(
            "rows", comps, clens, BLOCK, dicts, dlens), iters)
    comps_h, clens_h = comps.cpu(), clens.cpu()
    tallies = []
    for k in sorted({j * n // STEP_ROWS for j in range(STEP_ROWS)}):
        window = b"" if dicts is None else \
            dicts[k, BLOCK - int(dlens[k]):].cpu().numpy().tobytes()
        decode.decode_rows_model(comps_h[k, :int(clens_h[k])].numpy().tobytes(), BLOCK,
                                 window, -1 if limit is None else limit, counts=tallies)
    steps = max(decode.schedule_steps(t) for t in tallies)
    serial = max(t["sequences"] + t["extension_bytes"] for t in tallies)
    produced = int(want[1].to(torch.int64).sum())
    moved = int(clens_h.clamp(min=0).sum()) + produced + 8 * n \
        + (int(dlens.sum()) if dlens is not None else 0)
    step_ms = steps * cs.L1_CYCLES / clock * 1e3
    byte_ms = moved / cs.HBM_BYTES_PER_S * 1e3
    return {"shape": name, "rows": n, "ms": times, "call_ms": call,
            "rule": decode.route(n, BLOCK) if limit is None else "warp",
            "steps": steps, "step_bound_ms": step_ms, "byte_bound_ms": byte_ms,
            "serial_steps": serial, "serial_step_ms": serial * cs.L1_CYCLES / clock * 1e3,
            "bound_ms": max(step_ms, byte_ms),
            "bound_by": "operations" if step_ms >= byte_ms else "bytes",
            "max_abs_err": 0}


def bench_routes_above(data: bytes, size: int, counts, dev, iters: int) -> dict:
    """Both routes' wrapper calls on rows of ``size`` bytes of the mix
    (above 64 KB the one-warp route's output in place), held equal."""
    import torch
    from lz4_tpu_torch.ops import decode, encode_stream
    from lz4_tpu_torch.parallel.blocks import comp_capacity

    nb = len(data) // size
    out = {}
    for n in counts:
        if n > nb:
            break
        picks = [k * nb // n for k in range(n)]
        raw = torch.frombuffer(bytearray(data), dtype=torch.uint8)[:nb * size].view(nb, size)[picks]
        bufs = torch.zeros((n, size + 1024), dtype=torch.uint8)
        bufs[:, :size] = raw
        lens = torch.full((n,), size, dtype=torch.int32)
        enc, clens, _ = encode_stream.encode_blocks_stream(bufs.to(dev), lens.to(dev), size)
        comps = torch.zeros((n, comp_capacity(size)), dtype=torch.uint8, device=dev)
        comps[:, :enc.shape[1]] = enc
        warp = decode._decode("warp", comps, clens, size)[0]
        rows = decode._decode("rows", comps, clens, size)[0]
        cs._require(cs._max_abs_err(warp, rows) == 0 and torch.equal(warp[0].cpu(), raw),
                    f"{n} x {size}: the routes differ")
        out[n] = {"warp": _call_ms(lambda: decode._decode("warp", comps, clens, size), iters),
                  "rows": _call_ms(lambda: decode._decode("rows", comps, clens, size), iters),
                  "rule": decode.route(n, size)}
    return {"shape": f"routes at out_cap {size}", "call_ms": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--edges", action="store_true", help="hold the edge rows first")
    ap.add_argument("--routes", action="store_true",
                    help="only both routes' calls at 64 KB and above")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("decodebench: no CUDA device", file=sys.stderr)
        return 2
    from lz4_tpu_torch.ops import build, decode

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    log = build.build("decode", "encode_stream")["decode"]
    libs = {"new": decode._kernel()}
    if args.parent is not None:
        libs["parent"] = ctypes.CDLL(str(_build_parent(args.parent.resolve())))
    lines = log.splitlines()
    for j, line in enumerate(lines):  # each decode_rows form's registers and spills
        if "Compiling entry function" in line and "decode_rows" in line:
            for rest in lines[j + 1:j + 4]:
                if "Used" in rest or "spill" in rest:
                    print(f"[build] {line.split(chr(39))[1]}: {rest.split(':', 1)[-1].strip()}")
    print(f"[build] in {time.perf_counter() - t0:.1f} s; decode_rows: "
          f"{decode.warp_shared_bytes(BLOCK)} bytes of shared memory a CTA at 64 KB, "
          f"output in shared memory up to out_cap {decode.shared_out()}")
    if args.edges:
        t0 = time.perf_counter()
        cs.hold_warp_edges(dev, args.seed)
        print(f"[edges] in {time.perf_counter() - t0:.1f} s")
    clock = float(cs._nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    data = cs.make_corpus(64 << 20, args.seed)
    if args.routes:
        for size, counts in ROUTE_SHAPES:
            print(json.dumps(bench_routes_above(data, size, counts, dev, args.iters)))
        print(cs.card_line())
        return 0
    for with_dict in (False, True):
        for n in COUNTS:
            comps, clens, dicts, dlens, _ = _rows(data, n, dev, with_dict)
            name = f"{n}x64KB" + ("_dict" if with_dict else "")
            print(json.dumps(bench_shape(name, comps, clens, dicts, dlens, None, libs, dev,
                                         args.iters, clock)))
    for n in (1, 1024):
        comps, clens, dicts, dlens, _ = _rows(data, n, dev, False)
        print(json.dumps(bench_shape(f"{n}x64KB_limit32KB", comps, clens, None, None,
                                     BLOCK // 2, libs, dev, args.iters, clock)))
    for size, counts in ROUTE_SHAPES[1:]:
        print(json.dumps(bench_routes_above(data, size, counts, dev, args.iters)))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
