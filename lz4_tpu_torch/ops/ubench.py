"""Micro-benchmarks of the card's primitives (`csrc/ubench.cu`) and their
plain versions.

The Hopper counterpart of the TPU's `ubench.py` (`run`, its 20 kernels):
each benchmark is one loop of n dependent iterations whose cost per
iteration is the slope of the loop's clock64() span between N1 and N2
iterations (ubench.py:56-58), so that the launch and the setup cancel out.
Two primitives of this port's kernels are added: kernel E's stripe
(`xxh32_stripe`: four multiply-rotate-multiply chains) and kernel D's probe
step (`probe_step`: hash, shared table read, __match_any_sync,
__ballot_sync).  Each kernel returns its accumulators, one per thread; the
plain versions below compute the same values on the host, so that a run on
the card holds every loop to them (no loop can be compiled away).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import check, load
from .encode import hash5

N1 = 200_000
N2 = 1_000_000
M32 = 0xFFFFFFFF
P1, P2 = 2654435761, 2246822519  # xxHash32's primes

# name: (threads, the line of the same benchmark in ubench.py's BENCHES,
# None for the two added here); the order is the Bench enum's of
# csrc/ubench.cu
BENCHES = {
    "loop": (1, 480),
    "smem_dep_read": (1, 481),
    "smem_dep_read2": (1, 482),
    "smem_dep_read4": (1, 483),
    "inner_while": (1, 484),
    "inner_inline": (1, 485),
    "smem_store_then_load": (1, 486),
    "smem_store_only": (1, 488),
    "smem_load_indep": (1, 489),
    "vmem_dyn_read": (32, 490),
    "vmem_dyn_rmw": (32, 491),
    "roll_dynamic": (32, 492),
    "vec_copy": (32, 493),
    "roll_static": (32, 494),
    "vec_add": (32, 495),
    "when_scalar_untaken": (1, 496),
    "when_vec_untaken": (32, 497),
    "merged_seq": (32, 498),
    "mxu_gather128": (32, 499),
    "smem_store_load_dep": (1, 500),
    "xxh32_stripe": (1, None),
    "probe_step": (32, None),
}

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load("ubench")
        lib.lz4t_ubench.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.lz4t_ubench.restype = ctypes.c_int
        _lib = lib
    return _lib


def run(name: str, n: int, seed: int, device="cuda"):
    """Benchmark ``name`` over ``n`` iterations: (accumulators, one uint32
    per thread, and the loop's clock64() cycles).  On the CPU the
    accumulators are the plain version's and the cycles None; on a card
    the kernel runs (counted in `kernel_launches[name]`)."""
    threads = BENCHES[name][0]
    dev = torch.device(device)
    if not 0 <= seed < 1 << 31 or n < 0:
        raise ValueError("seed must lie in [0, 2**31) and n be >= 0")
    if dev.type != "cuda":
        return plain(name, n, seed), None
    acc = torch.zeros((32,), dtype=torch.int32, device=dev)
    cycles = torch.zeros((1,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel().lz4t_ubench(
            list(BENCHES).index(name), n, seed, acc.data_ptr(), cycles.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, f"ubench {name}")
    kernel_launches[name] += 1
    return [v & M32 for v in acc[:threads].tolist()], int(cycles.item())


def slope(name: str, seed: int, device="cuda") -> dict:
    """Cycles per iteration of ``name`` on the card: the slope of the loop's
    span between N1 and N2 iterations (the smallest of three runs each),
    and the accumulators at N1."""
    spans = {}
    for n in (N1, N2):
        runs = [run(name, n, seed, device) for _ in range(3)]
        spans[n] = min(c for _, c in runs)
        if n == N1:
            acc = runs[0][0]
    return {"cycles_per_iter": (spans[N2] - spans[N1]) / (N2 - N1),
            "cycles_n1": spans[N1], "cycles_n2": spans[N2], "acc": acc}


# ---- the plain versions: csrc/ubench.cu's loops on the host -------------

def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _scalar(name: str, n: int, seed: int) -> int:
    """A one-thread benchmark's accumulator."""
    a = 0
    if name == "loop":
        for i in range(n):
            a = (a + (i ^ seed)) & M32
    elif name == "smem_dep_read":
        sc = [seed, 2, 5, 1, 7, 3, 0, 6]
        for _ in range(n):
            a = sc[a & 7]
    elif name in ("smem_dep_read2", "smem_dep_read4"):
        chains = 2 if name == "smem_dep_read2" else 4
        mul, add = (3, 5, 7, 1), (1, 2, 3, 5)
        sc = [[((seed >> (3 * c)) + mul[c] * j + add[c]) & 7 for j in range(8)]
              for c in range(chains)]
        x = list(range(chains))
        for _ in range(n):
            x = [sc[c][x[c] & 7] for c in range(chains)]
        a = sum(x) & M32
    elif name in ("inner_while", "inner_inline"):  # the same loads, with and without the inner loop
        sc = list(range(64))
        a = seed
        for i in range(n):
            a = sc[a & 63]
            if i & 1:
                a = sc[(a + 1) & 63]
    elif name == "smem_store_then_load":
        sc = list(range(64))
        a = seed
        for i in range(n):
            sc[i & 63] = a
            a = (sc[(i + 32) & 63] + 1) & M32
    elif name == "smem_store_only":
        sc = list(range(64))
        sc[0] = seed
        for i in range(n):
            sc[i & 63] = a
            a = (a + 1) & M32
        a = (a + sc[seed & 63]) & M32
    elif name == "smem_load_indep":
        sc = [j ^ seed for j in range(64)]
        for i in range(n):
            a = (a + sc[(i + 32) & 63]) & M32
    elif name == "when_scalar_untaken":  # never taken: the carry and i stay below 2^31
        a = (n * (seed & 255)) & M32
    elif name == "smem_store_load_dep":
        sc = [j ^ seed for j in range(64)]
        for i in range(n):
            mi = sc[a]
            sc[a] = i
            a = (mi * 7 + i) & 63
    elif name == "xxh32_stripe":
        v = [(seed + P1 + P2) & M32, (seed + P2) & M32, seed, (seed - P1) & M32]
        for i in range(n):
            x = ((4 * i * 0x9E3779B1) & M32) ^ seed
            for k in range(4):
                w = (x + k * 0x9E3779B1) & M32
                v[k] = (_rotl((v[k] + w * P2) & M32, 13) * P1) & M32
        a = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & M32
    else:
        raise KeyError(name)
    return a


def _warp(name: str, n: int, seed: int) -> list:
    """A one-warp benchmark's 32 accumulators."""
    lanes = range(32)
    if name in ("vmem_dyn_read", "vmem_dyn_rmw", "when_vec_untaken"):
        vm = np.arange(256 * 32, dtype=np.int64).reshape(256, 32) ^ seed
        rows = (np.arange(n, dtype=np.int64) + seed) & 255
        if name == "vmem_dyn_read":
            return [int(v) & M32 for v in vm[rows].sum(axis=0)] if n else [0] * 32
        if name == "vmem_dyn_rmw":
            vm = vm + np.bincount(rows, minlength=256)[:, None]
            return [int(v) & M32 for v in vm[0] + vm[255]]
        # the store is never taken; the carry counts the iterations
        return [((seed & 0xFFFF) + n + int(v)) & M32 for v in vm[seed & 255]]
    if name in ("roll_dynamic", "roll_static"):
        # lane k takes lane (k + shift) & 31's value each iteration
        shift = (n * (n - 1) // 2) if name == "roll_dynamic" else 5 * n
        return [((k + shift) & 31) ^ seed for k in lanes]
    if name == "vec_add":
        i = np.arange(n, dtype=np.int64)
        return [((k ^ seed) + int((i ^ k).sum())) & M32 for k in lanes]
    if name == "vec_copy":
        buf = bytearray((k * 131 + seed) & 255 for k in range(512))
        a = 0
        for i in range(n):
            dst = 256 + ((i * 13) & 127)
            src = (a + i) & 127
            buf[dst:dst + 32] = buf[src:src + 32]
            a = (a + buf[dst]) & M32
        return [(a + buf[256 + k] + (buf[384 + k] << 8)) & M32 for k in lanes]
    if name == "merged_seq":
        buf = bytearray((k * 37 + seed) & 255 for k in range(16384))
        a = 0
        for i in range(n):
            ll, ml, off = i & 15, 4 + ((i >> 4) & 15), 1 + ((a + i) & 31)
            src, d = (i * 13 + a) & 4095, 8192 + ((i * 11) & 4095)
            m = d + ll
            buf[d:m] = buf[src:src + ll]
            pattern = buf[m - off:m]
            buf[m:m + ml] = (pattern * (ml // off + 1))[:ml]
            a = (a + buf[m + ml - 1]) & M32
        return [(a + buf[8192 + 128 * k]) & M32 for k in lanes]
    if name == "mxu_gather128":
        w = [((k * P1) & M32) ^ seed for k in range(4096 + 32)]
        prefix = [0]
        for x in w:
            prefix.append(prefix[-1] + x)
        a = 0
        for i in range(n):
            b = (a + i) & 4095
            a = (a + prefix[b + 32] - prefix[b]) & M32
        return [a] * 32
    if name == "probe_step":
        return _probe_step(n, seed)
    raise KeyError(name)


def _probe_step(n: int, seed: int) -> list:
    tab = [0] * 4096
    acc = [0] * 32
    carry = seed
    for i in range(n):
        hits = 0
        base = ((carry + i) * 32) & M32
        writes = {}
        for k in range(32):
            x = base + k
            h = hash5((x * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
            c = tab[h]
            hits += (c ^ x) & 1
            acc[k] = (acc[k] + c) & M32
            writes[h] = x  # the highest lane of a bucket writes
        for h, x in writes.items():
            tab[h] = x
        carry = (carry + hits) & M32
    return [(a + carry) & M32 for a in acc]


def plain(name: str, n: int, seed: int) -> list:
    """The accumulators, one per thread, that benchmark ``name`` leaves
    after ``n`` iterations."""
    if BENCHES[name][0] == 1:
        return [_scalar(name, n, seed)]
    return _warp(name, n, seed)


kernel_launches = {name: 0 for name in BENCHES}
