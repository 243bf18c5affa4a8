"""The micro-benchmarks' plain versions (`ops.ubench.plain`), which the card
holds each kernel of `csrc/ubench.cu` to: at small n each equals a second,
independent computation of the same loop (a closed form where there is
one, else the loop written out lane by lane as the kernel runs it)."""

import numpy as np
import pytest

from lz4_tpu_torch.ops import ubench as U

M32 = 0xFFFFFFFF
SEED = 12345
NS = [0, 1, 2, 5, 64, 301]


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _reference(name: str, n: int, seed: int) -> list:
    lanes = range(32)
    if name == "loop":
        return [int((np.arange(n, dtype=np.int64) ^ seed).sum()) & M32]
    if name == "smem_dep_read":
        sc, a = [seed, 2, 5, 1, 7, 3, 0, 6], 0
        for _ in range(n):
            a = sc[a & 7]
        return [a]
    if name in ("smem_dep_read2", "smem_dep_read4"):
        chains = int(name[-1])
        total = 0
        for c, (mul, add) in enumerate(zip((3, 5, 7, 1), (1, 2, 3, 5))):
            if c == chains:
                break
            x = c
            for _ in range(n):
                x = ((seed >> (3 * c)) + mul * (x & 7) + add) & 7
            total += x
        return [total]
    if name in ("inner_while", "inner_inline"):
        a = seed
        for i in range(n):
            for j in range(1 + (i & 1)):  # the table holds j at j
                a = (a + j) & 63
        return [a]
    if name == "smem_store_then_load":
        sc, a = list(range(64)), seed
        for i in range(n):
            sc[i & 63] = a
            a = (sc[(i + 32) & 63] + 1) & M32
        return [a]
    if name == "smem_store_only":
        sc = list(range(64))
        sc[0] = seed
        for i in range(n):
            sc[i & 63] = i
        return [(n + sc[seed & 63]) & M32]
    if name == "smem_load_indep":
        return [sum(((i + 32) & 63) ^ seed for i in range(n)) & M32]
    if name == "when_scalar_untaken":
        return [((seed & 255) * n) & M32]
    if name == "smem_store_load_dep":
        sc, a = [j ^ seed for j in range(64)], 0
        for i in range(n):
            sc[a], a = i, (sc[a] * 7 + i) & 63
        return [a]
    if name == "xxh32_stripe":
        v = [(seed + 2654435761 + 2246822519) & M32, (seed + 2246822519) & M32, seed,
             (seed - 2654435761) & M32]
        for i in range(n):
            for k in range(4):
                w = ((((4 * i * 0x9E3779B1) & M32) ^ seed) + k * 0x9E3779B1) & M32
                v[k] = (_rotl((v[k] + w * 2246822519) & M32, 13) * 2654435761) & M32
        return [(_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & M32]
    if name in ("vmem_dyn_read", "vmem_dyn_rmw", "when_vec_untaken"):
        out = []
        for lane in lanes:
            col = [(r * 32 + lane) ^ seed for r in range(256)]
            a = 0
            for i in range(n):
                r = (i + seed) & 255
                if name == "vmem_dyn_read":
                    a += col[r]
                elif name == "vmem_dyn_rmw":
                    col[r] += 1
            if name == "vmem_dyn_rmw":
                a = col[0] + col[255]
            elif name == "when_vec_untaken":
                a = (seed & 0xFFFF) + n + col[seed & 255]
            out.append(a & M32)
        return out
    if name in ("roll_dynamic", "roll_static"):
        v = [k ^ seed for k in lanes]
        for i in range(n):
            s = i if name == "roll_dynamic" else 5
            v = [v[(k + s) & 31] for k in lanes]
        return v
    if name == "vec_add":
        return [((k ^ seed) + sum(i ^ k for i in range(n))) & M32 for k in lanes]
    if name == "vec_copy":
        buf = [(k * 131 + seed) & 255 for k in range(512)]
        a = 0
        for i in range(n):
            dst, src = 256 + ((i * 13) & 127), (a + i) & 127
            got = [buf[src + k] for k in lanes]
            for k in lanes:
                buf[dst + k] = got[k]
            a = (a + buf[dst]) & M32
        return [(a + buf[256 + k] + (buf[384 + k] << 8)) & M32 for k in lanes]
    if name == "merged_seq":
        buf = [(k * 37 + seed) & 255 for k in range(16384)]
        a = 0
        for i in range(n):
            ll, ml, off = i & 15, 4 + ((i >> 4) & 15), 1 + ((a + i) & 31)
            src, d = (i * 13 + a) & 4095, 8192 + ((i * 11) & 4095)
            for k in range(ll):
                buf[d + k] = buf[src + k]
            m = d + ll
            for k in range(ml):  # the byte-serial match copy
                buf[m + k] = buf[m + k - off]
            a = (a + buf[m + ml - 1]) & M32
        return [(a + buf[8192 + 128 * k]) & M32 for k in lanes]
    if name == "mxu_gather128":
        w = [((k * 2654435761) & M32) ^ seed for k in range(4096 + 32)]
        a = 0
        for i in range(n):
            b = (a + i) & 4095
            a = (a + sum(w[b:b + 32])) & M32
        return [a] * 32
    if name == "probe_step":
        tab, acc, carry = [0] * 4096, [0] * 32, seed
        for i in range(n):
            xs = [(((carry + i) * 32) + k) & M32 for k in lanes]
            hs = [(((x * 0x9E3779B97F4A7C15) << 24) * 889523592379
                   & 0xFFFFFFFFFFFFFFFF) >> 52 for x in xs]
            cs = [tab[h] for h in hs]
            carry = (carry + sum((c ^ x) & 1 for c, x in zip(cs, xs))) & M32
            for k in lanes:
                if hs[k] not in hs[k + 1:]:  # no later lane writes the bucket
                    tab[hs[k]] = xs[k]
                acc[k] = (acc[k] + cs[k]) & M32
        return [(a + carry) & M32 for a in acc]
    raise KeyError(name)


@pytest.mark.parametrize("name", list(U.BENCHES))
def test_plain_accumulators_at_small_n(name):
    for n in NS:
        got = U.plain(name, n, SEED)
        assert len(got) == U.BENCHES[name][0]
        assert got == _reference(name, n, SEED), (name, n)


def test_the_two_inner_loop_benchmarks_make_the_same_loads():
    for n in NS:
        assert U.plain("inner_while", n, 77) == U.plain("inner_inline", n, 77)


def test_every_ubench_py_benchmark_has_a_counterpart():
    lines = open(U.__file__.rsplit("lz4_tpu_torch", 1)[0] + "ubench.py").read().splitlines()
    for name, (_, line) in U.BENCHES.items():
        if line is not None:
            assert lines[line - 1].strip().startswith(f'"{name}"'), name
    assert sum(line is not None for _, line in U.BENCHES.values()) == 20


def test_the_cpu_route_runs_the_plain_version_and_counts_no_launch():
    before = dict(U.kernel_launches)
    acc, cycles = U.run("probe_step", 40, SEED, "cpu")
    assert acc == U.plain("probe_step", 40, SEED) and cycles is None
    assert U.kernel_launches == before
    with pytest.raises(ValueError):
        U.run("loop", 10, -1, "cpu")
