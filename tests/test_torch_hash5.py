"""`hash5_rows`' plain version (`ops.encode_continue.hash5_rows_plain`: the
byU32 hash that kernels D and F call, `canon_hash5`) against the archived
TPU experiment's 64-bit oracle and its 32-bit split
(`experiments.canon_hash32.hash5_ref`, `hash5_u32`, `hash5_u32_np`), on the
vectors of `experiments/tests/test_canon_hash32.py` (`chip_smoke.
hash5_vectors`, which the card's run holds the kernel to)."""

import numpy as np
import pytest
import torch

from experiments.canon_hash32 import hash5_ref, hash5_u32, hash5_u32_np
from lz4_tpu_torch.ops import encode as E
from lz4_tpu_torch.ops import encode_continue as F

import chip_smoke

VECTORS = chip_smoke.hash5_vectors(0)
# the parts of VECTORS: the 11 edges, default_rng(20260820)'s 20,000, every
# low byte with 16 tails, the Pallas test's 4,096, 2^20 more
PARTS = {"edges": (0, 11), "random": (11, 20011), "low_bytes": (20011, 24107),
         "pallas": (24107, 28203), "more": (28203, 28203 + (1 << 20))}


def test_the_vectors_are_the_archived_tests():
    assert VECTORS.size == PARTS["more"][1]
    assert VECTORS[:11].tolist() == chip_smoke.HASH5_EDGES
    rng = np.random.default_rng(20260820)
    a, b = PARTS["random"]
    assert np.array_equal(VECTORS[a:b], rng.integers(0, 1 << 40, 20000, dtype=np.uint64))
    a, b = PARTS["low_bytes"]
    assert sorted(set((VECTORS[a:b] & np.uint64(0xFF)).tolist())) == list(range(256))
    a, b = PARTS["pallas"]
    assert np.array_equal(VECTORS[a:b], np.random.default_rng(20260820).integers(
        0, 1 << 40, 4096, dtype=np.uint64))


@pytest.mark.parametrize("part", list(PARTS))
def test_plain_equals_the_oracle_and_the_32_bit_split(part):
    a, b = PARTS[part]
    v = VECTORS[a:b]
    got = F.hash5_rows(torch.from_numpy(v.copy()))
    assert got.dtype == torch.int32 and got.shape == (b - a,)
    b0 = (v & np.uint64(0xFF)).astype(np.uint32)
    w = ((v >> np.uint64(8)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    assert np.array_equal(got.numpy(), hash5_u32_np(b0, w))
    step = 1 if b - a < 30000 else 97  # the Python oracle on every 97th of 2^20
    for k in range(0, b - a, step):
        x = int(v[k])
        assert got[k] == hash5_ref(x) == hash5_u32(x & 0xFF, (x >> 8) & 0xFFFFFFFF) \
            == E.hash5(x), hex(x)


def test_int64_reads_as_its_bits_and_the_cpu_counts_no_launch():
    v = torch.from_numpy(VECTORS[:28203].copy())
    launches = F.hash5_rows.launches
    assert torch.equal(F.hash5_rows(v.view(torch.int64)), F.hash5_rows(v))
    assert F.hash5_rows.launches == launches
    assert int(F.hash5_rows(v).min()) >= 0 and int(F.hash5_rows(v).max()) < 4096
    with pytest.raises(ValueError):
        F.hash5_rows(torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        F.hash5_rows(torch.zeros(4, dtype=torch.int32))
    assert F.hash5_rows(torch.zeros(0, dtype=torch.uint64)).numel() == 0
