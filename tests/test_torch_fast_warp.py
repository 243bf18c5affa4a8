"""Kernel D's FAST scan as its warp computes it, plain: the batched probe
search (`encode._encode_canonical_warp`, `_encode_dense_warp`: 32 probes a
step, the table's writes inside a step resolved as the warp resolves them)
and the dense seed (`encode.dense_seed_warp`), held byte for byte to the
serial plain scans, to the JAX package's `pallas_encode5` (interpret mode
on the CPU) and to the frames of `lz4_tpu.frame.compress(...,
backend="host")`."""

import functools
import random

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lz4_tpu import frame as jframe
from lz4_tpu.ops import encode_pallas5 as E5
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.ops import encode as E
from lz4_tpu_torch.ops import encode_stream as ES
from lz4_tpu_torch.ops.common import read32
from test_cross_backend_fuzz import _random_structured

import bench
import chip_smoke

CORPUS = bench.make_corpus(1 << 20, seed=2)
QUARTERS = ("text", "records", "runs", "noise")


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode, kept for the whole module so that each
    kernel shape traces once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        E5.pallas_encode5.clear_cache()
        yield
        E5.pallas_encode5.clear_cache()


@pytest.fixture
def warp_scans(monkeypatch):
    """The port's plain route with the batched scans in place of the
    serial ones."""
    for mod in (E, ES):
        monkeypatch.setattr(mod, "_encode_canonical", E._encode_canonical_warp)
        monkeypatch.setattr(mod, "_encode_dense", E._encode_dense_warp)


def _quarter(k: int, n: int) -> bytes:
    q = len(CORPUS) // 4
    return CORPUS[k * q + 1234: k * q + 1234 + n]


def _same(row: bytes, accel: int, src_off: int = 0):
    assert E._encode_canonical_warp(row, accel) == E._encode_canonical(row, accel)
    assert (E._encode_dense_warp(row, accel, src_off)
            == E._encode_dense(row, accel, src_off))


@pytest.mark.parametrize("accel", [1, 8])
@pytest.mark.parametrize("quarter", range(4), ids=QUARTERS)
def test_each_quarter_at_64k(quarter, accel):
    _same(_quarter(quarter, 65536), accel)


@pytest.mark.parametrize("n", [65546, 65547, 100000], ids=["byU16", "byU32", "byU32_100k"])
def test_both_hash_widths(n):
    row = _quarter(0, n // 2) + _quarter(1, n - n // 2)
    _same(row, 1)
    steps = {}
    E._encode_canonical_warp(row, 1, steps)
    assert steps["probe_steps"] > 0 and steps["sequences"] > 0


@pytest.mark.parametrize("n", [0, 1, 12, 13, 14, 65546, 65547])
def test_edge_lengths(n):
    _same(_quarter(2, n), 1)
    _same(_quarter(3, n), 65537)


def _bucket(p, row):
    return ((read32(row, p) * 2654435761) & 0xFFFFFFFF) >> 17


@pytest.mark.parametrize("n", [4096, 65536])
def test_probes_that_collide_inside_one_step(n):
    """A row of 4-byte words from one bucket (found by search): many
    probes of one 32-probe step share a bucket, so a later lane reads an
    earlier lane's position, not the table's."""
    row = chip_smoke.collision_row(n, 11)
    buckets = [_bucket(p, row) for p in range(0, 256, 4)]
    assert len(set(buckets)) == 1
    for accel in (1, 2, 8):
        _same(row, accel)
        _same(row, accel, n // 4)


def test_collisions_within_one_step_are_exercised():
    """The dense scan over the collision row: in a step of 32 probes at
    stride 1 (the first of a search) several lanes share a bucket."""
    row = chip_smoke.collision_row(4096, 3)
    steps = [_bucket(p, row) for p in range(32)]
    assert len(set(steps)) < 32


@pytest.mark.parametrize("src_off", [0, 3, 4, 5, 66, 4096, 65536])
def test_dense_seed_later_insert_wins(src_off):
    """The seed 32 stride-2 positions a step, the highest lane of a bucket
    writing, leaves the table the serial seed leaves."""
    rng = random.Random(src_off)
    row = (chip_smoke.collision_row(src_off // 2, 5)
           + _random_structured(rng, src_off - src_off // 2) + bytes(8))
    serial = [0] * (1 << 15)
    for i in range(0, src_off - 3, 2):
        serial[_bucket(i, row)] = i + 1
    assert E.dense_seed_warp(row, src_off) == serial


@pytest.mark.parametrize("src_off", [1, 100, 65536])
def test_dense_windows_with_prefixes(src_off):
    row = _quarter(0, src_off) + _quarter(1, 65536)
    _same(row, 1, src_off)


@pytest.mark.parametrize("geometry", ["canonical", "dense"])
@pytest.mark.parametrize("accel", [1, 8])
def test_batched_scans_match_pallas(geometry, accel, interpret, warp_scans):
    rng = random.Random(31)
    rows = [b"", b"q", b"abcdefghijklm", b"x" * 12, bytes(4096), rng.randbytes(4096),
            b"ab" * 2048, chip_smoke.collision_row(4096, 1)]
    rows += [_random_structured(rng, rng.choice([200, 3000, 4096])) for _ in range(4)]
    bufs = np.zeros((len(rows), 4096 + 1024), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, d in enumerate(rows):
        bufs[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    jout, jclens, jerrs = (np.asarray(t) for t in E5.encode_blocks_pallas5(
        bufs, lens, 4096, 0, accel, geometry))
    out, clens, errs = E.encode_blocks(torch.from_numpy(bufs), torch.from_numpy(lens),
                                       4096, 0, accel, geometry)
    assert np.array_equal(clens.numpy(), jclens) and np.array_equal(errs.numpy(), jerrs)
    for b in range(len(rows)):
        assert np.array_equal(out[b, :clens[b]].numpy(), jout[b, :jclens[b]]), b


@pytest.mark.parametrize("chain_blocks,block_size", [(False, 65536), (True, 65536),
                                                     (False, 256 * 1024)])
def test_batched_scans_make_the_jax_frames(chain_blocks, block_size, warp_scans):
    """Frames at levels 0-2 made with the batched scans equal the JAX
    package's (independent: canonical; chained: dense with 64 KB
    prefixes)."""
    data = CORPUS[: 300000]
    for level in (0, 2):
        kw = dict(chain_blocks=chain_blocks, block_size=block_size,
                  compression_level=level)
        ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
        assert ours == jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
