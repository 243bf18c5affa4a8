"""Canonical chained FAST frames on the CPU: kernel F's plain versions
(`ops.encode_continue.continue_blocks_plain`, the serial continue schedule,
`continue_blocks_warp`, the warp's 32-wide probe search, and
`continue_blocks_rounds`, the kernel's rounds of walks from guessed tables
at any cap on the rounds) held to the JAX package's native continue
engine, its pure-Python twin and liblz4's LZ4_compress_fast_continue; the
rounds' re-walks, dead entries, entry 0 and serial tail; the port's frames
to `lz4_tpu.frame.compress`
(its default route, `_host_chained_canonical_compress`) byte for byte; the
two packages decoding each other's frames; and the refusals the JAX
package makes."""

import io

import numpy as np
import pytest
import torch

from lz4_tpu import frame as jframe
from lz4_tpu import native
from lz4_tpu.block import incremental as jincremental
from lz4_tpu.block.hostref import ChainedCanonicalEncoder
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch import parallel
from lz4_tpu_torch.block import incremental as tincremental
from lz4_tpu_torch.constants import compress_bound
from lz4_tpu_torch.frame.api import _scan_single_frame
from lz4_tpu_torch.ops import encode_continue as F

import chip_smoke
import liblz4

pytestmark = pytest.mark.skipif(not native.available(), reason="native engine unavailable")

GRID = [(n, bs, accel) for n in (40, 9000, 90000, 250000)
        for bs in (10, 4096, 16384, 65536) for accel in (1, 3)]


def _data(n: int, seed: int) -> bytes:
    """n bytes of the bench mix (text, records, runs, noise), from a seed."""
    data = chip_smoke.make_corpus(n + 64, seed)[:n]
    assert len(data) == n
    return data


@pytest.mark.parametrize("n,bs,accel", GRID, ids=[f"{n}-{bs}-a{a}" for n, bs, a in GRID])
def test_plain_schedule_equals_the_native_engine(n, bs, accel):
    data = _data(n, 7000 + n % 97 + bs % 89 + accel)
    mine = F.continue_blocks_plain(data, bs, accel)
    assert mine == native.chained_canonical_blocks(data, bs, accel)
    enc = ChainedCanonicalEncoder(data)
    assert mine == [enc.encode_block(off, min(bs, n - off), accel) for off in range(0, n, bs)]
    if liblz4.LIB is not None:
        assert mine == liblz4.compress_blocks_continue(data, bs, accel)


@pytest.mark.parametrize("lanes", [1, 2, 32])
@pytest.mark.parametrize("bs,accel", [(4096, 1), (4096, 3), (65536, 1), (16384, 8)])
def test_warp_model_equals_the_serial_schedule(lanes, bs, accel):
    """The warp's search at any width gives the serial schedule's bytes and
    leaves its table: a search that runs out of probes still makes the
    writes of the probes before its end, which the next block reads."""
    data = _data(300_000, 31 + bs + accel)
    steps = []
    got = F.continue_blocks_warp(data, bs, accel, lanes=lanes, steps=steps)
    assert got == F.continue_blocks_plain(data, bs, accel)
    assert len(steps) == len(got)
    assert all(s["probe_steps"] >= 0 and s["sequences"] >= 0 for s in steps)
    if lanes == 32:
        one = []
        F.continue_blocks_warp(data, bs, accel, lanes=1, steps=one)
        assert sum(s["probe_steps"] for s in steps) < sum(s["probe_steps"] for s in one)
        assert [s["sequences"] for s in steps] == [s["sequences"] for s in one]


@pytest.mark.parametrize("n, seed", [(70_000, 1), (13, 2), (200_000, 3), (0, 4)])
def test_the_kernels_cpu_route_is_the_plain_version(n, seed):
    """`encode_continue` on a CPU tensor: each block's row and length as
    the plain schedule gives them, steps from the warp model, no launch."""
    data = _data(n, seed)
    payload = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    nb = -(-n // 65536)
    steps = torch.zeros((nb, 2), dtype=torch.int32)
    launches = F.encode_continue.launches
    out, clens = F.encode_continue(payload, 65536, steps=steps)
    assert F.encode_continue.launches == launches
    assert out.shape == (nb, compress_bound(65536)) and clens.shape == (nb,)
    want = F.continue_blocks_plain(data, 65536)
    assert [out[k, :int(clens[k])].numpy().tobytes() for k in range(nb)] == want
    if nb:
        assert int(steps[:, 0].min()) >= 1 and int(steps.sum()) > 0
    plain = F.encode_continue_plain(payload, 65536)
    assert all(torch.equal(a, b) for a, b in zip(plain, (out, clens)))


def _noisy_payload(bs: int, tail: int) -> bytes:
    """Blocks of the mix, one block of random bytes (stored raw), and a
    last block of ``tail`` bytes (0: an exact multiple of ``bs``)."""
    rng = np.random.default_rng(bs + tail)
    body = _data(3 * bs, 11)
    noise = rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
    return body[:2 * bs] + noise + body[2 * bs:] + body[:tail]


FRAMES = [
    (level, bs, tail, sums)
    for level in (0, 1, 2)
    for bs, tail in ((65536, 7), (65536, 0), (262144, 12))
    for sums in ((False, False), (True, True))
]


@pytest.mark.parametrize("level,bs,tail,sums", FRAMES)
def test_frames_equal_the_jax_package(level, bs, tail, sums):
    data = _noisy_payload(bs, tail)
    kw = dict(geometry="canonical", compression_level=level, block_size=bs,
              block_checksum=sums[0], content_checksum=sums[1])
    for extra in ({}, {"content_length": len(data)}):
        ours = tframe.compress(data, tframe.EncoderSettings(**kw, **extra), device="cpu")
        theirs = jframe.compress(data, jframe.EncoderSettings(**kw, **extra), backend="auto")
        assert ours == theirs
    _, blocks, _ = _scan_single_frame(ours)
    assert any(stored for _, _, stored in blocks)  # the noise block
    assert tframe.decompress(theirs, device="cpu") == data
    assert jframe.decompress(ours) == data


def test_compress_into_and_store_size_follow_compress():
    data = _noisy_payload(65536, 5)
    s = tframe.EncoderSettings(geometry="canonical")
    want = jframe.compress(data, jframe.EncoderSettings(geometry="canonical"), store_size=True)
    assert tframe.compress(data, s, store_size=True, device="cpu") == want
    buf = bytearray(len(data) + 1024)
    n = tframe.compress_into(data, buf, s, device="cpu")
    assert bytes(buf[:n]) == jframe.compress(data, jframe.EncoderSettings(geometry="canonical"))


def test_a_mesh_refuses_as_the_jax_device_route_does():
    data = _data(200_000, 5)
    with pytest.raises(ValueError, match="canonical chained") as theirs:
        jframe.compress(data, jframe.EncoderSettings(geometry="canonical"), backend="tpu")
    mesh = parallel.make_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="canonical chained") as ours:
        tframe.compress(data, tframe.EncoderSettings(geometry="canonical"), mesh=mesh)
    assert type(ours.value) is type(theirs.value)


@pytest.mark.parametrize("surface", ["FrameWriter", "open", "create_encoder"])
def test_streaming_surfaces_refuse_as_in_the_jax_package(surface, tmp_path):
    def call(pkg, frame_mod, incremental):
        s = frame_mod.EncoderSettings(geometry="canonical")
        if surface == "FrameWriter":
            return frame_mod.FrameWriter(io.BytesIO(), s, **pkg)
        if surface == "open":
            return frame_mod.open(tmp_path / "x.lz4", "wb", settings=s, **pkg)
        return incremental.create_encoder(True, 0, geometry="canonical", **pkg)

    with pytest.raises(ValueError) as theirs:
        call({}, jframe, jincremental)
    with pytest.raises(ValueError) as ours:
        call({"device": "cpu"}, tframe, tincremental)
    assert str(ours.value) == str(theirs.value)


class _Longer(bytes):
    """Bytes that report a length past the bound, to reach the JAX
    package's check without 2 GiB."""

    def __len__(self):
        return (1 << 31) - (64 << 20) + 1

    def __bytes__(self):
        return self


def test_the_size_bound_raises_what_the_jax_package_raises(monkeypatch):
    with pytest.raises(ValueError) as theirs:
        native.chained_canonical_blocks(_Longer(b"abc"), 65536)
    assert F.MAX_FRAME == (1 << 31) - (64 << 20)
    monkeypatch.setattr(F, "MAX_FRAME", 100_000)
    data = _data(100_001, 9)
    with pytest.raises(ValueError) as ours:
        tframe.compress(data, tframe.EncoderSettings(geometry="canonical"), device="cpu")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="2 GiB"):
        F.continue_blocks_plain(data, 65536)
    with pytest.raises(ValueError, match="2 GiB"):
        F.encode_continue(torch.frombuffer(bytearray(data), dtype=torch.uint8), 65536)
    assert len(F.continue_blocks_plain(data[:100_000], 65536)) == 2


# ---- kernel F's schedule of rounds (`continue_blocks_rounds`) ----------

ROUNDS_SIZES = {10: 2_000, 4096: 90_000, 16384: 250_000, 65536: 300_000, 262144: 700_000}
ROUNDS_GRID = [(bs, accel, cap) for bs in ROUNDS_SIZES for accel in (1, 3)
               for cap in (0, 1, 2, None)]
_EXPECTED: dict = {}


def _expected(n: int, bs: int, accel: int):
    """The data and the serial blocks of the JAX package's native engine,
    held to its pure-Python twin and liblz4 (once per shape)."""
    if (n, bs, accel) not in _EXPECTED:
        data = _data(n, 500 + bs % 97 + accel)
        want = native.chained_canonical_blocks(data, bs, accel)
        enc = ChainedCanonicalEncoder(data)
        assert want == [enc.encode_block(off, min(bs, n - off), accel)
                        for off in range(0, n, bs)]
        if liblz4.LIB is not None:
            assert want == liblz4.compress_blocks_continue(data, bs, accel)
        _EXPECTED[n, bs, accel] = data, want
    return _EXPECTED[n, bs, accel]


@pytest.mark.parametrize("bs,accel,cap", ROUNDS_GRID,
                         ids=[f"{bs}-a{a}-r{c}" for bs, a, c in ROUNDS_GRID])
def test_rounds_schedule_equals_the_native_engine(bs, accel, cap):
    """Any cap on the rounds gives the serial bytes: 0 is the serial tail
    alone, None rounds until every block is final."""
    n = ROUNDS_SIZES[bs]
    data, want = _expected(n, bs, accel)
    stats: dict = {}
    assert F.continue_blocks_rounds(data, bs, accel, max_rounds=cap, stats=stats) == want
    nb = len(want)
    assert len(stats["walks"]) == nb and min(stats["walks"]) >= 1
    assert stats["rounds"] == len(stats["walked"]) <= (nb if cap is None else cap)
    assert stats["walked"][:1] == ([nb] if cap != 0 else [])
    if cap is None:
        assert stats["tail"] is None
    if cap == 0:
        assert stats["tail"] == 0 and stats["walks"] == [1] * nb
    assert sum(stats["walks"]) == sum(stats["walked"]) + (
        0 if stats["tail"] is None else nb - stats["tail"])


def _records(blocks: int, bs: int) -> bytes:
    """``blocks`` blocks of the records quarter of the mix."""
    corpus = chip_smoke.make_corpus(4 * blocks * bs + 64, 0)
    q = len(corpus) // 4
    return corpus[q:q + blocks * bs]


def test_round_one_guesses_wrong_and_the_rounds_repair_it():
    """On records, blocks walked from a zeroed table give other bytes than
    the serial schedule; the rounds re-walk them until they agree."""
    bs = 16384
    data = _records(8, bs)
    serial = F.continue_blocks_plain(data, bs)
    _, h = F._canon_hash(data, F.CANON_64K)
    guessed = [bytes(F.canonical_block(data, a, b, floor, [0] * F.TABLE_ENTRIES, h,
                                       False, 1))
               for a, b, floor in F._blocks(len(data), bs)]
    assert guessed[0] == serial[0] and guessed != serial
    stats: dict = {}
    assert F.continue_blocks_rounds(data, bs, stats=stats) == serial
    assert stats["rounds"] > 1 and sum(stats["walks"]) > len(serial)
    assert stats["tail"] is None


def test_tables_that_differ_only_in_dead_entries_need_no_rewalk():
    """Block 0 ends in a run that one match covers, so every entry it
    leaves is more than 65,535 bytes behind block 1's start: the zeroed
    guess differs from it only in dead entries, and round 1 is final."""
    bs = 262144
    text = _data(bs, 21)[:190_000]
    data = text + bytes(bs - len(text)) + _data(bs, 22)
    _, h = F._canon_hash(data, F.CANON_64K)
    tab = [0] * F.TABLE_ENTRIES
    F.canonical_block(data, 0, bs, 0, tab, h, False, 1)
    zeros = [0] * F.TABLE_ENTRIES
    assert tab != zeros and F._live_equal(tab, zeros, bs)
    assert not F._live_equal(tab, zeros, bs - 70_000)
    stats: dict = {}
    assert F.continue_blocks_rounds(data, bs, stats=stats) == F.continue_blocks_plain(data, bs)
    assert stats == {"rounds": 1, "walked": [2], "tail": None, "walks": [1, 1]}


def test_entry_zero_is_live_in_the_first_64kb(monkeypatch):
    """At 4,096-byte blocks position 0 is a live entry for blocks that
    start below 65,536: a check that took a 0 as an empty slot, equal to
    any entry, would keep round 1's guesses from a zeroed table."""
    bs = 4096
    data = _data(12 * bs, 23)
    serial = F.continue_blocks_plain(data, bs)
    assert not F._live_equal([0] * F.TABLE_ENTRIES, [5] + [0] * (F.TABLE_ENTRIES - 1), bs)
    assert F._live_equal([0] * F.TABLE_ENTRIES, [5] + [0] * (F.TABLE_ENTRIES - 1), 70_000)
    stats: dict = {}
    assert F.continue_blocks_rounds(data, bs, stats=stats) == serial
    assert stats["walks"][1] > 1

    live_equal = F._live_equal
    monkeypatch.setattr(F, "_live_equal", lambda a, b, start: live_equal(
        [x or y for x, y in zip(a, b)], [y or x for x, y in zip(a, b)], start))
    assert F.continue_blocks_rounds(data, bs) != serial


def test_the_cap_hands_the_rest_to_the_serial_tail():
    """The noise quarter's parse never settles: after two rounds the tail
    walks the blocks from the first one not final, one after another."""
    bs = 16384
    corpus = chip_smoke.make_corpus(4 * 12 * bs, 3)
    data = corpus[3 * len(corpus) // 4:][:12 * bs]
    serial = F.continue_blocks_plain(data, bs)
    stats: dict = {}
    assert F.continue_blocks_rounds(data, bs, max_rounds=2, stats=stats) == serial
    assert stats["rounds"] == 2 and stats["walked"][0] == 12
    assert stats["tail"] is not None and 2 <= stats["tail"] < 12
    assert all(w >= 1 for w in stats["walks"][stats["tail"]:])
    unbounded: dict = {}
    assert F.continue_blocks_rounds(data, bs, stats=unbounded) == serial
    assert unbounded["rounds"] > 2 and unbounded["tail"] is None


@pytest.mark.parametrize("cap", [None, 1, 0])
def test_windows_carry_the_table_from_one_to_the_next(cap, monkeypatch):
    """In windows of 3 blocks each window's first block starts from the
    table the window before left, and the rounds run window by window."""
    monkeypatch.setattr(F, "WINDOW_BLOCKS", 3)
    bs = 16384
    data, want = _expected(ROUNDS_SIZES[bs], bs, 1)
    stats: dict = {}
    assert F.continue_blocks_rounds(data, bs, max_rounds=cap, stats=stats) == want
    assert stats["rounds"] <= 3 and stats["walked"][:1] == ([] if cap == 0 else [len(want)])
    if cap is None:
        assert stats["tail"] is None


def test_the_kernels_cpu_route_reports_the_rounds():
    data = _data(300_000, 24)
    payload = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    for cap in (F.MAX_ROUNDS, 0, 1, None):
        got: dict = {}
        want: dict = {}
        F.encode_continue(payload, 65536, max_rounds=cap, stats=got)
        F.continue_blocks_rounds(data, 65536, max_rounds=cap, stats=want)
        assert got == want
    with pytest.raises(ValueError, match="max_rounds"):
        F.encode_continue(payload, 65536, max_rounds=-1)
