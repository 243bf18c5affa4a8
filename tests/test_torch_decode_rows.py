"""Kernel A's one-warp route (`decode_rows`) on the CPU: the plain model of
its schedule (`decode.decode_rows_model`: the staged ring, the parse queued
ahead of the copies, the lane-advanced match index, the limit) held to the
serial plain version (`decode._decode_row`) and, on a pinned few, to the
JAX package's `pallas_decode6` in interpret mode; the route rule and the
step count."""

import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from lz4_tpu.ops import decode_pallas6 as D6
from lz4_tpu_torch import block
from lz4_tpu_torch.ops import decode as D
from lz4_tpu_torch.parallel.blocks import comp_capacity

BLOCK = 65536


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode for the module (each shape traces once)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        D6.pallas_decode6.clear_cache()
        yield
        D6.pallas_decode6.clear_cache()


def _encode(raw: bytes) -> bytes:
    return block.encode(raw, device="cpu")


@pytest.fixture(scope="module")
def mix():
    """A 64 KB row from each quarter of the bench mix, compressed."""
    data = chip_smoke.make_corpus(4 * BLOCK, 4)
    return [_encode(data[k * BLOCK:(k + 1) * BLOCK]) for k in range(4)]


def _held(row: bytes, out_cap: int, window: bytes = b"", limit: int = -1,
          leads=(0, 9)):
    """The model at each lead, the copy warp eager and late, against the
    plain version; returns the plain version's (bytes, err)."""
    want = D._decode_row(row, len(row), out_cap, window, limit)
    for lead in leads:
        for eager in (False, True):
            assert D.decode_rows_model(row, out_cap, window, limit, lead, eager) == want
    return want


@pytest.mark.parametrize("quarter", range(4))
def test_model_matches_plain_on_the_mix(quarter, mix):
    data, err = _held(mix[quarter], BLOCK)
    assert err == 0 and len(data) == BLOCK


@pytest.mark.parametrize("dlen", [0, 1, 100, 65536])
def test_model_matches_plain_on_offset_streams(dlen):
    rng = np.random.default_rng(dlen)
    window = rng.integers(0, 256, dlen, dtype=np.uint8).tobytes()
    comp, raw = chip_smoke.offset_stream(rng, window, BLOCK)
    assert _held(comp, BLOCK, window) == (raw, 0)


@pytest.mark.parametrize("dlen", [0, 100, 65536])
def test_model_matches_plain_at_the_limit_edges(dlen):
    """Limits inside a literal run, on its end, inside a match, on a
    sequence's end, at 0, at the row's end and at out_cap."""
    rng = np.random.default_rng(40 + dlen)
    window = rng.integers(0, 256, dlen, dtype=np.uint8).tobytes()
    comp, raw = chip_smoke.offset_stream(rng, window, BLOCK)
    edges = chip_smoke.sequence_edges(comp)
    lit = next(a for a, b in edges if a >= 2)
    match = next(b for a, b in edges if b - a >= 2 and a > 0)
    mid = edges[len(edges) // 2][1]
    for limit in (0, lit - 1, lit, match - 1, mid, len(raw), BLOCK):
        data, err = _held(comp, BLOCK, window, limit, leads=(3,))
        assert err == 0 and data == raw[:limit]


def _corrupt():
    good = _encode(chip_smoke.make_corpus(4 * BLOCK, 5)[:BLOCK])
    return chip_smoke.corrupt_rows(good) + [b"", b"\x00", b"\x10a", b"\x10"]


@pytest.mark.parametrize("kind", range(11))
def test_model_matches_plain_on_corrupt_rows(kind):
    row = _corrupt()[kind]
    for out_cap in (16, 1000, BLOCK):
        _held(row, out_cap, leads=(0, 15))


@pytest.mark.parametrize("lead", range(16))
def test_model_matches_plain_across_the_stage_edges(lead):
    """Rows whose tokens, offsets and length extensions fall on either side
    of a 512-byte stage's edge and of the ring's, and a literal run longer
    than the ring holds (copied from the row itself)."""
    rng = np.random.default_rng(lead)
    for n in (1, 15, 16, 17, 511 - lead, 512 - lead, 513 - lead, 8191 - lead, 8193):
        raw = rng.integers(0, 4, n, dtype=np.uint8).tobytes()
        _held(_encode(raw), BLOCK, leads=(lead,))
    noise = _encode(rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes())
    assert len(noise) > BLOCK  # compress_bound: one literal run, the last
    tally = []
    assert D.decode_rows_model(noise, BLOCK, lead=lead, counts=tally) == (
        D._decode_row(noise, len(noise), BLOCK, b""))
    assert tally[0]["ring_literals"] == BLOCK
    assert tally[0]["stages"] == -(-(lead + len(noise)) // D.RING_STAGE)
    # a run longer than the ring, then a match: the offset read first, the
    # run copied from the row, the stages in between never copied (no slot
    # refilled while the stage it held is in flight)
    run = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    row = _encode(run + run[:5000])
    tally = []
    assert D.decode_rows_model(row, BLOCK, lead=lead, counts=tally) == (run + run[:5000], 0)
    assert tally[0]["row_literals"] == 20000 > D.RING_HOLD
    assert tally[0]["skipped"] > 0


def test_model_matches_pallas_decode6(interpret):
    """The model's lens, errs and bytes against the TPU kernel's on 4 KB
    rows: cuts of the mix, offset streams with dictionaries, the corrupt
    kinds."""
    n = 4096
    rng = np.random.default_rng(8)
    data = chip_smoke.make_corpus(4 * BLOCK, 8)
    rows = [_encode(data[k * BLOCK:k * BLOCK + n]) for k in range(4)]
    windows = [b""] * 4
    for dlen in (1, 100, 65536):
        window = rng.integers(0, 256, dlen, dtype=np.uint8).tobytes()
        rows.append(chip_smoke.offset_stream(rng, window, n)[0])
        windows.append(window)
    rows += chip_smoke.corrupt_rows(rows[0])
    windows += [b""] * (len(rows) - len(windows))
    comps = np.zeros((len(rows), comp_capacity(n)), np.uint8)
    dicts = np.zeros((len(rows), 65536), np.uint8)
    for i, (r, w) in enumerate(zip(rows, windows)):
        comps[i, :len(r)] = np.frombuffer(r, np.uint8)
        if w:
            dicts[i, 65536 - len(w):] = np.frombuffer(w, np.uint8)
    clens = np.array([len(r) for r in rows], np.int32)
    dlens = np.array([len(w) for w in windows], np.int32)
    out, lens, errs = (np.asarray(t) for t in D6.decode_blocks_pallas6(
        comps, clens, n, dicts, dlens))
    for i, (r, w) in enumerate(zip(rows, windows)):
        got, err = D.decode_rows_model(r, n, w, lead=i % 16)
        assert (len(got), err) == (int(lens[i]), int(errs[i])), i
        if err == 0:
            assert got == out[i, :lens[i]].tobytes(), i
    assert int(errs.astype(bool).sum()) >= 6


@pytest.mark.parametrize("off", list(range(1, 41)) + [255, 4096, 65535])
def test_lane_index_is_the_byte_mod_off(off):
    """Each lane's first index and step, advanced as the copy warp
    advances them, are byte i mod off for every byte of a 5,000-byte
    match."""
    for lane in range(32):
        j, step = D.lane_index(lane, off)
        assert step == (32 if off >= 32 else 32 % off)
        for i in range(lane, 5000, 32):
            assert j == i % off
            j += step
            if j >= off:
                j -= off


@pytest.mark.parametrize("rows, out_cap, want", [
    (1, 16, "warp"), (1, BLOCK, "warp"), (1024, BLOCK, "warp"), (4096, 1000, "warp"),
    (0, BLOCK, "rows"), (1, BLOCK + 1, "rows"), (127, 1 << 17, "rows"),
    (128, 1 << 17, "warp"), (1024, 1 << 17, "warp"), (255, 1 << 18, "rows"),
    (256, 1 << 18, "warp"), (4096, (1 << 18) + 1, "rows"), (64, 1 << 20, "rows"),
    (16, 4 << 20, "rows"),
])
def test_route_rule_is_a_function_of_rows_and_out_cap(rows, out_cap, want):
    """`decode.route`: the one-warp route for any batch of rows of at most
    64 KB, for 128 rows and more up to 128 KB and 256 and more up to 256 KB;
    the passes above (the times beside WARP_ROUTE_ROWS)."""
    assert D.route(rows, out_cap) == want


def _tally(comp, limit=-1):
    tally = []
    D.decode_rows_model(comp, BLOCK, limit=limit, counts=tally)
    return tally[0]


def test_schedule_steps_count_by_hand():
    """A row shorter than a window: every step serial, its sequences plus
    its length-extension bytes.  A match length of 15 + 255 + 255 + 7 (3
    bytes), a literal run of 15 + 20 (1 byte), the last literals: 3
    sequences, 4 extension bytes; to a limit of 10, the first sequence's
    token and its 3 extension bytes."""
    comp = (bytes([0x1F]) + b"a" + bytes([1, 0, 255, 255, 7])
            + bytes([0xF4, 20]) + b"b" * 35 + bytes([2, 0])
            + bytes([0x30]) + b"xyz")
    raw, err = D._decode_row(comp, len(comp), BLOCK, b"")
    assert err == 0 and len(raw) == 1 + 15 + 4 + 255 + 255 + 7 + 35 + 8 + 3
    tally = _tally(comp)
    assert (tally["sequences"], tally["extension_bytes"], tally["windows"]) == (3, 4, 0)
    assert D.schedule_steps(tally) == 7
    assert D.schedule_steps(_tally(comp, limit=10)) == 4


def test_schedule_steps_count_window_steps_by_hand():
    """40 sequences of 4 bytes (a literal, a match of 4 at offset 1), then
    the last literals (6 bytes).  The serial parse takes the first sequence
    (its read waits for the ring's first stage); the window steps then take
    8 sequences each while 64 bytes from their start lie in the row (starts
    4, 36, 68, 100), the last cut to 7 by the queue's batch of 32; the
    serial parse takes the 8 sequences from byte 128 on and the last: 4 +
    10 steps, against 41 sequences."""
    comp = (bytes([0x10]) + b"a" + bytes([1, 0])) * 40 + bytes([0x50]) + b"tail!"
    raw, err = D._decode_row(comp, len(comp), BLOCK, b"")
    assert err == 0 and raw == b"aaaaa" * 40 + b"tail!"
    tally = _tally(comp)
    assert (tally["windows"], tally["window_sequences"], tally["sequences"]) == (4, 31, 41)
    assert D.schedule_steps(tally) == 14


@pytest.mark.parametrize("quarter", range(4))
def test_schedule_steps_are_a_fraction_of_the_serial_count_on_the_mix(quarter, mix):
    """On the mix the window steps take most sequences, so the schedule's
    dependent steps are under a third of one per sequence and extension
    byte."""
    tally = _tally(mix[quarter])
    steps = D.schedule_steps(tally)
    assert steps == (tally["windows"] + tally["sequences"] - tally["window_sequences"]
                     + tally["extension_bytes"] - tally["window_extension_bytes"])
    assert 0 < 3 * steps < tally["sequences"] + tally["extension_bytes"]


@pytest.mark.parametrize("quarter", range(4))
def test_window_steps_and_copy_waves_on_the_mix(quarter, mix):
    """The window steps take most sequences of the mix (a length extension
    of more than one byte, or a sequence reaching past the window, goes to
    the serial parse), and the copy warp copies some matches side by
    side."""
    tally = []
    D.decode_rows_model(mix[quarter], BLOCK, counts=tally)
    t = tally[0]
    assert t["windows"] > 0 and t["window_sequences"] <= t["sequences"]
    assert t["window_sequences"] >= 0.9 * t["sequences"]
    assert 0 < t["alone"] <= t["sequences"]
    assert t["batches"] >= -(-t["sequences"] // D.QUEUE_BATCH)


@pytest.mark.parametrize("seed", range(4))
def test_model_matches_plain_on_flipped_rows(seed, mix):
    """Rows of the mix with one to seven flipped bits, and random rows."""
    rng = np.random.default_rng(seed)
    for k in range(6):
        row = bytearray(mix[k % 4])
        for _ in range(int(rng.integers(1, 8))):
            row[int(rng.integers(0, len(row)))] ^= 1 << int(rng.integers(0, 8))
        _held(bytes(row), BLOCK, leads=(int(rng.integers(0, 16)),))
    _held(rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(), BLOCK, leads=(5,))


@pytest.mark.parametrize("limit", [3000, 4096, 5000, 20000])
def test_a_limit_past_out_cap_stops_nothing(limit, mix):
    """A row longer than out_cap with a limit above out_cap fails at the
    sequence that would write past out_cap, as without a limit; a limit up
    to out_cap stops the row cleanly there."""
    row = mix[0]
    got = _held(row, 4096, limit=limit, leads=(2,))
    if limit <= 4096:
        assert got == (chip_smoke.make_corpus(4 * BLOCK, 4)[:limit], 0)
    else:
        assert got == D._decode_row(row, len(row), 4096, b"") and got[1] == 1
