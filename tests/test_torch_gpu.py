"""The port's kernels on the card, against their plain versions, and the
slice end to end.  Marked `gpu`: they skip without a CUDA card.  This file
imports no JAX, so that the card's machine runs it with

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lz4_tpu_torch import frame
from lz4_tpu_torch.frame.api import _scan_single_frame
from lz4_tpu_torch.ops import (
    decode, decode_stream, encode, encode_hc_passes, encode_opt, encode_stream, xxh32,
)
from lz4_tpu_torch.parallel.blocks import comp_capacity

pytestmark = pytest.mark.gpu

BLOCK = 65536


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: see the docstring)")
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("geometry", ["canonical", "dense"])
@pytest.mark.parametrize("accel", [1, 8])
def test_encode_kernel_matches_plain(geometry, accel, cuda):
    rng = np.random.default_rng(1)
    rows = chip_smoke.sample_rows(chip_smoke.make_corpus(4 << 20, 1), rng)
    bufs, lens = chip_smoke._stage(rows, BLOCK + 1024)
    before = encode.encode_blocks.launches
    got = encode.encode_blocks(bufs.to(cuda), lens.to(cuda), BLOCK, 0, accel, geometry)
    torch.cuda.synchronize()
    assert encode.encode_blocks.launches == before + 1
    _equal(got, encode.encode_blocks_plain(bufs, lens, BLOCK, 0, accel, geometry))


@pytest.mark.parametrize("out_cap", [BLOCK, 4096, 100])
def test_decode_kernel_matches_plain(out_cap, cuda):
    rng = np.random.default_rng(2)
    rows = chip_smoke.sample_rows(chip_smoke.make_corpus(4 << 20, 2), rng)
    bufs, lens = chip_smoke._stage(rows, BLOCK + 1024)
    out, clens, _ = encode.encode_blocks_plain(bufs, lens, BLOCK)
    streams = [out[i, : int(clens[i])].numpy().tobytes() for i in range(len(rows))]
    for k in range(16):
        c = bytearray(streams[k % 8])
        for _ in range(int(rng.integers(1, 6))):
            c[int(rng.integers(0, len(c)))] ^= 1 << int(rng.integers(0, 8))
        streams.append(bytes(c))
    comps, cl = chip_smoke._stage(streams, comp_capacity(BLOCK))
    before = decode.decode_blocks.launches
    got = decode.decode_blocks(comps.to(cuda), cl.to(cuda), out_cap)
    torch.cuda.synchronize()
    assert decode.decode_blocks.launches == before + 1
    _equal(got, decode.decode_blocks_plain(comps, cl, out_cap))


def test_decode_kernel_with_dictionaries(cuda):
    rng = np.random.default_rng(3)
    windows, streams, expect = [], [], []
    for k in range(16):
        w = rng.integers(0, 256, int(rng.choice([0, 5, 3000, 65536])), dtype=np.uint8)
        c, o = chip_smoke.write_stream(rng, w.tobytes(), BLOCK)
        windows.append(w.tobytes())
        streams.append(c)
        expect.append(o)
    comps, cl = chip_smoke._stage(streams, comp_capacity(BLOCK))
    dicts = torch.zeros((len(streams), 65536), dtype=torch.uint8)
    for i, w in enumerate(windows):
        if w:
            dicts[i, 65536 - len(w):] = torch.frombuffer(bytearray(w), dtype=torch.uint8)
    dl = torch.tensor([len(w) for w in windows], dtype=torch.int32)
    got = decode.decode_blocks(comps.to(cuda), cl.to(cuda), BLOCK, dicts.to(cuda), dl.to(cuda))
    torch.cuda.synchronize()
    _equal(got, decode.decode_blocks_plain(comps, cl, BLOCK, dicts, dl))
    out, lens, errs = (t.cpu() for t in got)
    for i, o in enumerate(expect):
        assert int(errs[i]) == 0
        assert out[i, : int(lens[i])].numpy().tobytes() == o


def test_frame_round_trip_on_the_card(cuda):
    data = chip_smoke.make_corpus(8 << 20, 4)
    settings = frame.EncoderSettings(chain_blocks=False, content_checksum=True)
    e0, d0 = encode.encode_blocks.launches, decode.decode_blocks.launches
    blob = frame.compress(data, settings)
    assert frame.decompress(blob) == data
    assert encode.encode_blocks.launches == e0 + 1
    assert decode.decode_blocks.launches == d0 + 1
    assert blob == frame.compress(data, settings, device="cpu")


@pytest.mark.parametrize("accel", [1, 8])
def test_stream_encode_kernel_matches_plain(accel, cuda):
    rng = np.random.default_rng(5)
    data = chip_smoke.make_corpus(8 << 20, 5)
    sizes = [0, 13, 65546, 65547, 300000, 1 << 20]
    starts = [int(rng.integers(0, len(data) - n)) for n in sizes]
    bufs, lens = chip_smoke._stage([data[a:a + n] for a, n in zip(starts, sizes)], 1 << 20)
    before = encode_stream.encode_blocks_stream.launches
    got = encode_stream.encode_blocks_stream(bufs.to(cuda), lens.to(cuda), 1 << 20, 0, accel)
    torch.cuda.synchronize()
    assert encode_stream.encode_blocks_stream.launches == before + 1
    _equal(got, encode_stream.encode_blocks_stream_plain(bufs, lens, 1 << 20, 0, accel))
    rows = [data[a:a + BLOCK] for a in starts[2:]]
    bufs, lens = chip_smoke._stage(rows, BLOCK)
    dicts = torch.zeros((len(rows), 65536), dtype=torch.uint8)
    dls = torch.tensor([0, 100, 5000, 65536], dtype=torch.int32)
    for i, (a, dl) in enumerate(zip(starts[2:], dls.tolist())):
        if dl:
            dicts[i, 65536 - dl:] = torch.frombuffer(bytearray(data[a - dl:a]), dtype=torch.uint8)
    got = encode_stream.encode_blocks_stream(
        bufs.to(cuda), lens.to(cuda), BLOCK, 0, accel, dicts.to(cuda), dls.to(cuda))
    torch.cuda.synchronize()
    _equal(got, encode_stream.encode_blocks_stream_plain(bufs, lens, BLOCK, 0, accel, dicts, dls))


def test_chain_decode_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    data = chip_smoke.with_stored_blocks(chip_smoke.make_corpus(4 << 20, 6), rng)
    blob = frame.compress(data, device="cpu")
    frames = [blob]
    for _ in range(8):
        b = bytearray(blob)
        b[int(rng.integers(20, len(b) - 10))] ^= 1 << int(rng.integers(0, 8))
        frames.append(bytes(b))
    for f in frames:
        try:
            d, blocks, _ = _scan_single_frame(f)
        except ValueError:
            continue  # a flip in the block table: the host scan refuses it
        table = torch.tensor(blocks, dtype=torch.int64).reshape(-1, 3)
        fr = torch.frombuffer(bytearray(f), dtype=torch.uint8)
        before = decode_stream.decode_chain.launches
        got = decode_stream.decode_chain(fr.to(cuda), table, d.block_size)
        torch.cuda.synchronize()
        assert decode_stream.decode_chain.launches == before + 1
        _equal(got, decode_stream.decode_chain_plain(fr, table, d.block_size))


def test_chain_decode_at_maximum_expansion_matches_plain(cuda):
    """Tiny blocks that each decode to close to 255 times their length:
    the kernel writes each inside its slot of the output, and the block
    past 64 KB fails as in the plain version."""
    blob = chip_smoke.expansion_frame()
    d, blocks, _ = _scan_single_frame(blob)
    table = torch.tensor(blocks, dtype=torch.int64).reshape(-1, 3)
    fr = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    preset = torch.full((1000,), 7, dtype=torch.uint8)
    got = decode_stream.decode_chain(fr.to(cuda), table, d.block_size, preset.to(cuda))
    torch.cuda.synchronize()
    want = decode_stream.decode_chain_plain(fr, table, d.block_size, preset)
    _equal(got, want)
    assert want[1].tolist()[1:] == [len(blocks) - 1, 1]


def _chain_case(name, dev):
    """(frame, preset dictionary or None, expected status or None)."""
    data = chip_smoke.make_corpus(4 << 20, 14)
    if name == "stored_blocks":
        body = chip_smoke.with_stored_blocks(data, np.random.default_rng(14))
        return frame.compress(body, device=dev), None, (len(body), -1, 0)
    if name == "preset_dictionary":
        part = data[1 << 20:3 << 20]
        return (chip_smoke.chained_frame(part, data[:100000], dev),
                data[:100000], (len(part), -1, 0))
    if name == "256k_blocks":
        return (frame.compress(data, frame.EncoderSettings(block_size=1 << 18),
                               device=dev), None, (len(data), -1, 0))
    if name == "expansion":
        return chip_smoke.expansion_frame(), bytes(1000), (133236, 7, 1)
    if name == "window_fault":
        return chip_smoke.window_fault_frame(), None, (108, 1, 1)
    if name == "window_fault_preset":
        return chip_smoke.window_fault_frame(), b"x", (121, -1, 0)
    if name == "short_block":
        blob, body = chip_smoke.short_block_frame(data, dev)
        return blob, None, (len(body), -1, 0)
    if name == "deep_chain":
        blob, body = chip_smoke.deep_chain_frame(8 << 20, dev)
        return blob, None, (len(body), -1, 0)
    blob = frame.compress(data[:6 * BLOCK], device=dev)  # "flipped_<seed>"
    _, blocks, _ = _scan_single_frame(blob)
    rng = np.random.default_rng(int(name.split("_")[1]))
    while True:  # a flip inside a middle block that makes it fail
        off, length, _ = blocks[int(rng.integers(1, len(blocks) - 1))]
        b = bytearray(blob)
        b[off + int(rng.integers(0, length))] ^= 1 << int(rng.integers(0, 8))
        fr, table, block_size, _ = chip_smoke.chain_inputs(bytes(b))
        if int(decode_stream.decode_chain_plain(fr, table, block_size)[1][1]) > 0:
            return bytes(b), None, None


CHAIN_CASES = ["stored_blocks", "preset_dictionary", "256k_blocks", "expansion",
               "window_fault", "window_fault_preset", "short_block",
               "deep_chain", "flipped_1", "flipped_2", "flipped_3"]


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_decode_passes_match_plain(case, cuda):
    """The chained decoder on the card: the whole kernel against the
    sequential plain version (whole buffer and status), one count per call,
    and each pass (sequence table, sizes and status after place, the index
    array after literals and after resolve) against its plain version."""
    blob, preset, status = _chain_case(case, cuda)
    fr, table, block_size, pre = chip_smoke.chain_inputs(blob, preset)
    before = decode_stream.decode_chain.launches
    got = decode_stream.decode_chain(fr.to(cuda), table, block_size,
                                     None if pre is None else pre.to(cuda))
    torch.cuda.synchronize()
    assert decode_stream.decode_chain.launches == before + 1
    want = decode_stream.decode_chain_plain(fr, table, block_size, pre)
    _equal(got, want)
    if status is not None:
        assert tuple(want[1].tolist()) == status
    errs = chip_smoke.hold_chain_passes(fr, table, block_size, pre, cuda)
    assert errs == dict.fromkeys(("parse", "place", "literals", "resolve"), 0)


def test_chained_frame_round_trip_on_the_card(cuda):
    data = chip_smoke.make_corpus(4 << 20, 7)
    settings = frame.EncoderSettings(block_checksum=True, content_checksum=True)
    e0, c0 = encode_stream.encode_blocks_stream.launches, decode_stream.decode_chain.launches
    blob = frame.compress(data, settings)
    assert frame.decompress(blob) == data
    assert encode_stream.encode_blocks_stream.launches == e0 + 1
    assert decode_stream.decode_chain.launches == c0 + 1
    assert blob == frame.compress(data, settings, device="cpu")


def _launches(level):
    """The launch counts of a level's encode, which also takes kernel B's
    rows at levels 3 and up: the three HC passes (3-9) or OPT passes (10
    and up)."""
    return [c.launches for c in chip_smoke._hc_counts(level)]


def _idle(level):
    """The launch counts a level's encode must leave alone: the serial HC
    arm's at levels 3-9, the serial OPT arm's at 10 and up."""
    return [c.launches for c in chip_smoke._hc_idle(level)]


@pytest.mark.parametrize("level", [3, 9, 10, 11, 12])
def test_hc_encode_kernel_matches_plain(level, cuda):
    """Kernel B's HC and OPT arms (on kernel D's kernel): corpus rows, the wordy regression row,
    and rows of 0, 12 and 13 bytes."""
    rng = np.random.default_rng(8)
    data = chip_smoke.make_corpus(4 << 20, 8)
    starts = [int(rng.integers(0, len(data) - BLOCK)) for _ in range(3)]
    rows = [data[a:a + BLOCK] for a in starts] + [
        chip_smoke.wordy_row(), b"", data[:12], data[:13]]
    bufs, lens = chip_smoke._stage(rows, BLOCK + 1024)
    before, idle = _launches(level), _idle(level)
    got = encode.encode_blocks(bufs.to(cuda), lens.to(cuda), BLOCK, level)
    torch.cuda.synchronize()
    assert _launches(level) == [n + 1 for n in before]
    assert _idle(level) == idle
    _equal(got, encode.encode_blocks_plain(bufs, lens, BLOCK, level))


@pytest.mark.parametrize("level", [3, 9, 10, 12])
def test_hc_stream_kernel_matches_plain(level, cuda):
    """Kernel D's HC and OPT arms: chained windows (64 KB blocks with their
    64 KB prefixes) and a 300 KB row without a prefix."""
    data = chip_smoke.make_corpus(4 << 20, 9)
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    st, offs, wl = chip_smoke.chained_windows(len(data), BLOCK)
    rows = [0, 1, 30, 63]
    before, idle = _launches(level), _idle(level)
    got = encode_stream.encode_windows(
        payload.to(cuda), st[rows], offs[rows], wl[rows], BLOCK, level)
    torch.cuda.synchronize()
    assert _launches(level) == [n + 1 for n in before]
    assert _idle(level) == idle
    _equal(got, encode_stream.encode_windows_plain(
        payload, st[rows], offs[rows], wl[rows], BLOCK, level))
    bufs, lens = chip_smoke._stage([data[1 << 20:(1 << 20) + 300000]], 300000)
    got = encode_stream.encode_blocks_stream(bufs.to(cuda), lens.to(cuda), 300000, level)
    torch.cuda.synchronize()
    _equal(got, encode_stream.encode_blocks_stream_plain(bufs, lens, 300000, level))


def _opt_rows():
    """Windows for the level 12 passes: two chained windows (64 KB blocks
    with their 64 KB prefixes), a 64 KB row of the mix, rows of 0, 12 and
    13 bytes, a 20,000-byte row of one byte and one of a 3-byte pattern."""
    data = chip_smoke.make_corpus(1 << 20, 14)
    rows = [data[700000:765536], b"", data[:12], data[:13], b"\x61" * 20000,
            (b"abc" * 7000)[:20000]]
    base = data + b"".join(rows)
    st, offs, wl = chip_smoke.chained_windows(len(data), BLOCK)
    starts, src_offs, lens = st[[3, 9]].tolist(), offs[[3, 9]].tolist(), wl[[3, 9]].tolist()
    at = len(data)
    for r in rows:
        starts.append(at)
        src_offs.append(0)
        lens.append(len(r))
        at += len(r)
    return torch.frombuffer(bytearray(base), dtype=torch.uint8), starts, src_offs, lens


def test_opt_passes_match_plain(cuda):
    """Each level 12 pass against its plain version on the kernel's own
    output of the pass before, one launch each."""
    base, st, so, ln = _opt_rows()
    before = _launches(12)
    prev = encode_opt.opt_chain(base.to(cuda), st, ln)
    matches = encode_opt.opt_matches(base.to(cuda), st, so, ln, prev)
    got = encode_opt.opt_parse(base.to(cuda), st, so, ln, prev, matches, BLOCK)
    torch.cuda.synchronize()
    assert _launches(12) == [n + 1 for n in before]
    _equal([prev], [encode_opt.opt_chain_plain(base, st, ln)])
    prev_h, matches_h = prev.cpu(), matches.cpu()
    _equal([matches], [encode_opt.opt_matches_plain(base, st, so, ln, prev_h)])
    _equal(got, encode_opt.opt_parse_plain(base, st, so, ln, prev_h, matches_h, BLOCK))
    assert int((matches_h[:, 0] < 0).sum()) > 0  # the repeats gave up


@pytest.mark.parametrize("budget", [0, 1 << 30])
def test_opt_passes_equal_the_serial_arm(budget, cuda):
    """The passes' output equals kernel D's serial OPT arm at level 12,
    with every search given up to the parse (budget 0) or none."""
    base, st, so, ln = _opt_rows()
    base_d = base.to(cuda)
    prev = encode_opt.opt_chain(base_d, st, ln)
    matches = encode_opt.opt_matches(base_d, st, so, ln, prev, budget=budget)
    got = encode_opt.opt_parse(base_d, st, so, ln, prev, matches, BLOCK)
    _equal(got, encode_stream.encode_windows_opt_serial(base_d, st, so, ln, BLOCK, 12))
    _equal(got, encode_stream.encode_windows(base_d, st, so, ln, BLOCK, 12))


@pytest.mark.parametrize("level", [10, 11])
def test_opt_spec_passes_match_plain(level, cuda):
    """Each level 10-11 pass against its plain version on the kernel's own
    output of the pass before, one launch each (the level 12 passes' rows:
    chained windows, the mix, short rows and long repeats)."""
    base, st, so, ln = _opt_rows()
    _, depth, sufficient, _ = encode_opt.level_arm(level)
    before, idle = _launches(level), _idle(level)
    prev = encode_opt.opt_chain(base.to(cuda), st, ln)
    matches = encode_opt.opt_matches(base.to(cuda), st, so, ln, prev, depth)
    got = encode_opt.opt_parse_spec(base.to(cuda), st, so, ln, prev, matches, BLOCK, depth,
                                    sufficient)
    torch.cuda.synchronize()
    assert _launches(level) == [n + 1 for n in before]
    assert _idle(level) == idle
    _equal([prev], [encode_opt.opt_chain_plain(base, st, ln)])
    prev_h, matches_h = prev.cpu(), matches.cpu()
    _equal([matches], [encode_opt.opt_matches_plain(base, st, so, ln, prev_h, depth)])
    _equal(got, encode_opt.opt_parse_spec_plain(base, st, so, ln, prev_h, matches_h, BLOCK,
                                                depth, sufficient))
    assert int((matches_h[:, 0] < 0).sum()) > 0  # the repeats gave up


@pytest.mark.parametrize("level", [10, 11])
@pytest.mark.parametrize("budget", [0, 1 << 30])
def test_opt_spec_passes_equal_the_serial_arm(level, budget, cuda):
    """The level 10-11 passes' output equals kernel D's serial OPT arm on
    256 rows of 64 KB of the mix, with every min-length-3 search given up
    to the parse (budget 0) or none, and on the level 12 passes' rows."""
    data = chip_smoke.make_corpus(16 << 20, 16)
    nb = len(data) // BLOCK
    rows = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda),
            torch.arange(nb, dtype=torch.int64) * BLOCK, torch.zeros(nb, dtype=torch.int32),
            torch.full((nb,), BLOCK, dtype=torch.int32))
    base, st, so, ln = _opt_rows()
    _, depth, sufficient, _ = encode_opt.level_arm(level)
    for b, s, o, n in (rows, (base.to(cuda), st, so, ln)):
        prev = encode_opt.opt_chain(b, s, n)
        matches = encode_opt.opt_matches(b, s, o, n, prev, depth, budget, budget)
        got = encode_opt.opt_parse_spec(b, s, o, n, prev, matches, BLOCK, depth, sufficient)
        serial0 = encode_stream.encode_windows_opt.launches
        want = encode_stream.encode_windows_opt_serial(b, s, o, n, BLOCK, level)
        assert encode_stream.encode_windows_opt.launches == serial0 + 1
        _equal(got, want)
        _equal(encode_stream.encode_windows(b, s, o, n, BLOCK, level), want)
        assert encode_stream.encode_windows_opt.launches == serial0 + 1


def test_opt_spec_passes_in_groups_match_one_group(cuda, monkeypatch):
    """The level 10 passes over a batch cut into several groups of rows
    (`encode_opt.row_groups` under a small table budget, one launch of each
    pass per group) give what one group and the serial arm give."""
    data = chip_smoke.make_corpus(1 << 20, 15)
    base = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda)
    nb = len(data) // BLOCK
    st = torch.arange(nb, dtype=torch.int64) * BLOCK
    so = torch.zeros(nb, dtype=torch.int32)
    ln = torch.full((nb,), BLOCK, dtype=torch.int32)
    whole = encode_opt.encode_windows_opt_passes(base, st, so, ln, BLOCK, 10)
    monkeypatch.setattr(encode_opt, "GROUP_TABLE_BYTES", 3 * BLOCK * encode_opt.TABLE_BYTES)
    groups = encode_opt.row_groups(ln)
    assert len(groups) == -(-nb // 3)
    before, idle = _launches(10), _idle(10)
    parts = encode_opt.encode_windows_opt_passes(base, st, so, ln, BLOCK, 10)
    torch.cuda.synchronize()
    assert _launches(10) == [n + len(groups) for n in before]
    assert _idle(10) == idle
    _equal(parts, whole)
    _equal(parts, encode_stream.encode_windows_opt_serial(base, st, so, ln, BLOCK, 10))


@pytest.mark.parametrize("level", [10, 11])
@pytest.mark.parametrize("chain", [False, True])
def test_opt_spec_paths_leave_the_serial_arm_alone(level, chain, cuda):
    """A level 10-11 frame runs the three passes and never the serial OPT
    arm (its count unchanged), with the plain route's bytes."""
    data = chip_smoke.make_corpus(1 << 18, 17)
    settings = frame.EncoderSettings(compression_level=level, chain_blocks=chain)
    before, idle = _launches(level), _idle(level)
    blob = frame.compress(data, settings)
    assert _idle(level) == idle
    assert all(n > b for n, b in zip(_launches(level), before))
    assert frame.decompress(blob) == data
    assert blob == frame.compress(data, settings, device="cpu")


def test_hc_passes_match_plain(cuda):
    """Each HC pass at level 9 against its plain version on the kernel's
    own output of the pass before, one launch each (the level 12 passes'
    rows: chained windows, the mix, short rows and long repeats)."""
    base, st, so, ln = _opt_rows()
    before = _launches(9)
    prev = encode_opt.opt_chain(base.to(cuda), st, ln)
    tables = encode_hc_passes.hc_episodes(base.to(cuda), st, so, ln, prev)
    got = encode_hc_passes.hc_parse(base.to(cuda), st, so, ln, prev, tables, BLOCK)
    torch.cuda.synchronize()
    assert _launches(9) == [n + 1 for n in before]
    prev_h, tables_h = prev.cpu(), tuple(t.cpu() for t in tables)
    _equal(tables_h, encode_hc_passes.hc_episodes_plain(base, st, so, ln, prev_h))
    _equal(got, encode_hc_passes.hc_parse_plain(base, st, so, ln, prev_h, tables_h, BLOCK))
    assert int((tables_h[0][:, 0] < -1).sum()) > 0  # the repeats gave up


@pytest.mark.parametrize("level", [3, 9])
@pytest.mark.parametrize("slots,budget", [(1, 0), (encode_hc_passes.SLOTS, 1 << 16)])
def test_hc_passes_equal_the_serial_arm(level, slots, budget, cuda):
    """The passes' output equals kernel D's serial HC arm, with every
    search made on the spot by the parse (one slot, budget 0) or read from
    the tables, and `encode_windows` runs the passes."""
    base, st, so, ln = _opt_rows()
    base_d = base.to(cuda)
    depth = 4 if level == 3 else 256
    prev = encode_opt.opt_chain(base_d, st, ln)
    tables = encode_hc_passes.hc_episodes(base_d, st, so, ln, prev, depth, slots,
                                          budget=budget, first_budget=budget)
    got = encode_hc_passes.hc_parse(base_d, st, so, ln, prev, tables, BLOCK, depth)
    serial0 = encode_stream.encode_windows_hc.launches
    want = encode_stream.encode_windows_hc_serial(base_d, st, so, ln, BLOCK, level)
    assert encode_stream.encode_windows_hc.launches == serial0 + 1
    _equal(got, want)
    _equal(encode_stream.encode_windows(base_d, st, so, ln, BLOCK, level), want)
    assert encode_stream.encode_windows_hc.launches == serial0 + 1


def test_hc_passes_in_groups_match_one_group(cuda, monkeypatch):
    """The HC passes over a batch cut into several groups of rows
    (`encode_hc_passes.row_groups` under a small table budget, one launch
    of each pass per group) give what one group and the serial arm give;
    on the card the budget is also held under half the free memory."""
    data = chip_smoke.make_corpus(1 << 20, 15)
    base = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda)
    nb = len(data) // BLOCK
    st = torch.arange(nb, dtype=torch.int64) * BLOCK
    so = torch.zeros(nb, dtype=torch.int32)
    ln = torch.full((nb,), BLOCK, dtype=torch.int32)
    whole = encode_hc_passes.encode_windows_hc_passes(base, st, so, ln, BLOCK, 9)
    free, _ = torch.cuda.mem_get_info(cuda)
    budget = encode_hc_passes.group_budget(cuda)
    assert 0 < budget <= encode_hc_passes.GROUP_TABLE_BYTES
    assert budget <= (free + torch.cuda.memory_reserved(cuda)) // 2
    monkeypatch.setattr(encode_hc_passes, "GROUP_TABLE_BYTES",
                        3 * encode_hc_passes.table_bytes(BLOCK, BLOCK))
    groups = encode_hc_passes.row_groups(so, ln, encode_hc_passes.group_budget(cuda))
    assert len(groups) == -(-nb // 3)
    before, idle = _launches(9), _idle(9)
    parts = encode_hc_passes.encode_windows_hc_passes(base, st, so, ln, BLOCK, 9)
    torch.cuda.synchronize()
    assert _launches(9) == [n + len(groups) for n in before]
    assert _idle(9) == idle
    _equal(parts, whole)
    _equal(parts, encode_stream.encode_windows_hc_serial(base, st, so, ln, BLOCK, 9))


@pytest.mark.parametrize("level", [9, 12])
@pytest.mark.parametrize("chain", [False, True])
def test_hc_frame_round_trip_on_the_card(level, chain, cuda):
    data = chip_smoke.make_corpus(1 << 20, 10)
    settings = frame.EncoderSettings(compression_level=level, chain_blocks=chain,
                                     content_checksum=True)
    blob = frame.compress(data, settings)
    assert frame.decompress(blob) == data
    assert blob == frame.compress(data, settings, device="cpu")


def test_xxh32_kernel_matches_plain(cuda):
    """Kernel E on the CPU tests' rows (noise past each length), on windows
    at every alignment of one flat tensor, and on 1,024 rows of 64 KB of
    random lengths."""
    rng = np.random.default_rng(11)
    lengths = chip_smoke.XXH_LENGTHS
    bufs = torch.from_numpy(rng.integers(0, 256, (len(lengths), 65536), dtype=np.uint8))
    lens = torch.tensor(lengths, dtype=torch.int32)
    before = xxh32.xxh32_windows.launches
    got = xxh32.xxh32_blocks(bufs.to(cuda), lens)
    torch.cuda.synchronize()
    assert xxh32.xxh32_windows.launches == before + 1
    _equal([got], [xxh32.xxh32_blocks_plain(bufs, lens)])
    flat = torch.from_numpy(rng.integers(0, 256, 300000, dtype=np.uint8))
    starts = [a + k for a in (0, 100003) for k in range(16)]
    wl = [lengths[k % len(lengths)] for k in range(len(starts))]
    got = xxh32.xxh32_windows(flat.to(cuda), starts, wl)
    _equal([got], [xxh32.xxh32_windows_plain(flat, starts, wl)])
    bufs = torch.from_numpy(rng.integers(0, 256, (1024, BLOCK + 1024), dtype=np.uint8))
    lens = torch.from_numpy(rng.integers(0, BLOCK + 1, 1024).astype(np.int32))
    _equal([xxh32.xxh32_blocks(bufs.to(cuda), lens)], [xxh32.xxh32_blocks_plain(bufs, lens)])


def test_xxh32_kernel_on_one_4mib_window(cuda):
    rng = np.random.default_rng(12)
    flat = torch.from_numpy(rng.integers(0, 256, (4 << 20) + 16, dtype=np.uint8))
    for start, n in ((0, 4 << 20), (7, 4 << 20), (13, (4 << 20) - 5)):
        got = xxh32.xxh32_windows(flat.to(cuda), [start], [n])
        _equal([got], [xxh32.xxh32_windows_plain(flat, [start], [n])])


def test_cli_default_round_trip_on_the_card(cuda):
    """`lz4`'s command-line defaults (independent 4 MB blocks, a content
    checksum) over 16 MiB: kernel E once each way; the frame of the first
    1 MiB equal to the plain route's."""
    data = chip_smoke.make_corpus(16 << 20, 13)
    settings = chip_smoke._cli_default()
    e0 = xxh32.xxh32_windows.launches
    blob = frame.compress(data, settings)
    assert xxh32.xxh32_windows.launches == e0 + 1
    assert frame.decompress(blob) == data
    assert xxh32.xxh32_windows.launches == e0 + 2
    head = data[:1 << 20]
    assert frame.compress(head, settings) == frame.compress(head, settings, device="cpu")


@pytest.mark.parametrize("sched", ["canonical", "dense"])
def test_fast_warp_scan_matches_the_batched_plain_scan(sched, cuda):
    """Kernel D's warp on the edge rows (12, 13, 65,546 and 65,547
    bytes), a 64 KB row whose probes collide in one bucket, and 1 MiB of
    zeros, against the serial and the batched plain scans."""
    data = chip_smoke.make_corpus(4 << 20, 9)
    rows = [data[:12], data[:13], data[:65546], data[1 << 20:(1 << 20) + 65547],
            chip_smoke.collision_row(BLOCK, 2), bytes(1 << 20)]
    bufs, lens = chip_smoke._stage(rows, 1 << 20)
    st = torch.arange(len(rows), dtype=torch.int64) * bufs.shape[1]
    zeros = torch.zeros(len(rows), dtype=torch.int32)
    got = encode_stream.encode_windows(bufs.reshape(-1).to(cuda), st, zeros, lens,
                                       1 << 20, fast_schedule=sched)
    torch.cuda.synchronize()
    out, clens = got[0].cpu(), got[1].cpu()
    for i, r in enumerate(rows):
        want, _ = encode.encode_row_warp(r, 1, sched)
        assert out[i, :int(clens[i])].numpy().tobytes() == bytes(want)
    _equal(got, encode_stream.encode_windows_plain(
        bufs.reshape(-1), st, zeros, lens, 1 << 20, fast_schedule=sched))


@pytest.mark.parametrize("out_cap", [BLOCK, 4 << 20])
def test_decode_passes_match_plain(out_cap, cuda):
    """Each pass of kernel A against its plain version on clean rows of
    the mix, the corrupt kinds and a zero row's long length runs; the whole
    equal to the one-warp route."""
    data = chip_smoke.make_corpus(4 << 20, 10)
    rows = [data[k << 20:(k << 20) + BLOCK] for k in range(4)] + [bytes(out_cap)]
    bufs, lens = chip_smoke._stage(rows, out_cap)
    out, clens, _ = encode_stream.encode_blocks_stream_plain(bufs, lens, out_cap)
    streams = [out[i, :int(clens[i])].numpy().tobytes() for i in range(len(rows))]
    streams += chip_smoke.corrupt_rows(streams[0])
    comps, cl = chip_smoke._stage(streams, comp_capacity(out_cap))
    errs, _ = chip_smoke.hold_rows_passes(comps, cl, out_cap, cuda)
    assert set(errs.values()) == {0}
    new, _ = decode._decode("rows", comps.to(cuda), cl.to(cuda), out_cap)
    old, _ = decode._decode("warp", comps.to(cuda), cl.to(cuda), out_cap)
    torch.cuda.synchronize()
    _equal(new, old)


def test_decode_passes_in_groups_match_one_group(cuda, monkeypatch):
    """Kernel A's passes over a batch cut into several groups of rows
    (`decode.row_groups` under a small scratch budget, the scratch reused
    from group to group) give what one group and the plain version give:
    rows of the mix, corrupt rows and dictionary rows."""
    rng = np.random.default_rng(12)
    data = chip_smoke.make_corpus(4 << 20, 12)
    out_cap = 1 << 20
    rows = [data[k << 20:(k + 1) << 20] for k in range(4)] + [bytes(out_cap)]
    bufs, lens = chip_smoke._stage(rows, out_cap)
    out, clens, _ = encode_stream.encode_blocks_stream_plain(bufs, lens, out_cap)
    streams = [out[i, :int(clens[i])].numpy().tobytes() for i in range(len(rows))]
    streams += chip_smoke.corrupt_rows(streams[0])
    comps, cl = chip_smoke._stage(streams, comp_capacity(out_cap))
    dicts = torch.from_numpy(rng.integers(0, 256, (len(streams), 65536), dtype=np.uint8))
    dls = torch.from_numpy(rng.integers(0, 65537, len(streams)).astype(np.int32))
    args = comps.to(cuda), cl.to(cuda), out_cap, dicts.to(cuda), dls.to(cuda)
    whole, _ = decode._decode("rows", *args)
    monkeypatch.setattr(decode, "GROUP_SCRATCH_BYTES", 32 << 20)
    assert len(decode.row_groups(cl, out_cap)) > 1
    before = dict(decode.kernel_launches)
    parts, _ = decode._decode("rows", *args)
    torch.cuda.synchronize()
    assert decode.kernel_launches["rows_gather"] - before["rows_gather"] == len(
        decode.row_groups(cl, out_cap))
    _equal(parts, whole)
    _equal(parts, decode.decode_blocks_plain(comps, cl, out_cap, dicts, dls))


def test_xxh32_stripes_matches_plain_at_odd_splits(cuda):
    rng = np.random.default_rng(12)
    assert chip_smoke.hold_stripes(rng, cuda) == 0


def test_decode_limits_match_plain(cuda):
    rng = np.random.default_rng(13)
    data = chip_smoke.make_corpus(4 << 20, 13)
    before = decode.kernel_launches["decode_rows_limit"]
    assert chip_smoke.hold_limited_decode(data, rng, cuda) == 0
    assert decode.kernel_launches["decode_rows_limit"] == before + 1


@pytest.mark.parametrize("chain", [False, True])
def test_streaming_round_trip_on_the_card(chain, cuda):
    import io

    data = chip_smoke.make_corpus(8 << 20, 14)
    settings = frame.EncoderSettings(chain_blocks=chain, block_checksum=True,
                                     content_checksum=True)
    before = xxh32.xxh32_stripes.launches
    blob, _, _ = chip_smoke._stream_file(data, settings, cuda)
    assert blob == frame.compress(data, settings, device=cuda)
    assert xxh32.xxh32_stripes.launches > before
    two = blob + frame.skippable_frame(b"x") + blob
    assert frame.decompress(two, device=cuda) == data + data
    r = frame.FrameReader(io.BytesIO(two), device=cuda)
    assert r.read(12345) + r.read() == data + data


def test_dense_codecs_match_their_cpu_run(cuda):
    rng = np.random.default_rng(15)
    data = chip_smoke.make_corpus(4 << 20, 15)
    assert chip_smoke.hold_dense_rows(data, rng, cuda) == {"X1": 0, "X2": 0}
    got = chip_smoke.unbounded_decodes(rng, cuda)
    assert [g["caps_tried"] for g in got] == [1, 2, 3]


def test_mesh_frame_on_the_card(cuda):
    from lz4_tpu_torch import parallel

    data = chip_smoke.make_corpus(2 << 20, 16)
    mesh = parallel.make_mesh([cuda, cuda])
    settings = frame.EncoderSettings(chain_blocks=False, block_checksum=True,
                                     content_checksum=True)
    blob = frame.compress(data, settings, mesh=mesh)
    assert frame.decompress(blob, mesh=mesh) == data
    assert blob == frame.compress(data, settings, mesh=parallel.make_mesh(["cpu", "cpu"]))


def test_continue_kernel_matches_plain_on_the_edge_frames(cuda):
    from lz4_tpu_torch.ops import encode_continue

    for bs, payloads in chip_smoke.continue_edge_frames(3):
        for p in payloads:
            payload = torch.frombuffer(bytearray(p), dtype=torch.uint8)
            nb = -(-len(p) // bs)
            steps = torch.zeros((nb, 2), dtype=torch.int32, device=cuda)
            before = encode_continue.encode_continue.launches
            got = encode_continue.encode_continue(payload.to(cuda), bs, steps=steps)
            torch.cuda.synchronize()
            assert encode_continue.encode_continue.launches == before + 1
            want_steps = torch.zeros((nb, 2), dtype=torch.int32)
            _equal(got, encode_continue.encode_continue_plain(payload, bs, steps=want_steps))
            assert torch.equal(steps.cpu(), want_steps)


def test_continue_kernel_on_a_4mib_frame(cuda):
    from lz4_tpu_torch.ops import encode_continue

    data = chip_smoke.make_corpus(4 << 20, 4)
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = encode_continue.encode_continue(payload.to(cuda), BLOCK)
    _equal(got, encode_continue.encode_continue_plain(payload, BLOCK))
    settings = frame.EncoderSettings(geometry="canonical", block_checksum=True,
                                     content_checksum=True)
    blob = frame.compress(data, settings, device=cuda)
    assert frame.decompress(blob, device=cuda) == data
    out, clens = (t.cpu() for t in got)
    for k, (off, n, stored) in enumerate(_scan_single_frame(blob)[1]):
        assert stored or blob[off:off + n] == out[k, :int(clens[k])].numpy().tobytes()


def test_hash5_rows_matches_plain(cuda):
    from lz4_tpu_torch.ops import encode_continue

    values = torch.from_numpy(chip_smoke.hash5_vectors(5))
    before = encode_continue.hash5_rows.launches
    got = encode_continue.hash5_rows(values.to(cuda))
    torch.cuda.synchronize()
    assert encode_continue.hash5_rows.launches == before + 1
    assert torch.equal(got.cpu(), encode_continue.hash5_rows_plain(values))


@pytest.mark.parametrize("name", ["xxh32_stripe", "merged_seq", "probe_step"])
def test_ubench_kernel_matches_plain(name, cuda):
    from lz4_tpu_torch.ops import ubench

    for n in (0, 1, 1000):
        acc, cycles = ubench.run(name, n, 4321, cuda)
        assert acc == ubench.plain(name, n, 4321) and cycles >= 0
