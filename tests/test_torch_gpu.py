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


def test_opt_parse_runs_the_rounds_of_its_plain_model(cuda):
    """The level 12 parse kernel (one warp per row) against the plain
    parse by rounds at 32 lanes (`opt_parse_rounds_plain` with ``full``,
    which asserts every commit against the serial loop), with the default budgets
    and with a tiny one that leaves most searches to the parse's lanes."""
    base, st, so, ln = _opt_rows()
    base_d = base.to(cuda)
    prev = encode_opt.opt_chain(base_d, st, ln)
    prev_h = prev.cpu()
    for budget in (encode_opt.MATCH_BUDGET, 24):
        matches = encode_opt.opt_matches(base_d, st, so, ln, prev, budget=budget,
                                         first_budget=budget)
        got = encode_opt.opt_parse(base_d, st, so, ln, prev, matches, BLOCK)
        counts = []
        _equal(got, encode_opt.opt_parse_rounds_plain(base, st, so, ln, prev_h, matches.cpu(),
                                                      BLOCK, 16384, 4095, True, 32, counts))
        assert all(c["steps"] <= c["serial_steps"] for c in counts if c["windows"])
    assert sum(c["searches"] for c in counts) > 0  # lanes searched on the spot


def _slice_rows():
    """Rows past one match-pass slice's reach (`encode_opt.SLICE` positions
    and 65,535 back): 150 KB of the mix across its text and records
    quarters; 124 KB: 30 KB of text, a 24 KB cut of it twice (matches of
    up to 48 KB across slice boundaries when the budget allows), 10 KB of
    one byte, 10 KB of a 3-byte pattern and 26 KB of text; and a chained
    window (a 64 KB block and its 64 KB prefix)."""
    data = chip_smoke.make_corpus(1 << 20, 18)
    q = len(data) // 4
    text = data[20000:120000]
    rows = [data[q - 75000:q + 75000],
            text[:30000] + text[40000:64000] * 2 + b"\x00" * 10000
            + (b"abc" * 4000)[:10000] + text[64000:90000]]
    base = data + b"".join(rows)
    st, offs, wl = chip_smoke.chained_windows(len(data), BLOCK)
    starts, src_offs, lens = [int(st[5])], [int(offs[5])], [int(wl[5])]
    at = len(data)
    for r in rows:
        starts.append(at)
        src_offs.append(0)
        lens.append(len(r))
        at += len(r)
    return torch.frombuffer(bytearray(base), dtype=torch.uint8), starts, src_offs, lens


def _slice_spans(n, width=48):
    """Positions around every slice boundary of a row of ``n`` positions,
    and its last 256."""
    cuts = range(encode_opt.SLICE, n, encode_opt.SLICE)
    return [(k - width, k + width) for k in cuts] + [(n - 256, n)]


def _hold_matches_on_spans(base, st, so, ln, prev, matches, depth, budget, first_budget):
    """The kernel's match table against the plain version on `_slice_spans`
    of each row (the plain search of every position would take minutes)."""
    toff, _ = encode_opt.table_offsets(ln)
    prev_h, matches_h = prev.cpu(), matches.cpu()
    held = 0
    for r in range(len(st)):
        t, n = int(toff[r]), ln[r]
        row = (base[st[r]:st[r] + n], [0], so[r:r + 1], [n])
        for p0, p1 in _slice_spans(n):
            p0 = max(p0, so[r])
            want = encode_opt.opt_matches_plain(*row, prev_h[t:t + n], depth, budget,
                                                first_budget, span=(p0, p1))
            assert torch.equal(matches_h[t + p0:t + p1], want[p0:p1]), (r, p0, p1)
            held += max(0, p1 - p0)
    return held


@pytest.mark.parametrize("level,budget", [(12, encode_opt.MATCH_BUDGET), (12, 0),
                                          (12, 1 << 30), (10, encode_opt.MATCH_BUDGET),
                                          (11, encode_opt.MATCH_BUDGET)])
def test_opt_matches_across_slices_match_plain(level, budget, cuda):
    """The match pass (one CTA per slice, its tables staged) against its
    plain version around every slice boundary of rows longer than a
    slice's reach, and the level's passes equal to the serial OPT arm: at
    levels 10-12's depths, with level 12's budgets, with every search given
    up (budget 0) and unbounded (matches longer than a slice)."""
    base, st, so, ln = _slice_rows()
    base_d = base.to(cuda)
    _, depth, sufficient, full = encode_opt.level_arm(level)
    first = min(budget, encode_opt.FIRST_BUDGET) if budget == encode_opt.MATCH_BUDGET else budget
    prev = encode_opt.opt_chain(base_d, st, ln)
    matches = encode_opt.opt_matches(base_d, st, so, ln, prev, depth, budget, first)
    assert _hold_matches_on_spans(base, st, so, ln, prev, matches, depth, budget, first) > 2000
    parse = encode_opt.opt_parse if full else encode_opt.opt_parse_spec
    got = parse(base_d, st, so, ln, prev, matches, 4 * BLOCK, depth, sufficient)
    _equal(got, encode_stream.encode_windows_opt_serial(base_d, st, so, ln, 4 * BLOCK, level))
    if budget == 1 << 30:  # a match longer than a slice, found whole
        assert int(matches[:, 0].max()) > encode_opt.SLICE


@pytest.mark.parametrize("level", [10, 11])
def test_opt_matches_on_a_4_mib_row_match_plain(level, cuda):
    """`lz4 -10` / `-11`'s rows: the match pass on a 4 MiB row of the mix
    (text, records and runs), held to its plain version around slice
    boundaries near its start (slices 4 and 5: the first whose staged
    deltas start above the row's), in its middle and at its end; the row's
    passes equal the serial OPT arm's."""
    data = chip_smoke.make_corpus(8 << 20, 19)
    n = 4 << 20
    base = torch.frombuffer(bytearray(data[n // 4:n // 4 + n]), dtype=torch.uint8)
    _, depth, sufficient, _ = encode_opt.level_arm(level)
    base_d = base.to(cuda)
    prev = encode_opt.opt_chain(base_d, [0], [n])
    matches = encode_opt.opt_matches(base_d, [0], [0], [n], prev, depth)
    _equal([prev], [encode_opt.opt_chain_plain(base, [0], [n])])
    prev_h, matches_h = prev.cpu(), matches.cpu()
    for k in (4, 5, 128, 192, n // encode_opt.SLICE):
        p0, p1 = k * encode_opt.SLICE - 64, min(n, k * encode_opt.SLICE + 64)
        want = encode_opt.opt_matches_plain(base, [0], [0], [n], prev_h, depth, span=(p0, p1))
        assert torch.equal(matches_h[p0:p1], want[p0:p1]), k
    got = encode_opt.opt_parse_spec(base_d, [0], [0], [n], prev, matches, n, depth, sufficient)
    _equal(got, encode_stream.encode_windows_opt_serial(base_d, [0], [0], [n], n, level))


@pytest.mark.parametrize("chain", [False, True])
def test_opt_passes_equal_the_serial_arm_on_the_l12_paths(chain, cuda):
    """All 256 rows of a level 12 path (16 MiB of the mix, 64 KB
    independent rows or chained windows): the passes, run by
    `encode_windows` without the serial OPT arm (its count unchanged, one
    launch of each pass), equal the serial arm's output."""
    data = chip_smoke.make_corpus(16 << 20, 20)
    nb = len(data) // BLOCK
    base = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda)
    if chain:
        st, so, ln = chip_smoke.chained_windows(len(data), BLOCK)
    else:
        st = torch.arange(nb, dtype=torch.int64) * BLOCK
        so = torch.zeros(nb, dtype=torch.int32)
        ln = torch.full((nb,), BLOCK, dtype=torch.int32)
    before, idle = _launches(12), _idle(12)
    got = encode_stream.encode_windows(base, st, so, ln, BLOCK, 12)
    torch.cuda.synchronize()
    assert _launches(12) == [b + 1 for b in before]
    assert _idle(12) == idle
    _equal(got, encode_stream.encode_windows_opt_serial(base, st, so, ln, BLOCK, 12))


@pytest.mark.parametrize("chain", [False, True])
def test_opt_l12_paths_leave_the_serial_arm_alone(chain, cuda):
    """A level 12 frame runs the three passes and never the serial OPT arm
    (its count unchanged), with the plain route's bytes."""
    data = chip_smoke.make_corpus(1 << 18, 21)
    settings = frame.EncoderSettings(compression_level=12, chain_blocks=chain)
    before, idle = _launches(12), _idle(12)
    blob = frame.compress(data, settings)
    assert _idle(12) == idle
    assert all(n > b for n, b in zip(_launches(12), before))
    assert frame.decompress(blob) == data
    assert blob == frame.compress(data, settings, device="cpu")


def test_opt_slice_is_the_kernels(cuda):
    """`encode_opt.SLICE` is the built kernel's, and a slice's staged
    deltas fit one CTA's shared memory (227 KB)."""
    assert encode_opt.slice_positions() == encode_opt.SLICE
    smem = encode_opt.shared_bytes()["opt_matches"]
    assert 2 * (65535 + encode_opt.SLICE) <= smem <= 232448


@pytest.mark.parametrize("case", range(5))
def test_opt_chain_matches_plain_at_the_segment_edges(case, cuda):
    """The chain pass (`opt_chain_walk` over segments of `CHAIN_SEGMENT`
    positions, then `opt_chain_join`) against its plain version on
    `chip_smoke.chain_edge_windows`: rows across and at the segment
    boundaries, windows starting 1, 2 and 3 mod 16 (and in a tensor at an
    odd address), a 4 MiB row of zeros, a chained window of 64 KB and a
    4 MiB block; one wrapper call each."""
    what, payload, view, st, ln = chip_smoke.chain_edge_windows(encode_opt.CHAIN_SEGMENT,
                                                                21)[case]
    before = encode_opt.opt_chain.launches
    got = encode_opt.opt_chain(payload.to(cuda)[view:], st, ln)
    torch.cuda.synchronize()
    assert encode_opt.opt_chain.launches == before + 1, what
    _equal([got], [encode_opt.opt_chain_plain(payload[view:], st, ln)])


def test_opt_chain_equals_the_sort_formulation(cuda):
    """The chain pass equals the library yardstick of `chip_smoke.py`
    (`chain_by_sort`: one stable torch.sort of row * 2^15 + hash) on
    256 chained windows of the mix."""
    data = chip_smoke.make_corpus(16 << 20, 22)
    st, _, wl = chip_smoke.chained_windows(len(data), BLOCK)
    base_d = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda)
    _equal([encode_opt.opt_chain(base_d, st, wl)], [chip_smoke.chain_by_sort(base_d, st, wl)])


def test_chain_segment_is_the_kernels(cuda):
    """`encode_opt.CHAIN_SEGMENT` is the built kernel's, and the walk's
    shared memory (the u16 head table, each position's u16 hash and u8
    code) lets two CTAs share an SM (228 KB, 1 KB of it reserved a CTA)."""
    assert encode_opt.chain_segment() == encode_opt.CHAIN_SEGMENT
    smem = encode_opt.shared_bytes()["opt_chain"]
    assert smem == 2 * encode_opt.CHAIN_HASHES + 3 * encode_opt.CHAIN_SEGMENT
    assert 2 * (smem + 1024) <= 233472
    assert encode_opt.chain_ctas_per_sm() == 2


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
    deltas = encode_hc_passes.hc_deltas(prev, ln)
    got = encode_hc_passes.hc_parse(base.to(cuda), st, so, ln, prev, deltas, BLOCK)
    torch.cuda.synchronize()
    assert _launches(9) == [n + 1 for n in before]
    prev_h, deltas_h = prev.cpu(), deltas.cpu()
    _equal([deltas_h], [encode_hc_passes.deltas_plain(prev_h, ln)])
    _equal(got, encode_hc_passes.hc_parse_plain(base, st, so, ln, prev_h, deltas_h, BLOCK))


def _segment_parse(model: str, cuda, rows, **kw):
    """The parse by segments (`hc_parse` at level 9, `opt_parse_spec` at
    level 10) on the card with ``kw``, the plain parse's bytes, the model's
    (`hc_parse_segments_plain`, `opt_parse_segments_plain`) and its
    tallies, and the launch's counts (`encode_opt.segment_stats`)."""
    base, st, so, ln = rows
    base_d = base.to(cuda)
    bcap = max(int(n) - int(o) for o, n in zip(so, ln))
    prev = encode_opt.opt_chain(base_d, st, ln)
    rounds = kw.get("max_rounds", encode_opt.SEGMENT_ROUNDS)
    counts = []
    if model == "hc":
        sizes = (kw.get("segment", encode_hc_passes.HC_SEGMENT),
                 kw.get("overlap", encode_hc_passes.HC_OVERLAP), rounds)
        deltas = encode_hc_passes.hc_deltas(prev, ln)
        got = encode_hc_passes.hc_parse(base_d, st, so, ln, prev, deltas, bcap, 256, **kw)
        stats = encode_opt.segment_stats(encode_hc_passes.hc_parse.stats, rounds)
        args = base, st, so, ln, prev.cpu(), deltas.cpu(), bcap, 256
        want = encode_hc_passes.hc_parse_plain(*args)
        mine = encode_hc_passes.hc_parse_segments_plain(*args, *sizes, counts)
    else:
        sizes = (kw.get("segment", encode_opt.OPT_SEGMENT),
                 kw.get("overlap", encode_opt.OPT_OVERLAP), rounds)
        matches = encode_opt.opt_matches(base_d, st, so, ln, prev, 96)
        got = encode_opt.opt_parse_spec(base_d, st, so, ln, prev, matches, bcap, 96, 64, **kw)
        stats = encode_opt.segment_stats(encode_opt.opt_parse_spec.stats, rounds)
        args = base, st, so, ln, prev.cpu(), matches.cpu(), bcap, 96, 64
        want = encode_opt.opt_parse_spec_plain(*args)
        mine = encode_opt.opt_parse_segments_plain(*args, *sizes, counts=counts)
    torch.cuda.synchronize()
    return got, want, mine, counts, stats


def _mix_rows(n: int, rows: int = 4):
    """``rows`` rows of ``n`` bytes, one from each quarter of the mix, one
    of random bytes (no match: its walks after the first emit nothing) and
    one of random bytes with a 24-byte repeat every ~2,300 positions (walks
    that open a window among walks that do not)."""
    data = chip_smoke.make_corpus(1 << 20, 21)
    q = len(data) // 4
    picked = [data[k * q + 777:k * q + 777 + n] for k in range(rows)]
    picked.append(np.random.default_rng(22).integers(0, 256, n, dtype=np.uint8).tobytes())
    planted = bytearray(np.random.default_rng(23).integers(0, 256, n, dtype=np.uint8))
    for at in range(2500, n - 24, 2300):
        planted[at:at + 24] = planted[at - 1900:at - 1876]
    picked.append(bytes(planted))
    rows += 2
    return (torch.frombuffer(bytearray(b"".join(picked)), dtype=torch.uint8),
            [k * n for k in range(rows)], [0] * rows, [n] * rows)


@pytest.mark.parametrize("model", ["hc", "opt"])
@pytest.mark.parametrize("rounds", [0, 1, 2, encode_opt.SEGMENT_ROUNDS])
def test_segment_parse_walks_again_as_its_model(model, rounds, cuda):
    """An overlap too short to meet (4 positions past segments of 2,048):
    segments are walked again, in the rounds and the serial tail (no
    round: the tail walks every segment); the bytes are the plain parse's
    and the model's, and each round's walks and the tail's the model's."""
    kw = dict(segment=2048, overlap=4, max_rounds=rounds)
    got, want, mine, counts, stats = _segment_parse(model, cuda, _mix_rows(32768), **kw)
    _equal(got, want)
    _equal(got, mine)
    assert stats["walks_per_round"] == [
        sum(c["walks_per_round"][r] for c in counts if r < c["rounds"]) for r in range(rounds)]
    assert stats["tail_walks"] == sum(c["tail_walks"] for c in counts)
    assert sum(c["rewalks"] for c in counts) > 0 or rounds == 0
    assert stats["overflow"] == stats["links_behind_frontier"] == 0


@pytest.mark.parametrize("model", ["hc", "opt"])
def test_segment_parse_spans_segments_at_its_sizes(model, cuda):
    """The kernels' own segment and overlap on rows of 4 and a half
    segments and on the level 12 passes' rows: the plain parse's bytes and
    the model's, in one round on the mix."""
    size = encode_hc_passes.HC_SEGMENT if model == "hc" else encode_opt.OPT_SEGMENT
    assert (encode_hc_passes.parse_segment() if model == "hc" else encode_opt.parse_segment()) \
        == ((encode_hc_passes.HC_SEGMENT, encode_hc_passes.HC_OVERLAP) if model == "hc"
            else (encode_opt.OPT_SEGMENT, encode_opt.OPT_OVERLAP))
    got, want, mine, counts, stats = _segment_parse(model, cuda, _mix_rows(4 * size + size // 2))
    _equal(got, want)
    _equal(got, mine)
    assert [c["segments"] for c in counts] == [5] * 6
    assert stats["walks_per_round"][0] == 30 and stats["links"] == 24
    got, want, _, _, _ = _segment_parse(model, cuda, _opt_rows())
    _equal(got, want)


@pytest.mark.parametrize("level", [3, 9])
@pytest.mark.parametrize("segment", [encode_hc_passes.HC_SEGMENT, 64])
def test_hc_passes_equal_the_serial_arm(level, segment, cuda):
    """The passes' output equals kernel D's serial HC arm, at the kernel's
    segments and at segments of 64 positions (many walks a row, each
    searching on the spot from its guessed start), and `encode_windows`
    runs the passes."""
    base, st, so, ln = _opt_rows()
    base_d = base.to(cuda)
    depth = 4 if level == 3 else 256
    prev = encode_opt.opt_chain(base_d, st, ln)
    deltas = encode_hc_passes.hc_deltas(prev, ln)
    got = encode_hc_passes.hc_parse(base_d, st, so, ln, prev, deltas, BLOCK, depth,
                                    segment=segment, overlap=segment // 4)
    serial0 = encode_stream.encode_windows_hc.launches
    want = encode_stream.encode_windows_hc_serial(base_d, st, so, ln, BLOCK, level)
    assert encode_stream.encode_windows_hc.launches == serial0 + 1
    _equal(got, want)
    _equal(encode_stream.encode_windows(base_d, st, so, ln, BLOCK, level), want)
    assert encode_stream.encode_windows_hc.launches == serial0 + 1


def test_hc_passes_in_groups_match_one_group(cuda, monkeypatch):
    """The HC passes over a batch cut into several groups of rows
    (`encode_opt.row_groups` under a small table budget, one launch of each
    pass per group) give what one group and the serial arm give."""
    data = chip_smoke.make_corpus(1 << 20, 15)
    base = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda)
    nb = len(data) // BLOCK
    st = torch.arange(nb, dtype=torch.int64) * BLOCK
    so = torch.zeros(nb, dtype=torch.int32)
    ln = torch.full((nb,), BLOCK, dtype=torch.int32)
    whole = encode_hc_passes.encode_windows_hc_passes(base, st, so, ln, BLOCK, 9)
    monkeypatch.setattr(encode_opt, "GROUP_TABLE_BYTES", 3 * BLOCK * encode_opt.TABLE_BYTES)
    groups = encode_opt.row_groups(ln)
    assert len(groups) == -(-nb // 3)
    before, idle = _launches(9), _idle(9)
    parts = encode_hc_passes.encode_windows_hc_passes(base, st, so, ln, BLOCK, 9)
    torch.cuda.synchronize()
    assert _launches(9) == [n + len(groups) for n in before]
    assert _idle(9) == idle
    _equal(parts, whole)
    _equal(parts, encode_stream.encode_windows_hc_serial(base, st, so, ln, BLOCK, 9))


def test_hc_parse_of_long_repeats_on_the_card(cuda):
    """4 MiB of zeros and 4 MiB of a 3-byte pattern at level 9: every
    walk's measures stop a segment past its stop, so the repeat is
    measured in full once, in the second round, by the walk from the first
    one's end, which covers the row (and by the row's last walks, whose
    caps lie past its end); the serial arm's bytes."""
    n = 4 << 20
    base = torch.cat([torch.zeros(n, dtype=torch.uint8),
                      torch.tensor(list(b"abc") * (n // 3 + 1), dtype=torch.uint8)[:n]]).to(cuda)
    st, so, ln = [0, n], [0, 0], [n, n]
    prev = encode_opt.opt_chain(base, st, ln)
    got = encode_hc_passes.hc_parse(base, st, so, ln, prev, encode_hc_passes.hc_deltas(prev, ln),
                                    n)
    stats = encode_opt.segment_stats(encode_hc_passes.hc_parse.stats, encode_opt.SEGMENT_ROUNDS)
    _equal(got, encode_stream.encode_windows_hc_serial(base, st, so, ln, n, 9))
    assert stats["rounds"] == 2 and stats["tail_walks"] == 0 and stats["overflow"] == 0
    assert 0 < stats["walks_per_round"][1] < 2 * (n // encode_hc_passes.HC_SEGMENT)


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


# window lengths across the ring's stage (256 bytes) and ring (8 KB) edges
XXH_EDGE_LENGTHS = sorted(set(range(4098)) | {
    m * 2048 + d for m in range(1, 33) for d in (-1, 0, 1)} | {
    m * 8192 + d for m in range(1, 9) for d in (-1, 0, 1)})


def test_xxh32_kernel_at_every_start_and_stage_edge(cuda):
    """Kernel E against its plain version, and its streaming form
    (`stripes_update`) against its CPU route, on windows at every start
    mod 16 (eight windows a warp: neighbours of other alignments share it)
    and lengths 0-4,097 and 2 KB and 8 KB multiples +-1."""
    rng = np.random.default_rng(31)
    flat = torch.from_numpy(rng.integers(0, 256, 400000, dtype=np.uint8))
    lens = [n for n in XXH_EDGE_LENGTHS for _ in range(16)]
    starts = [int(rng.integers(0, 4000)) * 16 + k % 16 for k in range(len(lens))]
    before = xxh32.xxh32_windows.launches
    got = xxh32.xxh32_windows(flat.to(cuda), starts, lens)
    torch.cuda.synchronize()
    assert xxh32.xxh32_windows.launches == before + 1
    _equal([got], [xxh32.xxh32_windows_plain(flat, starts, lens)])
    flat_d = flat.to(cuda)
    for a in range(16):
        for n in (0, 15, 16, 255, 256, 257, 4097, 8191, 8193, 65537):
            accs = [int(x) for x in rng.integers(0, 1 << 32, 4, dtype=np.uint64)]
            card, cpu = chip_smoke.stripes_update_both(flat, flat_d, 1000 + a, n, b"", accs)
            assert card == cpu


def test_xxh32_kernel_on_one_64mib_window(cuda):
    data = chip_smoke.make_corpus(64 << 20, 32)
    flat = torch.frombuffer(bytearray(data + bytes(16)), dtype=torch.uint8)
    flat_d = flat.to(cuda)
    for start, n in ((0, 64 << 20), (3, (64 << 20) - 7)):
        got = xxh32.xxh32_windows(flat_d, [start], [n])
        _equal([got], [xxh32.xxh32_windows_plain(flat, [start], [n])])


def test_xxh32_stream_of_1000_odd_updates_stays_on_the_card(cuda):
    """XXH32 over 1,000 tensor updates of odd sizes, seeded, after a bytes
    update: its digest equal to the plain stripes' over the same pieces on
    the CPU route and to the one-shot hash; every update one launch of the
    streaming form on the side stream, the host's stripe loop never run
    until a bytes update follows."""
    import importlib

    host = importlib.import_module("lz4_tpu_torch.xxh32")
    rng = np.random.default_rng(33)
    sizes = [int(n) | 1 for n in rng.integers(1, 9000, 1000)]
    raw = rng.integers(0, 256, sum(sizes) + 7, dtype=np.uint8)
    flat = torch.from_numpy(raw)
    flat_d = flat.to(cuda)
    ours, plain = host.XXH32(seed=12345), host.XXH32(seed=12345)
    for h in (ours, plain):
        h.update(raw[:7].tobytes())
    s0, h0 = xxh32.stripes_update.launches, host.host_stripes.launches
    pos = 7
    for n in sizes:
        ours.update(flat_d[pos:pos + n])
        plain.update(flat[pos:pos + n])
        pos += n
    assert xxh32.stripes_update.launches == s0 + len(sizes)
    assert host.host_stripes.launches == h0
    assert ours.digest() == plain.digest() == host.xxh32(raw.tobytes(), seed=12345)
    ours.update(raw[:33].tobytes())  # a bytes update reads the state back
    plain.update(raw[:33].tobytes())
    assert ours.digest() == plain.digest()


CHECKSUMMED = {
    "cli_default": dict(chain_blocks=False, block_size=4 << 20, content_checksum=True),
    "independent_both": dict(chain_blocks=False, block_checksum=True, content_checksum=True),
    "chained_both": dict(block_checksum=True, content_checksum=True),
}


@pytest.mark.parametrize("name", sorted(CHECKSUMMED))
def test_checksummed_frames_with_work_queued_on_the_current_stream(name, cuda):
    """Checksummed frames made and read while the current stream is kept
    busy before and after each call (a sleep, and the freed payload's
    memory overwritten): every content hash runs on the side stream, so the
    frames equal the CPU route's and the round trips are exact; the same
    through `LZ4FrameFile` in 1 MiB writes and reads."""
    import io

    data = chip_smoke.make_corpus(8 << 20, 34)
    settings = frame.EncoderSettings(**CHECKSUMMED[name])
    want = frame.compress(data, settings, device="cpu")
    for _ in range(3):
        torch.cuda._sleep(50_000_000)
        blob = frame.compress(data, settings)
        torch.full((len(data),), 0xFF, dtype=torch.uint8, device=cuda)
        assert blob == want
        torch.cuda._sleep(50_000_000)
        assert frame.decompress(blob) == data
        torch.full((len(data),), 0xFF, dtype=torch.uint8, device=cuda)
    sink = io.BytesIO()
    with frame.LZ4FrameFile(sink, "wb", settings=settings, close_inner=False) as f:
        for a in range(0, len(data), 1 << 20):
            torch.cuda._sleep(5_000_000)
            f.write(data[a:a + (1 << 20)])
    assert sink.getvalue() == want
    back = bytearray()
    with frame.LZ4FrameFile(io.BytesIO(sink.getvalue()), "rb") as f:
        while chunk := f.read(1 << 20):
            torch.cuda._sleep(5_000_000)
            back += chunk
    assert bytes(back) == data


@pytest.mark.parametrize("chain", [False, True], ids=["independent", "chained"])
def test_corrupt_content_checksum_raises_on_the_card(chain, cuda):
    """A flipped content checksum raises the content checksum fault before
    any byte comes back, also when the header's content length is false
    too, one-shot and through the reader; the same as the CPU route."""
    import io
    import struct

    from lz4_tpu_torch.frame.header import LZ4FormatError

    data = chip_smoke.make_corpus(1 << 20, 35)
    settings = frame.EncoderSettings(chain_blocks=chain, content_checksum=True,
                                     content_length=len(data))
    blob = bytearray(frame.compress(data, settings))
    blob[-1] ^= 0x10
    lying = chip_smoke.with_content_length(bytes(blob), len(data) - 1)
    for bad in (bytes(blob), lying):
        for device in ("cuda", "cpu"):
            with pytest.raises(LZ4FormatError, match="^content checksum mismatch$"):
                frame.decompress(bad, device=device)
        with pytest.raises(LZ4FormatError, match="content checksum mismatch"):
            frame.LZ4FrameFile(io.BytesIO(bad), "rb").read()
    assert struct.unpack_from("<Q", lying, 6)[0] == len(data) - 1


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


def test_decode_rows_edges_match_plain(cuda):
    """The one-warp route on its edge rows (`chip_smoke.warp_edge_batches`:
    offsets 1-40 and dictionary reach, limits on the edges, compress_bound,
    out_cap 16/1,000/65,535, 0 and 1 byte, the corrupt kinds, 1 MiB
    out_cap), rows 1-15 bytes into their chunks: the whole output equal to
    the plain version."""
    assert chip_smoke.hold_warp_edges(cuda, 17) == 0


@pytest.mark.parametrize("rows", [1, 4, 16, 64, 256])
@pytest.mark.parametrize("with_dict", [False, True])
def test_decode_routes_agree_and_the_rule_picks_one(rows, with_dict, cuda):
    """Both routes give the same output at the route rule's row counts (64
    KB rows spread over the mix, with the 64 KB before each as its
    dictionary), and `decode_blocks` launches the route `decode.route`
    gives."""
    data = chip_smoke.make_corpus(32 << 20, 21)
    nb = len(data) // BLOCK
    picks = [1 + k * (nb - 1) // rows for k in range(rows)]
    view = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(nb, BLOCK)
    bufs = torch.zeros((rows, BLOCK + 1024), dtype=torch.uint8)
    bufs[:, :BLOCK] = view[picks]
    lens = torch.full((rows,), BLOCK, dtype=torch.int32)
    dicts = dls = None
    if with_dict:
        dicts = view[[p - 1 for p in picks]].contiguous().to(cuda)
        dls = torch.full((rows,), BLOCK, dtype=torch.int32, device=cuda)
    out, clens, _ = encode_stream.encode_blocks_stream(
        bufs.to(cuda), lens.to(cuda), BLOCK, dicts=dicts, dict_lens=dls)
    comps = torch.zeros((rows, comp_capacity(BLOCK)), dtype=torch.uint8, device=cuda)
    comps[:, :out.shape[1]] = out
    warp, _ = decode._decode("warp", comps, clens, BLOCK, dicts, dls)
    passes, _ = decode._decode("rows", comps, clens, BLOCK, dicts, dls)
    torch.cuda.synchronize()
    _equal(warp, passes)
    assert torch.equal(warp[0].cpu(), bufs[:, :BLOCK]) and not bool(warp[2].any())
    before = dict(decode.kernel_launches)
    decode.decode_blocks(comps, clens, BLOCK, dicts, dls)
    ran = {k: decode.kernel_launches[k] - before[k] for k in ("decode_rows", "rows_gather")}
    want = decode.route(rows, BLOCK)
    assert ran == {"decode_rows": int(want == "warp"), "rows_gather": int(want == "rows")}


def test_decode_routes_agree_above_64kb_where_the_rule_picks_warp(cuda):
    """The rule's one-warp batches above 64 KB (128 rows of 128 KB, 256 of
    256 KB): `decode_blocks` launches the one-warp route, whose whole
    output equals the passes', the raw rows and the plain version's."""
    held = chip_smoke.hold_route_rule_rows(chip_smoke.make_corpus(32 << 20, 23), cuda,
                                           timed=False)
    assert sorted(held) == ["128 x 128 KB", "256 x 256 KB"]
    assert all(v["max_abs_err"] == 0 for v in held.values())


def test_decode_rows_on_each_card():
    """The one-warp route at out_cap 64 KB (its shared memory above the
    default 48 KB) on every card of the host in turn, in one process: each
    launch sets its attributes on its own device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    rng = np.random.default_rng(5)
    rows = chip_smoke.sample_rows(chip_smoke.make_corpus(4 << 20, 5), rng)
    bufs, lens = chip_smoke._stage(rows, BLOCK + 1024)
    out, clens, _ = encode.encode_blocks_plain(bufs, lens, BLOCK)
    comps = torch.zeros((len(rows), comp_capacity(BLOCK)), dtype=torch.uint8)
    comps[:, :out.shape[1]] = out
    want = decode.decode_blocks_plain(comps, clens, BLOCK)
    for k in range(torch.cuda.device_count()):
        dev = torch.device("cuda", k)
        got = decode._launch_warp(comps.to(dev), clens.to(dev), BLOCK, None, None)
        torch.cuda.synchronize(dev)
        _equal(got, want)


def test_decode_rows_shared_memory_is_the_models(cuda):
    """The built kernel's constants and shared memory: output in shared
    memory up to SHARED_OUT."""
    assert decode.shared_out() == decode.SHARED_OUT
    head = decode.warp_shared_bytes(0)
    assert decode.warp_shared_bytes(BLOCK) == head + BLOCK
    assert decode.warp_shared_bytes(1 << 20) == head - 16


@pytest.mark.parametrize("chain", [False, True])
def test_streaming_round_trip_on_the_card(chain, cuda):
    import io

    data = chip_smoke.make_corpus(8 << 20, 14)
    settings = frame.EncoderSettings(chain_blocks=chain, block_checksum=True,
                                     content_checksum=True)
    before = xxh32.stripes_update.launches
    blob, _, _ = chip_smoke._stream_file(data, settings, cuda)
    assert blob == frame.compress(data, settings, device=cuda)
    assert xxh32.stripes_update.launches > before
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


@pytest.mark.parametrize("bs,cap,window", [
    (BLOCK, None, None), (BLOCK, 32, None), (BLOCK, 1, None), (BLOCK, 0, None),
    (16384, None, None), (4096, 2, None), (4 * BLOCK, 1, None), (BLOCK, 32, 5),
    (4096, None, 7)])
def test_continue_rounds_match_their_model(bs, cap, window, cuda, monkeypatch):
    """Kernel F's rounds on 1 MiB of the mix (every quarter) as its CPU
    model makes them, in windows of ``window`` blocks (None: as they are):
    the bytes, the rounds, the blocks walked in each, where the serial
    tail began and each block's walks."""
    from lz4_tpu_torch.ops import encode_continue

    if window:
        monkeypatch.setattr(encode_continue, "WINDOW_BLOCKS", window)
    data = chip_smoke.make_corpus(1 << 20, 6)
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got: dict = {}
    want: dict = {}
    rows = chip_smoke._continue_rows(*encode_continue.encode_continue(
        payload.to(cuda), bs, max_rounds=cap, stats=got))
    assert rows == encode_continue.continue_blocks_rounds(data, bs, max_rounds=cap, stats=want)
    assert got == want
    assert rows == encode_continue.continue_blocks_plain(data, bs)


@pytest.mark.parametrize("bs", [BLOCK, 4 * BLOCK])
@pytest.mark.parametrize("lead", [1, 3])
def test_continue_kernel_on_an_unaligned_view(bs, lead, cuda):
    """Kernel F on a payload that starts ``lead`` bytes into its tensor
    (a view, as a slice on the card gives it): staged walks (64 KB blocks)
    and walks from the payload (256 KB), through the wrapper and the
    public blocks API, against the serial plain version."""
    from lz4_tpu_torch.ops import encode_continue
    from lz4_tpu_torch.parallel import blocks

    data = chip_smoke.make_corpus(1 << 20, 8)
    whole = torch.frombuffer(bytearray(bytes(lead) + data), dtype=torch.uint8).to(cuda)
    view = whole[lead:]
    assert view.data_ptr() % 4 == lead
    want = encode_continue.continue_blocks_plain(data, bs)
    assert chip_smoke._continue_rows(*encode_continue.encode_continue(view, bs)) == want
    assert blocks.encode_blocks_continue_device(view, bs, device=cuda) == want


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
