"""The chained decoder's parallel design on the CPU: each pass's plain
version (`chain_parse_plain`, `chain_place_plain`, `chain_literals_plain`,
`chain_resolve_plain`) and their composition `decode_chain_parallel_plain`
against the sequential plain version `decode_chain_plain`, and on small
frames against the JAX package's chained decode (kernel C once per block,
the 64 KB window carried on the host; Pallas in interpret mode).  Every
comparison is exact: the whole buffer, the status."""

import functools
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.experimental import pallas as pl

from lz4_tpu.ops import decode_pallas_stream as JDS
from lz4_tpu_torch.frame.api import _scan_single_frame
from lz4_tpu_torch.ops import decode_stream as DS

import bench
import chip_smoke
from test_torch_chain import _flip, _jax_chain_decode, _jax_chained

CORPUS = bench.make_corpus(1 << 20, seed=21)
WINDOW = DS.WINDOW


@pytest.fixture(scope="module")
def interpret():
    """Pallas in interpret mode for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            pl, "pallas_call",
            functools.partial(pl.pallas_call, interpret=True),
        )
        JDS.pallas_decode_stream.clear_cache()
        yield
        JDS.pallas_decode_stream.clear_cache()


def _flipped(seed):
    """A frame of five 64 KB blocks with one flipped byte that makes a
    middle block fail."""
    blob = _jax_chained(CORPUS[:5 * 65536])
    rng = random.Random(seed)
    while True:
        bad = _flip(blob, rng)
        status = DS.decode_chain_plain(*_inputs(bad))[1]
        if 0 < int(status[1]) < 4:
            return bad


def _case(name):
    """(frame, preset dictionary)."""
    if name == "stored_blocks":
        rng = random.Random(5)
        data = CORPUS[:100000] + rng.randbytes(140000) + CORPUS[200000:260000]
        return _jax_chained(data), b""
    if name == "preset_dictionary":
        preset = CORPUS[600000:700000]
        return _jax_chained(CORPUS[:150000], preset), preset
    if name == "256k_blocks":
        return _jax_chained(CORPUS[:700000], block_size=1 << 18), b""
    if name == "expansion":
        return chip_smoke.expansion_frame(), CORPUS[:1000]
    if name == "window_fault":
        return chip_smoke.window_fault_frame(), b""
    if name == "window_fault_preset":
        return chip_smoke.window_fault_frame(), b"x"
    if name == "short_block":
        return chip_smoke.short_block_frame(CORPUS, "cpu")[0], b""
    if name == "deep_chain":
        return chip_smoke.deep_chain_frame(2 << 20, "cpu")[0], b""
    if name == "densest":
        return chip_smoke.densest_frame(), b""
    return _flipped(int(name.split("_")[1])), b""  # "flipped_<seed>"


CASES = ["stored_blocks", "preset_dictionary", "256k_blocks", "expansion",
         "window_fault", "window_fault_preset", "short_block", "deep_chain",
         "densest", "flipped_1", "flipped_2", "flipped_3"]
# the cases whose status is known up front: (written, bad, err)
STATUS = {"expansion": (133236, 7, 1), "window_fault": (108, 1, 1),
          "window_fault_preset": (121, -1, 0), "densest": (128010, -1, 0)}


def _inputs(blob, preset=b""):
    return chip_smoke.chain_inputs(blob, preset or None)


@functools.lru_cache(maxsize=None)
def _sequential(name):
    blob, preset = _case(name)
    stream, status = DS.decode_chain_plain(*_inputs(blob, preset))
    return blob, preset, stream, status


@pytest.mark.parametrize("name", CASES)
def test_plain_passes_compose_to_the_sequential_decoder(name):
    blob, preset, stream, status = _sequential(name)
    got = DS.decode_chain_parallel_plain(*_inputs(blob, preset))
    assert torch.equal(got[0], stream) and torch.equal(got[1], status)
    if name in STATUS:
        assert tuple(status.tolist()) == STATUS[name]
    if name.startswith("flipped"):
        assert 0 < int(status[1]) < 4  # a middle block fails
    # the CPU route of decode_chain stays the sequential version
    assert torch.equal(DS.decode_chain(*_inputs(blob, preset))[1], status)


def _replay(blob, table, preset, seqs, sbase, nseq, err):
    """The parse's sequence table applied in order, one byte at a time,
    with the window check of a sequential decoder: (bytes, status)."""
    out = bytearray(preset[-WINDOW:])
    head = len(out)
    for k, (off, length, stored) in enumerate(table.tolist()):
        if stored:
            out += blob[off:off + length]
            continue
        for i in range(int(nseq[k])):
            lit, ll, op, moff, ml = seqs[int(sbase[k]) + i].tolist()
            at = len(out)
            if ml and moff > at + ll:  # the window: all of out before here
                return bytes(out[head:at]), (at - head, k, 1)
            out += blob[off + lit:off + lit + ll]
            for _ in range(ml):
                out.append(out[-moff])
        if int(err[k]):
            return bytes(out[head:]), (len(out) - head, k, int(err[k]))
    return bytes(out[head:]), (len(out) - head, -1, 0)


@pytest.mark.parametrize("name", CASES)
def test_each_plain_pass_against_the_sequential_decoder(name):
    blob, preset, stream, status = _sequential(name)
    fr, table, block_size, _ = _inputs(blob, preset)
    written = int(status[0])
    # parse: its rows, replayed in order, are the sequential decode
    seqs, nseq, size, err = DS.chain_parse_plain(fr, table, block_size)
    sbase, nrows = DS.chain_layout(table)
    assert bool((nseq.to(torch.int64) <= torch.where(
        table[:, 2] != 0, 0, table[:, 1] // 3 + 1)).all())
    data, replay_status = _replay(blob, table, preset, seqs, sbase, nseq, err)
    assert replay_status == tuple(status.tolist())
    assert data == stream[:written].numpy().tobytes()
    # place: the starts are the blocks' positions in the sequential output,
    # and the status is its status
    start, use, pstatus = DS.chain_place_plain(
        table, seqs, nseq, size, err, len(preset))
    assert torch.equal(pstatus, status)
    last = int(status[1]) if int(status[1]) >= 0 else table.shape[0] - 1
    assert torch.equal(start[:last + 1], torch.cumsum(size, 0)[:last + 1] - size[:last + 1])
    assert int(use[last + 1:].sum()) == 0
    # literals: each literal byte holds the sequential byte, each match
    # byte points at a byte the sequential decode made equal to it
    cap = stream.numel()
    out, ptr = DS.chain_literals_plain(fr, table, seqs, start, use, preset, cap)
    full = torch.zeros((WINDOW + cap,), dtype=torch.uint8)
    if preset:
        full[WINDOW - len(preset[-WINDOW:]):WINDOW] = torch.frombuffer(
            bytearray(preset[-WINDOW:]), dtype=torch.uint8)
    full[WINDOW:] = stream
    own = ptr[:written] == torch.arange(WINDOW, WINDOW + written)
    assert torch.equal(out[WINDOW:WINDOW + written][own], stream[:written][own])
    assert bool((ptr[:written] < torch.arange(WINDOW, WINDOW + written))[~own].all())
    assert torch.equal(full[ptr[:written]], stream[:written])
    assert not bool(out[WINDOW + written:].any())
    # resolve: every entry ends on a literal, stored or prefix byte, and
    # the buffer is the sequential decode
    rout, rptr = DS.chain_resolve_plain(out, ptr, status)
    roots = rptr[:written]
    final = (roots < WINDOW) | (ptr[(roots - WINDOW).clamp(min=0)] == roots)
    assert bool(final.all())
    assert torch.equal(rout[WINDOW:], stream)


JAX_CASES = ["preset_dictionary", "expansion", "window_fault",
             "window_fault_preset", "short_block", "flipped_1"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_parallel_decoder_matches_the_jax_chained_decode(name, interpret):
    blob, preset, _, _ = _sequential(name)
    stream, status = DS.decode_chain_parallel_plain(*_inputs(blob, preset))
    written, bad, err = status.tolist()
    assert (stream[:written].numpy().tobytes(), bad, err) == \
        _jax_chain_decode(blob, preset)


SOURCES = [CORPUS[:300000], b"ab" * 50000, bytes(range(256)) * 600,
           np.random.default_rng(3).integers(0, 4, 250000, dtype=np.uint8).tobytes()]


@settings(max_examples=40, deadline=None)
@given(src=st.integers(0, len(SOURCES) - 1), start=st.integers(0, 40000),
       size=st.integers(0, 200000), preset_len=st.sampled_from([0, 1, 700, 70000]),
       flips=st.lists(st.integers(0, 1 << 30), max_size=3))
def test_random_chained_frames_and_flips(src, start, size, preset_len, flips):
    """Random chained frames (with and without a preset dictionary) and
    random flipped bytes: the plain parallel decoder is the sequential
    one."""
    data = SOURCES[src][start:start + size]
    preset = CORPUS[500000:500000 + preset_len]
    blob = bytearray(_jax_chained(data, preset))
    _, blocks, _ = _scan_single_frame(bytes(blob))
    for f in flips:
        if blocks:
            off, length, _ = blocks[f % len(blocks)]
            if length:
                blob[off + (f >> 3) % length] ^= 1 << (f & 7)
    args = _inputs(bytes(blob), preset)
    want = DS.decode_chain_plain(*args)
    got = DS.decode_chain_parallel_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if not flips:
        assert want[0][:int(want[1][0])].numpy().tobytes() == data
