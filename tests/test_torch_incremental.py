"""The port's incremental encoders and decoders on the CPU, held to
`lz4_tpu.block.incremental` (backend "host"): the same blocks from the
same history, the window carried and capped at 64 KB, stored blocks
joining it, the factories' routing and refusals, and a failed call leaving
its decoder as it was."""

import random

import pytest

import bench
from lz4_tpu.block import incremental as jinc
from lz4_tpu_torch.block import LZ4Error
from lz4_tpu_torch.block.incremental import (
    BlockDecoder,
    BlockEncoder,
    ChainDecoder,
    ChainEncoder,
    create_decoder,
    create_encoder,
)

CORPUS = bench.make_corpus(1 << 18, seed=31)


def test_factory_routing():
    assert isinstance(create_encoder(False, 0, device="cpu"), BlockEncoder)
    assert isinstance(create_encoder(True, 9, device="cpu"), ChainEncoder)
    assert isinstance(create_decoder(False, device="cpu"), BlockDecoder)
    assert isinstance(create_decoder(True, device="cpu"), ChainDecoder)


@pytest.mark.parametrize("chaining, level, geometry", [
    (True, 0, "bogus"), (False, 0, "bogus"), (True, 0, "canonical"),
    (True, 2, "canonical"),
])
def test_factories_refuse_what_the_jax_package_refuses(chaining, level, geometry):
    with pytest.raises(ValueError) as theirs:
        jinc.create_encoder(chaining, level, backend="host", geometry=geometry)
    with pytest.raises(ValueError) as ours:
        create_encoder(chaining, level, device="cpu", geometry=geometry)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("geometry", ["auto", "canonical", "dense"])
@pytest.mark.parametrize("level", [0, 3])
def test_independent_blocks_equal_the_jax_encoder(geometry, level):
    blocks = [CORPUS[k * 7000:(k + 1) * 7000] for k in range(3)] + [b"", b"x" * 13]
    ours = create_encoder(False, level, device="cpu", geometry=geometry)
    theirs = jinc.create_encoder(False, level, backend="host", geometry=geometry)
    for b in blocks:
        assert ours.encode_block(b) == theirs.encode_block(b)


@pytest.mark.parametrize("level", [0, 3])
def test_chained_blocks_equal_the_jax_encoder(level):
    base = CORPUS[:4000]
    blocks = [base, base, CORPUS[4000:9000], base[:100], CORPUS[9000:80000]]
    ours = ChainEncoder(level, device="cpu")
    theirs = jinc.ChainEncoder(level, backend="host")
    for b in blocks:
        assert ours.encode_block(b) == theirs.encode_block(b)
        assert ours.dictionary == theirs.dictionary


def test_chained_beats_independent_on_redundant_blocks():
    base = CORPUS[:4000]
    chain_enc, indep_enc = ChainEncoder(device="cpu"), BlockEncoder(device="cpu")
    chained = [chain_enc.encode_block(base) for _ in range(4)]
    indep = [indep_enc.encode_block(base) for _ in range(4)]
    assert sum(map(len, chained)) < sum(map(len, indep))
    assert len(chained[1]) < len(chained[0])
    theirs = jinc.ChainEncoder(backend="host")
    assert [len(theirs.encode_block(base)) for _ in range(4)] == list(map(len, chained))


@pytest.mark.parametrize("preset", [b"", CORPUS[200000:201000], CORPUS[100000:180000]])
def test_chain_round_trip_with_the_decoder(preset):
    data = [CORPUS[k * 3000:(k + 1) * 3000] for k in range(6)]
    enc = jinc.ChainEncoder(backend="host")
    enc._dict = preset[-65536:]
    comp = [enc.encode_block(b) for b in data]
    ours = ChainDecoder(dictionary=preset, device="cpu")
    theirs = jinc.ChainDecoder(dictionary=preset, backend="host")
    for c, b in zip(comp, data):
        assert ours.decode_block(c, len(b)) == theirs.decode_block(c, len(b)) == b
        assert ours.dictionary == theirs.dictionary


def test_inject_participates_in_window():
    stored = random.Random(5).randbytes(3000)
    follow = stored[:2000]
    enc = ChainEncoder(device="cpu")
    enc.encode_block(stored)
    c2 = enc.encode_block(follow)
    assert len(c2) < len(follow) // 10
    dec = ChainDecoder(device="cpu")
    assert dec.inject_block(stored) == stored
    assert dec.decode_block(c2, len(follow)) == follow


def test_window_capped_at_64k():
    enc = ChainEncoder(device="cpu")
    rng = random.Random(1234)
    for _ in range(5):
        enc.encode_block(rng.randbytes(30000))
    assert len(enc.dictionary) == 65536
    enc.reset()
    assert enc.dictionary == b""


def test_block_decoder_bounds_and_stored_blocks():
    data = CORPUS[:50000]
    comp = jinc.BlockEncoder(backend="host").encode_block(data)
    ours, theirs = BlockDecoder(65536, device="cpu"), jinc.BlockDecoder(65536, backend="host")
    assert ours.decode_block(comp) == theirs.decode_block(comp) == data
    assert ours.decode_block(comp, 50000) == data
    assert ours.inject_block(b"raw") == b"raw"
    for small, exp in ((BlockDecoder(4096, device="cpu"), None), (ours, 49999)):
        with pytest.raises(LZ4Error):
            small.decode_block(comp, exp)


def test_a_failed_decode_leaves_the_window_as_it_was():
    dec = ChainDecoder(dictionary=b"abcd" * 10, device="cpu")
    before = dec.dictionary
    with pytest.raises(LZ4Error):
        dec.decode_block(b"\x1f\x00\xff\xff")  # an offset past the window
    assert dec.dictionary == before
