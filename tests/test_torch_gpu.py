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
from lz4_tpu_torch.ops import decode, encode
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
