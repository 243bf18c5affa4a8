"""The HC (levels 3-9) and OPT (levels 10-12) path end to end on the CPU:
the plain versions equal the native engine and liblz4 at every level, and
`frame.compress` and `block.encode` equal the JAX package's host route byte
for byte (exact equality), their frames decoding to the payload."""

import pytest
import torch

import chip_smoke
import liblz4
from lz4_tpu import frame as jframe
from lz4_tpu import native
from lz4_tpu.block import api as jblock
from lz4_tpu_torch import block as tblock
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.ops import encode as E
from lz4_tpu_torch.ops import encode_stream as ES

import bench

CORPUS = bench.make_corpus(1 << 20, seed=11)


def _rows():
    """Three 64 KB rows of the mix (text-like, records, runs) and the
    26,200-byte wordy regression row."""
    return [CORPUS[q << 18:(q << 18) + 65536] for q in range(3)] + [chip_smoke.wordy_row()]


@pytest.mark.parametrize("level", range(3, 13))
def test_plain_versions_equal_native_and_liblz4(level):
    rows = _rows()
    bufs, lens = chip_smoke._stage(rows, 65536 + 1024)
    out, clens, errs = E.encode_blocks_plain(bufs, lens, 65536, level)
    assert not errs.any()
    for i, d in enumerate(rows):
        ours = out[i, : int(clens[i])].numpy().tobytes()
        assert ours == native.encode(d, level), i
        assert ours == liblz4.compress_block(d, level), i


@pytest.mark.parametrize("block_size", [1 << 16, 1 << 18])
@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("level", [3, 9, 10, 12])
def test_frames_equal_the_jax_host_route(level, chain, block_size):
    data = CORPUS[300000:500000]
    kw = dict(compression_level=level, chain_blocks=chain,
              block_size=block_size, content_checksum=True)
    ours = tframe.compress(data, tframe.EncoderSettings(**kw), device="cpu")
    assert ours == jframe.compress(data, jframe.EncoderSettings(**kw), backend="host")
    assert tframe.decompress(ours, device="cpu") == data


@pytest.mark.parametrize("dict_len", [0, 100, 70000])
@pytest.mark.parametrize("level", [9, 12])
def test_block_encode_equals_the_jax_host_route(level, dict_len):
    at = 600000
    d, s = CORPUS[at - dict_len:at], CORPUS[at:at + 30000]
    ours = tblock.encode(s, level=level, dictionary=d, device="cpu")
    assert ours == jblock.encode(s, level=level, dictionary=d, backend="host")
    assert tblock.decode(ours, len(s), dictionary=d, device="cpu") == s


def test_arm_wrappers_refuse_other_levels():
    payload = torch.frombuffer(bytearray(CORPUS[:5000]), dtype=torch.uint8)
    with pytest.raises(ValueError, match="OPT arm"):
        ES.encode_windows_opt(payload, [0], [0], [5000], 5000, 9)
    with pytest.raises(ValueError, match="HC arm"):
        ES.encode_windows_hc(payload, [0], [0], [50], 64, 0)
    with pytest.raises(ValueError, match="HC arm"):
        ES.encode_windows_hc(payload, [0], [0], [50], 64, 12)
