"""The archived TPU encoder's cases run through the port's kernel B.

`experiments/tests/test_pallas_encode.py` and `test_experiment_fuzz.py`
held the round-1 encoder (`experiments/encode_pallas.py`, with the v1
decoder) to `lz4_tpu.block.hostref` and `lz4_tpu.native`; here the same
inputs, from the same seeds (`random.Random(1234)`, the fuzz's
`random.Random(100 + seed)`), go through `lz4_tpu_torch.ops.encode.
encode_blocks` and `ops.decode.decode_blocks` (their plain versions on the
CPU) with the same assertions.  The archived kernels themselves are not
run."""

import random

import numpy as np
import pytest
import torch

from lz4_tpu import native
from lz4_tpu.block import hostref
from lz4_tpu_torch.ops import decode as A
from lz4_tpu_torch.ops import encode as B
from lz4_tpu_torch.parallel.blocks import comp_capacity
from test_cross_backend_fuzz import _random_structured

pytestmark = pytest.mark.skipif(not native.available(), reason="native engine unavailable")

N = 4096
CAP = N + 1024


@pytest.fixture
def rng():
    return random.Random(1234)


def _encode(cases):
    bufs = np.zeros((len(cases), CAP), np.uint8)
    lens = np.zeros((len(cases),), np.int32)
    for i, d in enumerate(cases):
        bufs[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    got = B.encode_blocks(torch.from_numpy(bufs), torch.from_numpy(lens), N)
    return tuple(t.numpy() for t in got)


def _decode(comp: bytes):
    comps = np.zeros((1, comp_capacity(N)), np.uint8)
    comps[0, :len(comp)] = np.frombuffer(comp, np.uint8)
    got = A.decode_blocks(torch.from_numpy(comps),
                          torch.tensor([len(comp)], dtype=torch.int32), N)
    return tuple(t.numpy() for t in got)


def test_roundtrip_via_oracle(rng):
    cases = [
        b"hello world hello world hello!",
        bytes(3000),
        rng.randbytes(1500),
        (b"abcdefg" * 500)[:3400],
        b"a" * 4000,
        (b" ".join([b"lorem", b"ipsum", b"dolor", b"sit"] * 250))[:4000],
        b"x",
        b"ab" * 2000,
        bytes(range(256)) * 15,
    ]
    out, clens, errs = _encode(cases)
    for i, d in enumerate(cases):
        assert errs[i] == 0, i
        assert hostref.decode_block(out[i, :clens[i]].tobytes(), len(d)) == d, i


def test_empty_block():
    out, clens, errs = _encode([b""])
    assert errs[0] == 0
    assert out[0, :clens[0]].tobytes() == b"\x00"


def test_matches_native_greedy():
    """The compressed sizes of the native greedy codec (its canonical
    schedule, which kernel B runs) on typical data."""
    cases = [
        (b" ".join([b"alpha", b"beta", b"gamma"] * 300))[:4000],
        b"z" * 3000,
        (b"0123456789abcdef" * 250)[:3900],
    ]
    out, clens, errs = _encode(cases)
    for i, d in enumerate(cases):
        assert clens[i] == len(native.encode(d, 0)), i


def test_encode_decode_roundtrip():
    data = (b" ".join([b"round", b"trip", b"data"] * 280))[:3500]
    out, clens, errs = _encode([data])
    assert errs[0] == 0
    dec, lens, derr = _decode(out[0, :clens[0]].tobytes())
    assert derr[0] == 0
    assert dec[0, :len(data)].tobytes() == data


@pytest.mark.parametrize("seed", range(3))
def test_fuzz(seed):
    """`test_experiment_fuzz.py`'s cases: encode, the oracle's decode, then
    the port's decode."""
    rng = random.Random(100 + seed)
    data = _random_structured(rng, rng.choice([100, 2000, 4000]))
    out, clens, errs = _encode([data])
    assert errs[0] == 0
    comp = out[0, :clens[0]].tobytes()
    assert hostref.decode_block(comp, len(data)) == data
    dec, lens, derr = _decode(comp)
    assert derr[0] == 0
    assert dec[0, :len(data)].tobytes() == data
