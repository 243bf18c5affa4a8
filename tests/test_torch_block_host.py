"""The port's block host surface on the CPU, held to the JAX package's host
route: `maximum_output_size`, `encode(target_capacity=)`, `encode_into`,
`decode_into` and `partial_decode` give the same bytes, return values and
exception classes; kernel A's output limit (`ops.decode._decode_row`,
`decode_blocks(limits=)`) is held to `lz4_tpu.block.partial_decode`
(limits inside literal runs and overlapping matches, blocks malformed
after the limit, dictionaries); kernel E's streaming form
(`xxh32_stripes_plain`) and `XXH32.update` on tensors are held to
`lz4_tpu.xxh32`."""

import numpy as np
import pytest
import torch

import bench
from lz4_tpu.block import api as jblock
from lz4_tpu.xxh32 import XXH32 as JXXH32, xxh32 as jxxh32
from lz4_tpu_torch import block
from lz4_tpu_torch import xxh32 as _host_fn  # noqa: F401  (the function)
from lz4_tpu_torch.ops import decode, xxh32 as kxxh32
from lz4_tpu_torch.xxh32 import XXH32

CORPUS = bench.make_corpus(1 << 19, seed=21)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome under test
        return type(e).__name__, str(e)


@pytest.mark.parametrize("n", [0, 1, 255, 65536, 1 << 22, -1])
def test_maximum_output_size(n):
    assert block.maximum_output_size(n) == jblock.maximum_output_size(n)


@pytest.mark.parametrize("cap", [None, 0, 100, 3000, 1 << 20])
def test_encode_target_capacity(cap):
    data = CORPUS[:20000]
    ours = block.encode(data, target_capacity=cap, device="cpu")
    assert ours == jblock.encode(data, target_capacity=cap, backend="host")


@pytest.mark.parametrize("room", [0, 10, 2000, 7000, 30000])
@pytest.mark.parametrize("level", [0, 3])
def test_encode_into(room, level):
    data = CORPUS[30000:50000]
    ours, theirs = bytearray(room), bytearray(room)
    n = block.encode_into(data, ours, level=level, device="cpu")
    assert n == jblock.encode_into(data, theirs, level=level, backend="host")
    if n > 0:
        assert ours[:n] == theirs[:n]
        assert block.decode(bytes(ours[:n]), len(data), device="cpu") == data


@pytest.mark.parametrize("room", [0, 100, 19999, 20000, 70000])
@pytest.mark.parametrize("dictionary", [b"", CORPUS[:70000]])
def test_decode_into(room, dictionary):
    data = CORPUS[80000:100000]
    comp = jblock.encode(data, dictionary=dictionary, backend="host")
    ours, theirs = bytearray(room), bytearray(room)
    got = _outcome(lambda: block.decode_into(comp, ours, dictionary, device="cpu"))
    want = _outcome(lambda: jblock.decode_into(comp, theirs, dictionary, backend="host"))
    assert got[0] == want[0]
    if got[0] == "ok":
        assert got == want and ours == theirs


def test_decode_into_read_only_and_malformed():
    comp = jblock.encode(CORPUS[:1000], backend="host")
    for dest in (bytes(2000), memoryview(bytearray(2000)).toreadonly()):
        got = _outcome(lambda: block.decode_into(comp, dest, device="cpu"))
        want = _outcome(lambda: jblock.decode_into(comp, dest, backend="host"))
        assert got == want == ("LZ4Error", "destination buffer is read-only")
    for bad in (b"", b"\xf0", comp[:-3]):
        got = _outcome(lambda: block.decode_into(bad, bytearray(2000), device="cpu"))
        want = _outcome(lambda: jblock.decode_into(bad, bytearray(2000), backend="host"))
        assert got[0] == want[0] == "LZ4Error"


def _crafted() -> tuple[bytes, bytes]:
    """A block with a 20-byte literal run, a 100-byte match at offset 3
    (overlapping itself), 300 literals (a length extension), a 40-byte
    match at offset 250, and 9 final literals; and what it decodes to."""
    rng = np.random.default_rng(5)
    lits = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (20, 300, 9)]
    comp = bytearray([0xF0 | 15, 5]) + lits[0] + (3).to_bytes(2, "little") + bytes([100 - 19])
    comp += bytes([0xF0 | 15, 255, 30]) + lits[1] + (250).to_bytes(2, "little") + bytes([40 - 19])
    comp += bytes([0x90]) + lits[2]
    out = bytearray(lits[0])
    for _ in range(100):
        out.append(out[-3])
    out += lits[1]
    for _ in range(40):
        out.append(out[-250])
    out += lits[2]
    return bytes(comp), bytes(out)


CRAFTED, CRAFTED_OUT = _crafted()


@pytest.mark.parametrize("limit", [0, 1, 5, 19, 20, 21, 50, 119, 120, 121, 300,
                                   420, 440, 460, 468, 469, 470, 1000])
def test_partial_decode_inside_runs_and_overlapping_matches(limit):
    assert jblock.decode(CRAFTED, backend="host") == CRAFTED_OUT
    ours = block.partial_decode(CRAFTED, limit, device="cpu")
    assert ours == jblock.partial_decode(CRAFTED, limit, backend="host")
    assert ours == CRAFTED_OUT[:limit]


@pytest.mark.parametrize("cut", ["truncated", "bad_offset", "trailing_token", "long_ext"])
@pytest.mark.parametrize("limit", [10, 119, 121, 460, 2000])
def test_partial_decode_of_blocks_malformed_after_the_limit(cut, limit):
    """What follows the limit is not parsed: a block malformed there gives
    the prefix; one malformed before it raises, as the JAX package does."""
    c = bytearray(CRAFTED)
    if cut == "truncated":
        c = c[:len(c) - 5]
    elif cut == "bad_offset":  # the second match's offset past the start
        c[-13] = 0xFF
        c[-12] = 0xFF
    elif cut == "trailing_token":  # a match token where the block ends
        c += b"\x0f"
    else:  # a match length extension that runs out of input
        c = c[:21 + 2] + bytes([255, 255])
    c = bytes(c)
    ours = _outcome(lambda: block.partial_decode(c, limit, device="cpu"))
    theirs = _outcome(lambda: jblock.partial_decode(c, limit, backend="host"))
    assert ours[0] == theirs[0]
    if ours[0] == "ok":
        assert ours == theirs


@pytest.mark.parametrize("dict_len", [0, 100, 65536, 70000])
def test_partial_decode_with_a_dictionary(dict_len):
    dictionary = CORPUS[200000:200000 + dict_len]
    data = CORPUS[100000:160000]
    comp = jblock.encode(data, dictionary=dictionary, backend="host")
    for limit in (0, 1, 16, 17, 4096, 30001, 60000, 70000):
        ours = block.partial_decode(comp, limit, dictionary, device="cpu")
        assert ours == jblock.partial_decode(comp, limit, dictionary, backend="host")
        assert ours == data[:limit]


def test_the_limit_held_to_the_jax_partial_decode_on_random_blocks():
    """`_decode_row` with a limit against `lz4_tpu.block.partial_decode`
    on seeded blocks, some cut short or with bytes overwritten."""
    rng = np.random.default_rng(9)
    for t in range(300):
        n = int(rng.integers(0, 3000))
        data = rng.integers(0, 4, n, dtype=np.uint8).tobytes()
        d = rng.integers(0, 4, int(rng.integers(1, 500)), dtype=np.uint8).tobytes() if t % 3 == 0 else b""
        comp = bytearray(jblock.encode(data, dictionary=d, backend="host"))
        if t % 2 and len(comp) > 2:
            for _ in range(int(rng.integers(1, 4))):
                comp[int(rng.integers(0, len(comp)))] = int(rng.integers(0, 256))
        if t % 5 == 0 and len(comp) > 3:
            comp = comp[:int(rng.integers(1, len(comp)))]
        comp, limit = bytes(comp), int(rng.integers(0, n + 50))
        theirs = _outcome(lambda: jblock.partial_decode(comp, limit, dictionary=d, backend="host"))
        got, err = decode._decode_row(comp, len(comp), 1 << 20, d, limit)
        assert (("ok", got) if err == 0 else ("LZ4Error",)) == (
            theirs if theirs[0] == "ok" else (theirs[0],)), t


def test_decode_blocks_limits_per_row():
    """A batch's rows with their own limits (-1: none) give each row's
    partial decode; without limits the rows are unchanged."""
    rows = [jblock.encode(CORPUS[k * 9000:(k + 1) * 9000], backend="host") for k in range(4)]
    comps = torch.zeros((4, 10000), dtype=torch.uint8)
    for i, r in enumerate(rows):
        comps[i, :len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
    clens = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    limits = [-1, 0, 4500, 20000]
    out, lens, errs = decode.decode_blocks(comps, clens, 16384, limits=limits)
    assert errs.tolist() == [0, 0, 0, 0]
    for i, lim in enumerate(limits):
        want = CORPUS[i * 9000:(i + 1) * 9000][:lim if lim >= 0 else None]
        assert out[i, :int(lens[i])].numpy().tobytes() == want
    full = decode.decode_blocks(comps, clens, 16384)
    assert torch.equal(full[0][0], out[0]) and int(full[1][3]) == 9000
    with pytest.raises(ValueError, match="one value per row"):
        decode.decode_blocks(comps, clens, 16384, limits=[1, 2])
    with pytest.raises(ValueError, match=">= -1"):
        decode.decode_blocks(comps, clens, 16384, limits=[-2, 0, 0, 0])


def test_partial_decode_refuses_a_negative_length():
    with pytest.raises(ValueError):
        block.partial_decode(CRAFTED, -1, device="cpu")


@pytest.mark.parametrize("start", [0, 1, 15, 16, 17])
@pytest.mark.parametrize("nbytes", [0, 1, 15, 16, 17, 33, 4097])
def test_stripes_plain_continues_the_jax_hash(start, nbytes):
    """Four accumulators carried through `xxh32_stripes_plain` window by
    window, then finished, equal `lz4_tpu.xxh32` of the whole."""
    raw = np.frombuffer(CORPUS[:12000], np.uint8)
    flat = torch.from_numpy(raw.copy())
    accs, pos = list(kxxh32._SEEDED), start
    while pos + nbytes + 5 <= raw.size and nbytes >= 16:
        accs = kxxh32.as_uint32(kxxh32.xxh32_stripes_plain(flat, pos, nbytes, accs))
        pos += nbytes // 16 * 16
    if nbytes < 16:
        got = kxxh32.xxh32_stripes_plain(flat, start, nbytes, accs)
        assert kxxh32.as_uint32(got) == list(kxxh32._SEEDED)
        return
    n = pos - start + 5
    tail = raw[pos:pos + 5].tobytes()
    assert kxxh32._finish(accs, n, tail) == jxxh32(raw[start:start + n].tobytes())


def test_stripes_plain_checks_its_arguments():
    flat = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError, match="four"):
        kxxh32.xxh32_stripes_plain(flat, 0, 16, [1, 2, 3])
    with pytest.raises(ValueError, match="outside"):
        kxxh32.xxh32_stripes_plain(flat, 90, 16, [0, 0, 0, 0])


@pytest.mark.parametrize("splits", [[1], [15], [16], [17], [1, 15, 16, 17], [4096, 3]])
def test_xxh32_updates_on_tensors_at_odd_splits(splits):
    """`XXH32.update` on CPU tensors (kernel E's streaming form, plain) and
    on bytes, with a tail carried across from a bytes update, equals
    `lz4_tpu.xxh32.XXH32` on the same splits."""
    data = CORPUS[:9000]
    ours, theirs = XXH32(), JXXH32()
    ours.update(data[:7])
    theirs.update(data[:7])
    pos, k = 7, 0
    launches = _host_stripes_launches()
    while pos < len(data):
        n = splits[k % len(splits)]
        chunk = data[pos:pos + n]
        ours.update(torch.frombuffer(bytearray(chunk), dtype=torch.uint8))
        theirs.update(chunk)
        pos, k = pos + n, k + 1
        assert ours.digest() == theirs.digest()
    assert _host_stripes_launches() == launches  # no tensor took the host loop
    assert ours.digest() == jxxh32(data)


def _host_stripes_launches():
    import importlib

    return importlib.import_module("lz4_tpu_torch.xxh32").host_stripes.launches


def test_xxh32_one_shot_and_bytes_updates_match():
    for n in (0, 1, 15, 16, 17, 100, 5000):
        assert _host_fn(CORPUS[:n]) == jxxh32(CORPUS[:n])
    h = XXH32(seed=7)
    h.update(CORPUS[:20])
    h.update(memoryview(CORPUS[20:300]))
    assert h.digest() == jxxh32(CORPUS[:300], 7)
