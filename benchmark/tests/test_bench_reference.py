"""The plain reference (`benchmark/reference.py`) against the port's CPU
route, both ways, and against the LZ4 format's rules."""

import json
import struct

import numpy as np
import pytest
import torch
from conftest import ROOT

from benchmark import reference, traffic
from benchmark.harness import Port, encoder_settings, load_json

SETTINGS = {"compression_level": 1, "block_size": 65536, "chain_blocks": False, "block_checksum": False,
            "content_checksum": True, "content_length": None}


def _object(mix: str, size: int, seed: int) -> bytes:
    return traffic.make_object(load_json("traffic", mix), seed, size)


def _greedy_block(src: bytes) -> bytes:
    """A valid LZ4 block by a plain greedy search over a 4-byte hash
    table: the frames the port's decoder is held to here."""
    out, anchor, i, table, n = bytearray(), 0, 0, {}, len(src)

    def seq(lits, off=None, ml=0):
        ll = len(lits)
        tok = (min(ll, 15) << 4) | (min(ml - 4, 15) if off else 0)
        out.append(tok)
        if ll >= 15:
            v = ll - 15
            while v >= 255:
                out.append(255)
                v -= 255
            out.append(v)
        out.extend(lits)
        if off:
            out.extend(struct.pack("<H", off))
            if ml - 4 >= 15:
                v = ml - 19
                while v >= 255:
                    out.append(255)
                    v -= 255
                out.append(v)

    while i + 12 <= n:
        key = src[i:i + 4]
        j = table.get(key)
        table[key] = i
        if j is not None and i - j <= 65535:
            ml = 4
            while i + ml < n - 5 and src[j + ml] == src[i + ml]:
                ml += 1
            seq(src[anchor:i], i - j, ml)
            i += ml
            anchor = i
        else:
            i += 1
    seq(src[anchor:])
    return bytes(out)


def _frame(obj: bytes, encode, bs: int = 65536) -> bytes:
    """The frame of ``obj`` in independent blocks of ``bs`` bytes, each
    block by ``encode`` (None where it stores the block)."""
    desc = bytes([0x64, 0x40])
    parts = [struct.pack("<I", reference.MAGIC), desc, bytes([(reference.xxh32(desc) >> 8) & 0xFF])]
    for lo in range(0, len(obj), bs):
        raw = obj[lo:lo + bs]
        comp = encode(raw)
        if comp is not None and len(comp) < len(raw):
            parts += [struct.pack("<I", len(comp)), comp]
        else:
            parts += [struct.pack("<I", len(raw) | 1 << 31), raw]
    parts += [b"\0\0\0\0", struct.pack("<I", reference.xxh32(obj))]
    return b"".join(parts)


def _upstream(level: int):
    return lambda raw: reference.liblz4_block(raw, level)


MIXES = ["real_files", "silesia_tar_random"]


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("config", ["lz4cli_default", "lz4cli_hc9"])
def test_port_frames_pass_the_reference(mix, config):
    obj = _object(mix, 140_000, 7)
    cfg = dict(load_json("configs", config), block_size=65536)
    port = Port(encoder_settings(cfg), torch.device("cpu"))
    frame = port.compress(obj)
    settings = dict(SETTINGS, compression_level=cfg["compression_level"])
    got = reference.check_frame(frame, obj, settings)
    assert got == {"frame_faults": 0, "block_faults": 0, "blocks": 3, "faults": []}
    assert port.decompress(frame) == obj


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("level", [1, 9])
def test_reference_frames_pass_the_port(mix, level):
    obj = _object(mix, 140_000, 8)
    frame = _frame(obj, _upstream(level))
    settings = dict(SETTINGS, compression_level=level)
    assert reference.check_frame(frame, obj, settings, workers=2)["faults"] == []
    assert Port(encoder_settings(load_json("configs", "lz4cli_default")),
                torch.device("cpu")).decompress(frame) == obj


@pytest.mark.parametrize("level, encode", [(1, _greedy_block), (9, _upstream(8)),
                                           (9, _upstream(1))], ids=["greedy", "L8", "L1"])
def test_valid_blocks_of_another_encoder_are_faults(level, encode):
    """Blocks that decode to the object but are not liblz4's at the
    configuration's level: each counts, in either direction of the
    stored-or-compressed choice."""
    obj = _object("real_files", 140_000, 9)
    got = reference.check_frame(_frame(obj, encode), obj, dict(SETTINGS, compression_level=level))
    assert got["frame_faults"] == 0 and got["block_faults"] >= 1
    assert "liblz4" in got["faults"][0]
    raw = obj[:65536]
    assert reference.check_block(raw, True, raw, None, 1) is not None  # upstream compresses it
    assert reference.check_block(reference.liblz4_block(raw, 1), False, raw, None, 1) is None
    noise = np.random.default_rng(1).bytes(65536)
    assert reference.check_block(noise, True, noise, None, 9) is None  # upstream stores it


def test_xxh32_matches_the_port_and_the_spec():
    from lz4_tpu_torch.xxh32 import xxh32

    assert reference.xxh32(b"") == 0x02CC5D05
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    for n in (1, 3, 4, 15, 16, 17, 31, 32, 33, 255, 4999):
        assert reference.xxh32(data[:n]) == xxh32(data[:n]), n
        assert reference.xxh32(data[:n], seed=12345) == xxh32(data[:n], 12345), n


def test_lanes_in_workers_equal_lanes_here():
    data = _object("real_files", 70_000, 9)
    lanes = reference.xxh32_lanes(data)
    assert reference.run_jobs(lanes, workers=3) == reference.run_jobs(lanes)


@pytest.mark.parametrize("block, raw_len, fault", [
    (b"\x00", 0, None),
    (bytes([0x50]) + b"abcde", 5, None),
    (bytes([0x14]) + b"a\x01\x00" + bytes([0x50]) + b"vwxyz", 14, None),
    (bytes([0x10]) + b"a\x00\x00" + bytes([0x50]) + b"vwxyz", 10, "offset 0"),
    (bytes([0x10]) + b"a\x02\x00" + bytes([0x50]) + b"vwxyz", 10, "reaches before the block"),
    (bytes([0xF0, 10]) + b"x", 25, "literals run past the block"),
    (bytes([0x10]) + b"a\x01", 5, "ends inside an offset"),
    (bytes([0x50]) + b"abcde", 6, "decodes to 5 bytes"),
    (bytes([0x80]) + b"abcdefgh\x01\x00" + bytes([0x50]) + b"vwxyz", 17, "too close"),
    (bytes([0x14]) + b"a\x01\x00" + bytes([0x40]) + b"wxyz", 13, "too close"),
])
def test_block_format_faults(block, raw_len, fault):
    _, got = reference.decode_block(block, raw_len)
    if fault is None:
        assert got is None
    else:
        assert got is not None and fault in got


def test_frame_faults_are_counted():
    obj = _object("real_files", 140_000, 10)
    frame = _frame(obj, _upstream(1))
    bad_csum = frame[:-1] + bytes([frame[-1] ^ 1])
    assert reference.check_frame(bad_csum, obj, SETTINGS)["frame_faults"] == 1
    linked = bytes([frame[0], frame[1], frame[2], frame[3], 0x44]) + frame[5:]
    got = reference.check_frame(linked, obj, SETTINGS)
    assert got["frame_faults"] == 2  # the FLG, and the header checksum byte
    first = struct.unpack_from("<I", frame, 7)[0]
    flipped = bytearray(frame)
    flipped[11 + first // 2] ^= 0x5A
    assert reference.check_frame(bytes(flipped), obj, SETTINGS)["block_faults"] == 1
    assert reference.check_frame(frame[:-8], obj, SETTINGS)["frame_faults"] >= 1


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import benchmark.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'lz4_tpu', 'lz4_tpu_torch', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert json.loads(out.replace("'", '"')) == []
