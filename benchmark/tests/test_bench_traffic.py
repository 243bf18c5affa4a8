"""The one generator (`benchmark/traffic.py`) and its pool of real bytes."""

import hashlib
import json

import pytest

from benchmark import traffic
from benchmark.harness import load_json


BLOCK = 4 << 20


def test_the_pool_is_the_listed_bytes():
    listing = json.loads((traffic.POOLS / "real.json").read_text())
    pieces, short = traffic.pool_pieces("real", BLOCK)
    assert len(pieces) == 10 and all(len(p) == BLOCK for p in pieces)
    assert 5 * 10 * BLOCK + len(short) == 211_957_760  # silesia.tar's size
    whole = b"".join(pieces) + short
    assert len(whole) == listing["bytes"]
    at = 0
    for s in listing["streams"]:
        assert hashlib.sha256(whole[at:at + s["bytes"]]).hexdigest() == s["sha256"]
        assert sum(src["bytes"] for src in s["sources"]) == s["bytes"]
        at += s["bytes"]


def test_the_real_files_are_the_pools_pieces_for_every_seed():
    mix = load_json("traffic", "real_files")
    assert mix["parts"][0]["piece_bytes"] == BLOCK
    pieces, short = traffic.pool_pieces("real", BLOCK)
    size = 2 * 10 * BLOCK + len(short)  # two whole passes and the short piece
    a = traffic.make_object(mix, 1, size)
    assert a == traffic.make_object(mix, 2**40 + 3, size) == b"".join(pieces * 2) + short
    assert traffic.make_object(mix, 1, 3 * BLOCK) == b"".join(pieces[:3])
    assert len(traffic.make_object(mix, 1, size + 5)) == size + 5


@pytest.mark.parametrize("mix", ["real_files", "silesia_tar_random"])
def test_objects_have_the_file_size(mix):
    mix = load_json("traffic", mix)
    assert mix["object_bytes"] == 211_957_760
    a = traffic.make_object(mix, 5, 10_000)
    assert len(a) == 10_000 and a == traffic.make_object(mix, 5, 10_000)


def test_random_bytes_follow_the_seed():
    mix = load_json("traffic", "silesia_tar_random")
    a = traffic.make_object(mix, 5, 10_000)
    assert a != traffic.make_object(mix, 6, 10_000)
    assert traffic.make_object(mix, -1, 16) == traffic.make_object(mix, 2**64 - 1, 16)
