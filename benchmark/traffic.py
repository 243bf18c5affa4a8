"""The one generator of the benchmark's objects.

A traffic file (`benchmark/traffic/<name>.json`) gives the object's size
and the parts it is made of, in order, each with its parameters.  Every
part draws from one numpy generator seeded by ``--seed``, so the same
seed gives the same bytes.  Kinds of part:

- ``pool``: real bytes, `pool/<pool>.xz` (its streams listed with their
  sources in `pool/<pool>.json`) cut into pieces of ``piece_bytes`` and
  a short last piece; the part is passes over the whole pieces in the
  pool's order, as many as leave room for the short piece (at least
  one), then the short piece, cut to the part's length.  It is the same
  for every seed: the port's `lz4 -9` parse takes 12 or 15.5 s a call on
  the same blocks in two orders, so an order drawn from the seed would
  let the seeds of a check decide its median;
- ``uniform``: uniform random bytes.

A part takes ``share`` ([numerator, denominator]) of the object, the last
part the rest.  The file's ``callers`` and ``calls`` give the loop that
the harness runs over the object.
"""

from __future__ import annotations

import functools
import hashlib
import json
import lzma
from pathlib import Path

import numpy as np

POOLS = Path(__file__).resolve().parent / "pool"


@functools.lru_cache(maxsize=1)
def pool_bytes(name: str) -> bytes:
    """The bytes of pool ``name``; raises where they are not the ones its
    listing names."""
    listing = json.loads((POOLS / f"{name}.json").read_text())
    data = lzma.decompress((POOLS / f"{name}.xz").read_bytes())
    if len(data) != listing["bytes"] or hashlib.sha256(data).hexdigest() != listing["sha256"]:
        raise ValueError(f"pool {name}: its bytes are not those of {name}.json")
    return data


def pool_pieces(name: str, piece_bytes: int) -> tuple[list, bytes]:
    """Pool ``name`` cut into pieces of ``piece_bytes``: (the whole
    pieces, the short last piece or b"")."""
    data = pool_bytes(name)
    view = memoryview(data)
    whole = len(data) // piece_bytes * piece_bytes
    return ([view[p:p + piece_bytes] for p in range(0, whole, piece_bytes)],
            bytes(view[whole:]))


def _pool(rng, n: int, p: dict) -> np.ndarray:
    pieces, short = pool_pieces(p["pool"], p["piece_bytes"])
    per_pass = len(pieces) * p["piece_bytes"]
    passes = max(1, (n - len(short)) // per_pass)
    passes += max(0, -(-(n - passes * per_pass - len(short)) // per_pass))
    return np.frombuffer(b"".join(pieces * passes + [short]), np.uint8)[:n]


def _uniform(rng, n: int, p: dict) -> np.ndarray:
    return np.frombuffer(rng.bytes(n), np.uint8)


KINDS = {"pool": _pool, "uniform": _uniform}


def make_object(traffic: dict, seed: int, size: int | None = None) -> bytes:
    """The object of ``traffic`` (a traffic file's contents) for ``seed``;
    ``size`` in place of the file's ``object_bytes`` (tests)."""
    total = traffic["object_bytes"] if size is None else size
    rng = np.random.default_rng(seed % 2**64)
    parts, left = [], total
    for i, part in enumerate(traffic["parts"]):
        if i + 1 < len(traffic["parts"]):
            num, den = part["share"]
            n = total * num // den
        else:
            n = left
        left -= n
        parts.append(KINDS[part["kind"]](rng, n, part))
    return np.concatenate(parts).tobytes() if parts else b""
