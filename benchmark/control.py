"""The controls of the check that decides `correct`, and the faults it has
to catch: each has to come out as not correct.

Controls break a guarantee the configuration states, with the port
itself:

- `LinkedBlocks`: the port's linked-block path switched on
  (``chain_blocks=True``: each block may reach into the 64 KB before it).
  The check reads the FLG byte against the configuration
  (`frame_faults`) and decodes every block on its own (`block_faults`,
  where a block's matches reach before its start);
- `LevelBelow`: the port one compression level below the configuration's
  (``lz4 -8`` for ``lz4 -9``: half the HC search depth), the step that
  would buy a faster encoder with a shorter search.  The check holds every
  block to liblz4's at the configuration's level (`block_faults`).  Level 1
  has no level below it with other blocks (levels 0-2 are all level 1's).

Faults break the timed path where it is produced: a step that returns
its state unchanged (`StateUnchanged`, `CompressUnchanged`), half of the
batch left out (`HalfTheBlocks`, `HalfTheContent`), a token or an
answer altered (`TokenAltered`, `ByteAltered`).

    python3 benchmark/control.py --workload <name> --port <name> [...] --seeds <n> [...] --seconds <s>

runs the cell's set-up, window and check on the card with each named
port in the port's place, once per seed, and prints one JSON line per run
with the numbers compared.  The benchmark's own runs never run it.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.harness import Port  # noqa: E402


class LinkedBlocks(Port):
    """The port with its linked-block path switched on."""

    def __init__(self, settings, device):
        super().__init__(dataclasses.replace(settings, chain_blocks=True), device)


class LevelBelow(Port):
    """The port one compression level below the configuration's."""

    def __init__(self, settings, device):
        super().__init__(dataclasses.replace(
            settings, compression_level=settings.compression_level - 1), device)


class StateUnchanged(Port):
    """A decompress step that returns its input unchanged."""

    def decompress(self, blob):
        return blob


class CompressUnchanged(Port):
    def compress(self, data):
        return data


class HalfTheBlocks(Port):
    """Half of the batch left out: the frame of the object's first half."""

    def compress(self, data):
        return super().compress(data[:len(data) // 2])


class HalfTheContent(Port):
    def decompress(self, blob):
        out = super().decompress(blob)
        return out[:len(out) // 2]


class TokenAltered(Port):
    """One byte of the first block's payload altered where it is made."""

    def compress(self, data):
        frame = bytearray(super().compress(data))
        size = int.from_bytes(frame[7:11], "little") & 0x7FFFFFFF
        frame[11 + size // 2] ^= 0x21
        return bytes(frame)


class ByteAltered(Port):
    def decompress(self, blob):
        out = bytearray(super().decompress(blob))
        out[len(out) // 3] ^= 1
        return bytes(out)


CONTROLS = [LinkedBlocks, LevelBelow]
FAULTS = [StateUnchanged, CompressUnchanged, HalfTheBlocks, HalfTheContent, TokenAltered,
          ByteAltered]
PORTS = {p.__name__: p for p in CONTROLS + FAULTS}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--port", nargs="+", choices=sorted(PORTS), default=["LinkedBlocks"])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for name in args.port:
        for seed in args.seeds:
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 torch.device("cuda", 0), time.perf_counter(),
                                 port_factory=PORTS[name])
            print(json.dumps({"workload": args.workload, "port": name, "seed": seed,
                              "correct": r["correct"], "failed": r["failed"],
                              "attempted": r["attempted"], "compared": r["compared"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
