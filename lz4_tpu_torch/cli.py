"""Command-line interface: compress and decompress `.lz4` files on the
card, and time round trips.  The port of `lz4_tpu/cli.py`, with
``--device`` (default cuda; cpu runs the plain versions) in place of
``--backend`` and ``-T``.

Usage:
    python -m lz4_tpu_torch compress   [-l LEVEL] [-B {4,5,6,7}] [-BD] [-BX]
                                       [--no-content-checksum] [--store-size]
                                       [--device D] IN [OUT]
    python -m lz4_tpu_torch decompress [--device D] IN [OUT]
    python -m lz4_tpu_torch roundtrip  [-l LEVEL] [--device D] FILES...
    python -m lz4_tpu_torch pickle     [-l LEVEL] [--device D] IN [OUT]
    python -m lz4_tpu_torch unpickle   [--device D] IN [OUT]

IN/OUT accept "-" for stdin/stdout; with IN="-" and no OUT the result
goes to stdout.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import frame, pickler
from .constants import BLOCK_SIZE_CODES
from .frame.descriptor import EncoderSettings


def _read(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str | None, data: bytes, default: str):
    path = path or default
    if path == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lz4_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")

    c = sub.add_parser("compress", help="compress a file into an LZ4 frame")
    c.add_argument("input")
    c.add_argument("output", nargs="?")
    c.add_argument("-l", "--level", type=int, default=0, help="0=fast, 3-9 HC, 10-12 OPT")
    c.add_argument("-B", "--block-size-code", type=int, choices=(4, 5, 6, 7), default=4)
    c.add_argument("-BD", "--dependent-blocks", action="store_true",
                   help="chained (dependent) blocks [default: independent]")
    c.add_argument("-BX", "--block-checksum", action="store_true")
    c.add_argument("--no-content-checksum", action="store_true")
    c.add_argument("--store-size", action="store_true")
    device(c)

    d = sub.add_parser("decompress", help="decompress LZ4 frame(s)")
    d.add_argument("input")
    d.add_argument("output", nargs="?")
    device(d)

    r = sub.add_parser("roundtrip", help="compress+decompress, verify, report")
    r.add_argument("files", nargs="+")
    r.add_argument("-l", "--level", type=int, default=0)
    device(r)

    pk = sub.add_parser("pickle", help="pickle a file (self-contained blob)")
    pk.add_argument("input")
    pk.add_argument("output", nargs="?")
    pk.add_argument("-l", "--level", type=int, default=0)
    device(pk)

    up = sub.add_parser("unpickle", help="unpickle a blob")
    up.add_argument("input")
    up.add_argument("output", nargs="?")
    device(up)

    a = p.parse_args(argv)

    if a.cmd == "compress":
        data = _read(a.input)
        settings = EncoderSettings(
            compression_level=a.level,
            block_size=BLOCK_SIZE_CODES[a.block_size_code],
            chain_blocks=a.dependent_blocks,
            block_checksum=a.block_checksum,
            content_checksum=not a.no_content_checksum,
        )
        blob = frame.compress(data, settings=settings, store_size=a.store_size,
                              device=a.device)
        # stdin input with no explicit output goes to stdout
        _write(a.output, blob, "-" if a.input == "-" else a.input + ".lz4")
        print(
            f"{a.input}: {len(data)} -> {len(blob)} bytes "
            f"({100.0 * len(blob) / max(1, len(data)):.2f}%)",
            file=sys.stderr,
        )
    elif a.cmd == "decompress":
        blob = _read(a.input)
        data = frame.decompress(blob, device=a.device)
        default = (
            "-"
            if a.input == "-"
            else a.input[:-4] if a.input.endswith(".lz4") else a.input + ".out"
        )
        _write(a.output, data, default)
        print(f"{a.input}: {len(blob)} -> {len(data)} bytes", file=sys.stderr)
    elif a.cmd == "roundtrip":
        for path in a.files:
            data = _read(path)
            t0 = time.perf_counter()
            blob = frame.compress(
                data, settings=EncoderSettings(compression_level=a.level),
                device=a.device,
            )
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = frame.decompress(blob, device=a.device)
            t_dec = time.perf_counter() - t0
            ok = back == data
            mb = len(data) / 1e6
            print(
                f"{path}: {len(data)} -> {len(blob)} "
                f"({100.0 * len(blob) / max(1, len(data)):.2f}%) "
                f"enc {mb / max(t_enc, 1e-9):.1f} MB/s "
                f"dec {mb / max(t_dec, 1e-9):.1f} MB/s "
                f"{'OK' if ok else 'MISMATCH'}"
            )
            if not ok:
                return 1
    elif a.cmd == "pickle":
        data = _read(a.input)
        blob = pickler.pickle(data, level=a.level, device=a.device)
        _write(a.output, blob, "-" if a.input == "-" else a.input + ".lz4pickle")
    elif a.cmd == "unpickle":
        blob = _read(a.input)
        _write(a.output, pickler.unpickle(blob, device=a.device),
               "-" if a.input == "-" else a.input + ".out")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
