#!/usr/bin/env python3
"""Level 12's passes on one card: the match pass's work budgets and the
parse pass's time by kind of data.

    python3 opt12bench.py [--seed 1]

Payloads as kernel D's windows: 16 MiB of the bench mix
(`chip_smoke.make_corpus`, the seed chip_smoke.py's level 12 paths use) as
256 independent 64 KB rows and as 256 chained windows, and two long
repeats of 4 MiB as independent rows, one byte and a 3-byte pattern (no
unbounded budget there: every position would measure the repeat at each
of up to 16,384 chain steps).  For each budget setting
(`encode_opt.opt_matches`: first-round budget, budget) the searches
given up and the device time of the match and parse passes
(profiler), every output equal to the serial OPT arm's (also timed); then,
on the mix, the parse pass's time on all rows and on each quarter of
them.  Prints one JSON line per payload, then the card's name and power
limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import chip_smoke as cs

BLOCK = 65536
SETTINGS = ((1024, 1024), (65536, 65536), (1024, 65536))
UNBOUNDED = (1 << 30, 1 << 30)


def _counts(*passes):
    """A reader of the launch counts of level 12's passes (`encode_opt`'s
    wrappers), keyed by kernel name, for `chip_smoke._device_ms_by`."""
    from lz4_tpu_torch.ops import encode_opt

    return lambda: {f"{name}_rows": getattr(encode_opt, name).launches for name in passes}


def _windows(data: bytes, chained: bool):
    import torch

    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    if chained:
        return (payload, *cs.chained_windows(len(data), BLOCK))
    nb = len(data) // BLOCK
    return (payload, torch.arange(nb, dtype=torch.int64) * BLOCK,
            torch.zeros(nb, dtype=torch.int32), torch.full((nb,), BLOCK, dtype=torch.int32))


def _budgets(base, st, so, ln, dev, settings) -> dict:
    import torch
    from lz4_tpu_torch.ops import encode_opt, encode_stream

    base = base.to(dev)
    prev = encode_opt.opt_chain(base, st, ln)
    serial = encode_stream.encode_windows_opt_serial(base, st, so, ln, BLOCK, 12)
    out = {"serial_ms": cs._cuda_ms(lambda: encode_stream.encode_windows_opt_serial(
        base, st, so, ln, BLOCK, 12), 2), "settings": []}
    for first, budget in settings:
        def run():
            m = encode_opt.opt_matches(base, st, so, ln, prev, budget=budget,
                                       first_budget=first)
            return m, encode_opt.opt_parse(base, st, so, ln, prev, m, BLOCK)

        matches, got = run()
        torch.cuda.synchronize()
        cs._require(cs._max_abs_err(got, serial) == 0,
                    f"budgets {first}/{budget}: the passes' output != the serial arm's")
        ms, _ = cs._device_ms_by(run, _counts("opt_matches", "opt_parse"), 2)
        out["settings"].append({
            "first_budget": first, "budget": budget,
            "given_up": int((matches[:, 0] < 0).sum()),
            "matches_ms": ms["opt_matches_rows"], "parse_ms": ms["opt_parse_rows"]})
    return out


def _parse_by_quarter(base, st, so, ln, dev) -> dict:
    """The parse pass's device time on all rows and on each quarter of
    them (the mix's four kinds of data), each on its own tables."""
    from lz4_tpu_torch.ops import encode_opt

    base = base.to(dev)
    nb = st.numel()
    subsets = {"all": slice(0, nb)}
    subsets.update({f"quarter_{q}": slice(q * nb // 4, (q + 1) * nb // 4) for q in range(4)})
    times = {}
    for name, rows in subsets.items():
        r = (st[rows], so[rows], ln[rows])
        prev = encode_opt.opt_chain(base, r[0], r[2])
        matches = encode_opt.opt_matches(base, *r, prev)
        times[name] = cs._device_ms_by(
            lambda: encode_opt.opt_parse(base, *r, prev, matches, BLOCK),
            _counts("opt_parse"), 3)[0]["opt_parse_rows"]
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("opt12bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    mix = cs.make_corpus(16 << 20, args.seed)
    for name, data, chained in (
        ("mix_independent", mix, False), ("mix_chained", mix, True),
        ("one_byte_independent", b"\x00" * (4 << 20), False),
        ("three_byte_pattern_independent", (b"abc" * ((4 << 20) // 3 + 1))[:4 << 20], False),
    ):
        rows = _windows(data, chained)
        settings = SETTINGS + ((UNBOUNDED,) if name.startswith("mix") else ())
        report = {"payload": name, **_budgets(*rows, dev, settings)}
        if name.startswith("mix"):
            report["parse_ms_by_rows"] = _parse_by_quarter(*rows, dev)
        print(json.dumps(report), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
