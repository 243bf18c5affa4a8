"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, their configurations, traffic
and metrics are in BENCHMARK.json; `benchmark/harness.py` says what a run
does.  With --trace 0 the line carries the cell's end-to-end metrics,
with --trace 1 its per-layer metrics from a profiler trace of the first
round trips.  The last line of standard output is one JSON object; the
numbers compared for `correct` are also the last lines of standard error.
Exits non-zero with no result where CUDA has fewer devices than the cell
asks for, the port is missing, or JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# CUDA's JIT cache of any PTX it meets, at a fixed path in the checkout
# beside the port's own build directory
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.load_spec()
    chips = harness.workload(spec, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        import lz4_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port is missing ({e})", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), STARTED, spec)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}, which the port must not use",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
