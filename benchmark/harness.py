"""The benchmark of the PyTorch/CUDA port, `lz4_tpu_torch`.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name `BENCHMARK.json` gives it:
`configs/<name>.json` (the `EncoderSettings` fields, the source, what was
assumed and cut), `traffic/<name>.json` (the object's parts, read by
`traffic.make_object`), `metrics/<name>.py` (a `read(trace)` that returns
the metric, or None where it finds nothing to read).

A run is one caller in a closed loop over one object made from the seed:
each step compresses the object with `frame.compress` and decompresses
the frame it got with `frame.decompress`, bytes in and bytes out on the
host, each call timed from call to return.  Set-up (CUDA, the kernels'
libraries, the object, one warm round trip) comes first and is not timed
with the calls.  After the window each distinct frame (a sample of them
drawn from the seed where they differ) goes to the plain reference
(`reference.check_frame`), and every decompressed object was compared
with the object as it came.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import importlib
import importlib.util
import json
import os
import random
import sys
import time
import traceback
from pathlib import Path

from benchmark import reference, traffic
from benchmark.trace import Call, Trace, breakdown, union_us

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACED_ROUND_TRIPS = 2  # round trips under the profiler, per attempt
TRACE_ATTEMPTS = 3  # traces taken while one comes up short
SAMPLED_FRAMES = 2  # distinct frames checked, where the frames differ
FORBIDDEN = ("jax", "jaxlib", "flax", "lz4_tpu")  # whole top-level names
LOOP = ["compress", "decompress"]  # a step's calls, in order
SLOW_WARM_UP_S = 6.0  # a warm round trip takes 1-3 s once the kernels are built (lz4 -9: ~12)
# each number compared for `correct`: its limit, and whether that is a
# maximum or a minimum; every count of faults is exact
LIMITS = {"frame_faults": (0, "max"), "block_faults": (0, "max"),
          "decompress_wrong": (0, "max"), "calls_raised": (0, "max"),
          "frames_checked": (1, "min")}


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    return json.loads((bench / kind / f"{name}.json").read_text())


def load_metric(name: str, bench: Path = BENCH):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, section: str, name: str) -> list:
    """The ``section`` metrics ("end_to_end" or "per_layer") that cell
    ``name`` reports."""
    return [m for m in spec[section] if name in m.get("workloads", [name])]


def encoder_settings(config: dict):
    """The config file's `EncoderSettings` fields as settings."""
    from lz4_tpu_torch.frame import EncoderSettings

    names = {f.name for f in dataclasses.fields(EncoderSettings)}
    return EncoderSettings(**{k: v for k, v in config.items() if k in names})


class Port:
    """The system under test: the port's one-shot frame calls on one
    device, with the cell's settings."""

    def __init__(self, settings, device):
        from lz4_tpu_torch import frame

        self.frame, self.settings, self.device = frame, settings, device

    def compress(self, data: bytes) -> bytes:
        return self.frame.compress(data, self.settings, device=self.device)

    def decompress(self, blob: bytes) -> bytes:
        return self.frame.decompress(blob, device=self.device)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _Outputs:
    """What the window's calls produced, kept for the check: the distinct
    frames (a reservoir drawn from the seed once there are more than
    `SAMPLED_FRAMES`), how many calls gave each, and the calls whose
    decompressed bytes differ from the object or that raised."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.frames = []  # [frame, calls that gave it]
        self.distinct = 0
        self.decompress_wrong = 0
        self.raised = 0
        self.frame_bytes = 0

    def frame(self, blob: bytes) -> None:
        self.frame_bytes += len(blob)
        for entry in self.frames:
            if entry[0] == blob:
                entry[1] += 1
                return
        self.distinct += 1
        if len(self.frames) < SAMPLED_FRAMES:
            self.frames.append([blob, 1])
            return
        k = self.rng.randrange(self.distinct)
        if k < SAMPLED_FRAMES:
            self.frames[k] = [blob, 1]


def _counters(table: list) -> dict:
    """The port's launch counters now, per kernel name (summed over the
    counters that launch it), from ``launch_counters.json``'s table."""
    got = {}
    for entry in table:
        try:
            value = importlib.import_module(entry["module"])
            for part in entry["attr"].split("."):
                value = getattr(value, part)
        except (ImportError, AttributeError):
            continue  # a counter the program no longer has checks nothing
        if isinstance(value, dict):
            for name, n in value.items():
                if name not in entry["skip"]:
                    got[name] = got.get(name, 0) + n
        else:
            got[entry["kernel"]] = got.get(entry["kernel"], 0) + value
    return got


def _short(calls: list, launched: list) -> list:
    """Why a trace is short: a call that recorded fewer kernels of a name
    than the counters say it launched, or fewer device operations than
    another call of its kind."""
    why = []
    most = {}
    for c in calls:
        most[c.kind] = max(most.get(c.kind, 0), len(c.device))
    for i, (c, want) in enumerate(zip(calls, launched)):
        for name, n in want.items():
            got = sum(name in d for d, _, _ in c.device)
            if got < n:
                why.append(f"call {i} ({c.kind}): {got} of {n} {name}")
        if len(c.device) < most[c.kind]:
            why.append(f"call {i} ({c.kind}): {len(c.device)} of {most[c.kind]} device operations")
    return why


def _traced_round_trips(port, obj: bytes, outputs: _Outputs, times: dict):
    """`TRACED_ROUND_TRIPS` round trips under `torch.profiler`, taken
    again while the trace comes up short: (the `Trace`, its window in
    seconds, the reasons it is short, empty where it is whole).  Every
    call's output is kept for the check, and its time counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    table = json.loads((BENCH / "launch_counters.json").read_text())["counters"]
    t, window_s, why = None, 0.0, ["not traced"]
    for _ in range(TRACE_ATTEMPTS):
        marks, launched = [], []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACED_ROUND_TRIPS):
                for kind in ("compress", "decompress"):
                    before = _counters(table)
                    with record_function(f"benchmark.{kind}"):
                        blob = _call(port, kind, obj if kind == "compress" else blob,
                                     obj, outputs, times)
                    after = _counters(table)
                    launched.append({k: n - before.get(k, 0) for k, n in after.items()
                                     if n > before.get(k, 0)})
                    marks.append(len(blob) if kind == "compress" else 0)
                    if blob is None:
                        return None, 0.0, ["a traced call raised"]
            torch.cuda.synchronize()
        spans, host, device = [], [], []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CPU:
                if e.name.startswith("benchmark."):
                    spans.append((start, end, e.name[len("benchmark."):]))
                else:
                    host.append((e.name, start, end))
            elif not getattr(e, "is_user_annotation", False) and \
                    not e.name.startswith("benchmark."):
                device.append((e.name, start, end))
        spans.sort()
        if len(spans) != len(marks):
            why = [f"{len(spans)} of {len(marks)} call spans recorded"]
            continue
        calls = []
        frame_bytes = 0
        for (start, end, kind), made in zip(spans, marks):
            frame_bytes = made or frame_bytes  # a decompress reads the frame made before it
            calls.append(Call(kind, start, end, len(obj), frame_bytes,
                              [d for d in device if start <= d[1] < end]))
        why = _short(calls, launched)
        t = Trace(calls, host)
        window_s = (calls[-1].end - calls[0].start) / 1e6
        if not why:
            break
    return t, window_s, why


def _call(port, kind: str, arg: bytes, obj: bytes, outputs: _Outputs, times: dict):
    """One timed call; its output checked against the object where that
    is cheap (decompress), kept where it is not (compress).  None where
    it raised."""
    t0 = time.perf_counter()
    try:
        out = getattr(port, kind)(arg)
    except Exception:  # a failed call is counted and the run goes on
        traceback.print_exc()
        outputs.raised += 1
        return None
    times[kind].append(time.perf_counter() - t0)
    if kind == "compress":
        outputs.frame(out)
    elif out != obj:
        outputs.decompress_wrong += 1
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             started: float, spec: dict | None = None, bench: Path = BENCH,
             port_factory=Port, workers: int | None = None) -> dict:
    """One run of cell ``name``: the result line's object, the numbers
    compared last.  ``started`` is the process's start on
    `time.perf_counter`'s clock; ``port_factory(settings, device)`` makes
    the system under test."""
    import torch

    entered = time.perf_counter()
    spec = spec or load_spec(bench.parent)
    cell = workload(spec, name)
    config = load_json("configs", cell["config"], bench)
    mix = load_json("traffic", cell["traffic"], bench)
    if mix.get("callers", 1) != 1 or mix.get("calls", LOOP) != LOOP:
        raise ValueError(f"{cell['traffic']}: the harness runs one caller, calls {LOOP}")
    settings = encoder_settings(config)
    port = port_factory(settings, device)
    obj = traffic.make_object(mix, seed)
    made = time.perf_counter()

    # set-up: one warm round trip of the cell's own calls; where it takes
    # far longer than it should, the host's stacks go to standard error
    outputs = _Outputs(seed)
    warm = {"compress": [], "decompress": []}
    faulthandler.dump_traceback_later(SLOW_WARM_UP_S, file=sys.stderr)
    try:
        blob = _call(port, "compress", obj, obj, outputs, warm)
        if blob is not None:
            _call(port, "decompress", blob, obj, outputs, warm)
    finally:
        faulthandler.cancel_dump_traceback_later()
    outputs = _Outputs(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started

    times = {"compress": [], "decompress": []}
    deadline = time.perf_counter() + seconds
    tr = window_s = None
    why = []
    if trace:
        tr, window_s, why = _traced_round_trips(port, obj, outputs, times)
    while time.perf_counter() < deadline:
        blob = _call(port, "compress", obj, obj, outputs, times)
        if blob is not None:
            _call(port, "decompress", blob, obj, outputs, times)

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0)}
    del port, blob
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window
    ref_settings = {k: getattr(settings, k) for k in
                    ("compression_level", "block_size", "chain_blocks", "block_checksum",
                     "content_checksum", "content_length")}
    nworkers = workers or min(8, os.cpu_count() or 1)
    checked = time.perf_counter()
    frame_faults = block_faults = failed_calls = 0
    for blob, count in outputs.frames:
        got = reference.check_frame(blob, obj, ref_settings, nworkers)
        frame_faults += got["frame_faults"]
        block_faults += got["block_faults"]
        if got["frame_faults"] or got["block_faults"]:
            failed_calls += count
            for fault in got["faults"]:
                print(f"reference: {fault}", file=sys.stderr)
    checked = time.perf_counter() - checked
    attempted = len(times["compress"]) + len(times["decompress"]) + outputs.raised
    compared = {
        "frame_faults": frame_faults,
        "block_faults": block_faults,
        "decompress_wrong": outputs.decompress_wrong,
        "calls_raised": outputs.raised,
        "frames_checked": len(outputs.frames) if times["compress"] else 0,
    }
    correct = all(compared[k] <= lim if how == "max" else compared[k] >= lim
                  for k, (lim, how) in LIMITS.items())

    metrics = {}
    if not trace:
        values = {}
        if times["compress"]:
            values["compress_GBps"] = len(obj) * len(times["compress"]) / sum(times["compress"]) / 1e9
            values["ratio"] = len(obj) * len(times["compress"]) / outputs.frame_bytes
        if times["decompress"]:
            values["decompress_GBps"] = len(obj) * len(times["decompress"]) / sum(times["decompress"]) / 1e9
        values["setup_s"] = setup_s
        for m in metrics_of(spec, "end_to_end", name):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif tr is not None:
        if why:
            for w in why:
                print(f"trace short: {w}", file=sys.stderr)
        else:
            for m in metrics_of(spec, "per_layer", name):
                value = load_metric(m["name"], bench).read(tr)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            info["busy_s"] = union_us([(a, b) for c in tr.calls for _, a, b in c.device]) / 1e6
            info["window_s"] = window_s
    result = {"correct": correct, "attempted": attempted,
              "failed": outputs.decompress_wrong + outputs.raised + failed_calls,
              "metrics": metrics, "device": info}
    if trace and tr is not None and not why:
        result["breakdown"] = breakdown(tr)
    per_call = {k: [round(t, 4) for t in v[:6]] for k, v in times.items()}
    print(f"setup: {entered - started:.2f} s to the harness (torch, CUDA), the object "
          f"{made - entered:.2f} s, the warm round trip {started + setup_s - made:.2f} s; "
          f"the check {checked:.2f} s", file=sys.stderr)
    print(f"calls: {len(times['compress'])} compress, {len(times['decompress'])} decompress; "
          f"first seconds {per_call}; warm-up {warm}; distinct frames {outputs.distinct}",
          file=sys.stderr)
    for k, (lim, how) in LIMITS.items():
        print(f"compared {k} {compared[k]} limit {'<=' if how == 'max' else '>='} {lim}",
              file=sys.stderr)
    result["compared"] = {k: {"value": compared[k], "limit": lim, "is": f"{how}imum"}
                          for k, (lim, how) in LIMITS.items()}
    return result
