"""Device (one H100): the share of the compress calls' wall time in which no
kernel, copy or set ran on any stream; moves compress_GBps."""

from benchmark import trace


def read(t: trace.Trace) -> float | None:
    return trace.idle_pct(t, "compress")
