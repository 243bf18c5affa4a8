"""Device (one H100): the share of the decompress calls' wall time in which no
kernel, copy or set ran on any stream; moves decompress_GBps."""

from benchmark import trace


def read(t: trace.Trace) -> float | None:
    return trace.idle_pct(t, "decompress")
