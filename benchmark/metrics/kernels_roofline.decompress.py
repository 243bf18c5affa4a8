"""Kernels (ops/: D, the HC passes, A's passes, E): the object's and the
frame's bytes at 3.35 TB/s over the union of the decompress calls' kernel
intervals; moves decompress_GBps."""

from benchmark import trace


def read(t: trace.Trace) -> float | None:
    return trace.roofline_pct(t, "decompress")
