"""Kernels (ops/: D, the HC passes, A's passes, E): the object's and the
frame's bytes at 3.35 TB/s over the union of the compress calls' kernel
intervals; moves compress_GBps."""

from benchmark import trace


def read(t: trace.Trace) -> float | None:
    return trace.roofline_pct(t, "compress")
