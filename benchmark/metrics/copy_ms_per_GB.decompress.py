"""Batch (parallel/blocks.py: the upload, the packed rows and the content
copied back): the union of the decompress calls' copies between host and card,
in ms per GB of the object; moves decompress_GBps."""

from benchmark import trace


def read(t: trace.Trace) -> float | None:
    return trace.copy_ms_per_gb(t, "decompress")
