"""The reduction of a `torch.profiler` trace of the window's round trips
to what the per-layer metrics read.

`Trace` holds the traced calls, each with its host span and the device's
intervals inside it (kernels, copies and sets, every stream), and the
host's own operations for naming the device's idle gaps.  The helpers
below are the arithmetic the metric readers share: unions of intervals,
rates over summed calls, and the roofline's bytes.  Times are in
microseconds, as the profiler gives them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# H100 SXM data sheet: HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12


@dataclass
class Call:
    """One traced call: ``kind`` "compress" or "decompress", its host span,
    the bytes it took and gave (``raw_bytes`` the object's,
    ``frame_bytes`` the frame's), and the device's intervals inside its
    span as (name, start, end)."""

    kind: str
    start: float
    end: float
    raw_bytes: int
    frame_bytes: int
    device: list = field(default_factory=list)

    @property
    def wall_us(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """The traced calls in order, and the host's operations as (name,
    start, end) over the same span."""

    calls: list
    host: list = field(default_factory=list)


def union_us(spans) -> float:
    """The time covered by the union of (start, end) intervals."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (0.0 if hi is None else hi - lo)


def is_copy(name: str) -> bool:
    """A copy between host and card."""
    return name.startswith(("Memcpy HtoD", "Memcpy DtoH"))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def calls_of(trace: Trace, kind: str) -> list:
    return [c for c in trace.calls if c.kind == kind]


def device_union_us(call: Call, keep=lambda name: True) -> float:
    """The union of the call's device intervals whose names ``keep``."""
    return union_us([(a, b) for n, a, b in call.device if keep(n)])


def idle_pct(trace: Trace, kind: str) -> float | None:
    """100 minus the device's busy share of the ``kind`` calls' summed
    wall time: the union of every device interval in each call."""
    calls = calls_of(trace, kind)
    wall = sum(c.wall_us for c in calls)
    if not calls or wall <= 0:
        return None
    return 100.0 * (1.0 - sum(device_union_us(c) for c in calls) / wall)


def copy_ms_per_gb(trace: Trace, kind: str) -> float | None:
    """The union of the ``kind`` calls' copies between host and card, in
    ms, per GB of the object."""
    calls = calls_of(trace, kind)
    raw = sum(c.raw_bytes for c in calls)
    if not calls or raw <= 0:
        return None
    return sum(device_union_us(c, is_copy) for c in calls) / 1e3 / (raw / 1e9)


def roofline_pct(trace: Trace, kind: str) -> float | None:
    """The share of the HBM bound in the ``kind`` calls' kernel time: the
    bytes each call needs (the object's and the frame's, each read or
    written once) at 3.35 TB/s, over the union of its kernel intervals."""
    calls = calls_of(trace, kind)
    busy = sum(device_union_us(c, is_kernel) for c in calls)
    if not calls or busy <= 0:
        return None
    need_us = sum(c.raw_bytes + c.frame_bytes for c in calls) / HBM_BYTES_PER_S * 1e6
    return 100.0 * need_us / busy


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time inside and between the calls summed by what the host was doing
    when each gap began (the call, and its innermost host operation), in
    seconds."""
    by_name = {}
    for c in trace.calls:
        for n, a, b in c.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    gaps = {}
    for label, lo, hi in _gaps(trace):
        op = _innermost(trace.host, lo)
        key = f"{label}: {op}" if op else label
        gaps[key] = gaps.get(key, 0.0) + (hi - lo) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[n[:120], s] for n, s in order(by_name)],
            "idle_gaps": [[n[:120], s] for n, s in order(gaps)]}


def _gaps(trace: Trace):
    """(label, start, end) of each stretch with no device interval, from
    the first call's start to the last call's end, cut where a call
    starts or ends; a stretch is labelled by its call, or "between
    calls"."""
    if not trace.calls:
        return
    spans = sorted((a, b) for c in trace.calls for _, a, b in c.device)
    edges = sorted({x for c in trace.calls for x in (c.start, c.end)})
    t, end = trace.calls[0].start, trace.calls[-1].end
    for a, b in spans + [(end, end)]:
        if a > t:
            cuts = [t] + [x for x in edges if t < x < min(a, end)] + [min(a, end)]
            for lo, hi in zip(cuts, cuts[1:]):
                yield _label(trace, lo), lo, hi
        t = max(t, b)


def _label(trace: Trace, t: float) -> str:
    for c in trace.calls:
        if c.start <= t < c.end:
            return c.kind
    return "between calls"


def _innermost(host, t: float) -> str | None:
    best = None
    for n, a, b in host:
        if a <= t < b and (best is None or a >= best[1]):
            best = (n, a)
    return best[0] if best else None
