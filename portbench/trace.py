"""A profiled slice, reduced to what the per-layer metrics read.

The harness marks each unit of work it drives (a serving tick, a
training step) with a ``torch.profiler.record_function`` span named
``portbench.<unit>``.  ``digest`` keeps, in the profiler's microseconds,
those spans, every device operation (name, start, end) and every host
operation (name, start, end), and drops the profiler.  The program has
no spans of its own yet, so host time is attributed to the innermost
host operation the profiler recorded.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def digest(prof, unit: str) -> Dict:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host, units = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # a span's device-side twin (a user annotation) is no work
            if not e.name.startswith("portbench."):
                kernels.append((e.name, start, end))
        elif e.name == f"portbench.{unit}":
            units.append((start, end))
        else:
            host.append((e.name, start, end))
    kernels.sort(key=lambda k: k[1])
    units.sort()
    return {"kernels": kernels, "host": host, "units": units}


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def window(d: Dict) -> Interval:
    """From the first unit's start to the last unit's end."""
    return d["units"][0][0], d["units"][-1][1]


def busy_us(d: Dict, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some device operation ran."""
    total = 0.0
    for a, b in merged((s, e) for _, s, e in d["kernels"]):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            total += b - a
    return total


def unit_device_spans(d: Dict) -> List[Optional[Interval]]:
    """Each unit's device span: the first start to the last end of the
    device operations that start inside it (None where none does)."""
    starts = [s for _, s, _ in d["kernels"]]
    out = []
    for a, b in d["units"]:
        i, j = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        if i == j:
            out.append(None)
        else:
            out.append((starts[i], max(e for _, _, e in d["kernels"][i:j])))
    return out


def device_ops(d: Dict, top: int = 10) -> List[List]:
    """The device operations that took most time: [name, seconds]."""
    by: Dict[str, float] = defaultdict(float)
    for name, s, e in d["kernels"]:
        by[name] += e - s
    return [[n[:200], us / 1e6] for n, us in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(d: Dict, top: int = 10) -> List[List]:
    """Device idle time inside the slice, by what the host was doing in
    each gap (the innermost host operation around the gap's middle, or
    ``python`` where no operation was open): [what, seconds], largest
    first."""
    lo, hi = window(d)
    busy = merged((s, e) for _, s, e in d["kernels"])
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    host = sorted(d["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    by: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        # the innermost open operation began recently: look back a bounded
        # number of operations, not over the whole slice
        inner = [(e - s, n) for n, s, e in host[max(0, i - 256):i]
                 if e >= mid]
        by[min(inner)[1] if inner else "python"] += b - a
    return [[n[:200], us / 1e6] for n, us in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]
