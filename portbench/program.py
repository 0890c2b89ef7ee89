"""What the per-layer metrics read from inside the program: the serving
engine's log (``repro_torch.runtime.telemetry.last_serve_log``: counters,
a row a tick, a row a request, each section's device ms on the ticks a
profiler ran) and its ``serve.*`` host spans in the profiled slice.

The driver frees the engine before the metrics are read; its log
outlives it.  Times in the log are on the harness's clock
(``time.perf_counter``), so the window filters them as it filters the
driver's own.  Each function returns None where the run has nothing to
read: a program without the log, no tick or request in the window, no
instrumented tick (off the card), no profiled slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _log():
    try:
        from repro_torch.runtime.telemetry import last_serve_log
    except ImportError:
        return None
    return last_serve_log()


def _window_ticks(rec) -> Optional[Dict[str, np.ndarray]]:
    log = _log()
    if log is None:
        return None
    t = log.ticks()
    keep = (t["end"] >= rec.window[0]) & (t["end"] <= rec.window[1])
    return {k: v[keep] for k, v in t.items()}


def section_ms_per_tick(rec, section: str) -> Optional[float]:
    """Mean over the instrumented ticks (those a profiler ran) of
    ``section``'s device ms, summed over the decoder's layers."""
    log = _log()
    if log is None:
        return None
    ms = log.ticks()[section]
    ms = ms[~np.isnan(ms)]
    return float(ms.mean()) if len(ms) else None


def mixer_ms_per_tick(rec) -> Optional[float]:
    return section_ms_per_tick(rec, "mixer")


def ffn_ms_per_tick(rec) -> Optional[float]:
    return section_ms_per_tick(rec, "ffn")


def prefill_share(rec) -> Optional[float]:
    """The window's prompt slot-ticks over its prompt and output
    slot-ticks: the share of the slots' work that fed prompt tokens (%)."""
    t = _window_ticks(rec)
    if t is None:
        return None
    prompt, output = float(t["prompt"].sum()), float(t["output"].sum())
    return 100.0 * prompt / (prompt + output) if prompt + output else None


def prefill_p95_ms(rec) -> Optional[float]:
    """From admission into a slot to the return of the first token, 95th
    percentile over every request due in the window."""
    log = _log()
    if log is None:
        return None
    r = log.requests()
    row = {int(rid): i for i, rid in enumerate(r["rid"])}
    due = [row[s.rid] for s in rec.requests
           if rec.window[0] <= s.due < rec.window[1] and s.rid in row]
    ms = (r["first"][due] - r["admitted"][due]) * 1e3
    ms = ms[~np.isnan(ms)]
    return float(np.percentile(ms, 95)) if len(ms) else None


#: the engine's own host work in a tick: everything but the launch, the
#: wait for the device and the reading of the section timings
HOST_SPANS = ("serve.refill", "serve.feed", "serve.book")


def engine_host_ms(rec) -> Optional[float]:
    """Mean over the profiled ticks of the ``HOST_SPANS``' time (ms)."""
    if rec.trace is None or not rec.trace["units"]:
        return None
    us = [e - s for n, s, e in rec.trace["host"] if n in HOST_SPANS]
    return sum(us) / len(rec.trace["units"]) / 1e3 if us else None
