"""What the metric files read: each function takes a run's record and
returns the metric, or None where the run has nothing to read (no
request in the window, no profiled slice, no launch of the kernel)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from portbench import flops, trace


def _p95(values: List[float]) -> Optional[float]:
    return float(np.percentile(values, 95)) if values else None


def _in(rec, t: float) -> bool:
    return rec.window[0] <= t <= rec.window[1]


def setup_s(rec) -> float:
    return rec.setup_s


# -- serving: the host's clock over the window ------------------------------

def _window_ticks(rec) -> np.ndarray:
    tk = rec.ticks
    return tk[(tk[:, 1] >= rec.window[0]) & (tk[:, 1] <= rec.window[1])]


def out_tok_s(rec) -> float:
    """Output tokens returned in the window over its seconds."""
    return float(_window_ticks(rec)[:, 2].sum()) / rec.seconds


def _due_in(rec) -> List:
    """The requests due in the window (the driver serves each of them
    its first token before it stops)."""
    return [s for s in rec.requests
            if rec.window[0] <= s.due < rec.window[1]]


def ttft_p95_ms(rec) -> Optional[float]:
    """From due to the return of the first output token, over every
    request due in the window."""
    return _p95([(s.first - s.due) * 1e3 for s in _due_in(rec)])


#: served tokens a request needs for its time per output token: its
#: first-to-last span covers 31 ticks, over 250 ms of the host's clock
#: at any tick over 8 ms
TPOT_MIN_TOKENS = 32


def tpot_p95_ms(rec) -> Optional[float]:
    """Each request's time per output token after its first, (last -
    first) / (n - 1), over every request finished in the window that
    served ``TPOT_MIN_TOKENS`` or more."""
    return _p95([(s.last - s.first) / (s.n_out - 1) * 1e3
                 for s in rec.requests if _in(rec, s.finished)
                 and s.n_out >= TPOT_MIN_TOKENS])


def queue_wait_p95_ms(rec) -> Optional[float]:
    """From due to the start of the tick that admitted the request into
    a slot, over every request due in the window."""
    return _p95([(s.admitted - s.due) * 1e3 for s in _due_in(rec)])


def mfu(rec) -> Optional[float]:
    """Model FLOPs of the requests that held a slot in the window's
    ticks, over the window's seconds, as a share of the bf16 peak (%)."""
    work = float(_window_ticks(rec)[:, 3].sum())
    return 100.0 * work / rec.seconds / flops.PEAK_BF16_FLOPS if work else None


# -- serving: the profiled slice after the window -----------------------------

def host_gap_ms(rec) -> Optional[float]:
    """Mean over profiled ticks of the tick's host time minus its device
    span (first kernel start to last kernel end)."""
    if rec.trace is None:
        return None
    gaps = [(b - a) - (de - ds) for (a, b), sp in
            zip(rec.trace["units"], trace.unit_device_spans(rec.trace))
            if sp is not None for ds, de in [sp]]
    return float(np.mean(gaps)) / 1e3 if gaps else None


def device_ms_per_tick(rec) -> Optional[float]:
    """Device busy time (union of operations) over the profiled ticks,
    per tick."""
    if rec.trace is None or not rec.trace["kernels"]:
        return None
    lo, hi = trace.window(rec.trace)
    return trace.busy_us(rec.trace, lo, hi) / len(rec.trace["units"]) / 1e3


def device_idle(rec) -> Optional[float]:
    """Share of the profiled slice in which no device operation ran (%)."""
    if rec.trace is None or not rec.trace["kernels"]:
        return None
    lo, hi = trace.window(rec.trace)
    return 100.0 * (1.0 - trace.busy_us(rec.trace, lo, hi) / (hi - lo))


def fused_mlp_roofline(rec) -> Optional[float]:
    """Sum over the profiled ``fused_mlp`` calls of their bound (every
    call runs T = slots rows at the configuration's D and F) over the
    device time of every ``fused_mlp_kernel*`` (%)."""
    if rec.trace is None:
        return None
    ks = [(n, s, e) for n, s, e in rec.trace["kernels"]
          if "fused_mlp_kernel" in n]
    calls = sum(1 for n, _, _ in ks if "reduce" not in n)
    if not calls:
        return None
    spent = sum(e - s for _, s, e in ks) / 1e6
    bound = calls * flops.fused_mlp_bound_s(
        rec.cell["engine"]["slots"], rec.spec["d_model"], rec.spec["d_ff"])
    return 100.0 * bound / spent
