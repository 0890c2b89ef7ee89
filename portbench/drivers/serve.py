"""Serving cells: the program's ``ServeEngine`` under a traffic mix.

Set-up draws the weights on the device, builds the engine on the main
path (the kernels on, one CUDA graph a tick on the card) and runs one
idle tick, which builds or loads the kernel libraries and captures the
CUDA graph of the decode step.  Then the mix's requests arrive on their
schedule (an open loop: a request is submitted when it is due, whatever
the engine is doing) and the engine ticks; the first ``warmup_s``
seconds bring the slots to a steady occupancy, and the next
``seconds`` are the window.  Every request is timed from when it was
due, on the host's clock, at the return of the tick that produced each
token (a tick ends in a copy of the sampled tokens to the host).  The
traffic runs on past the window until every request due in it has its
first token, so that the time to first token is read over a set of
requests that the schedule fixes, not one that moves with the speed of
a tick.  With tracing on, the same traffic then runs on for
``TRACE_TICKS`` ticks under the profiler, so that profiling never
touches the window or those first tokens.

After the window the engine is freed and the plain reference reads the
requests it finished: a sample drawn from the seed, the longest among
them, and each served token's logit is held against the reference's
best at its position (the configuration family's ``served_gaps``).
The configuration's ``family`` (``families/<family>.py``) gives the
weights, the program's configuration, a token's FLOPs and the
reference; the mix's ``generator`` (``generators/<generator>.py``)
gives the requests.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import catalog, check, trace


@dataclasses.dataclass
class Served:
    """One request's life on the host's clock (seconds)."""
    rid: int
    due: float
    prompt_len: int
    max_new: int
    prompt: Optional[List[int]] = None
    output: Optional[List[int]] = None
    req: object = None
    submitted: float = math.nan
    admitted: float = math.nan
    first: float = math.nan
    last: float = math.nan
    finished: float = math.nan
    n_out: int = 0
    context: int = 0


#: seconds of arrivals offered past the window: the ticks until the last
#: request due in the window has its first token (a 1536-token prompt
#: takes 1536 ticks), and the profiled ticks after them, keep the
#: window's load
ARRIVALS_AFTER_S = 45.0

#: ticks profiled after the window in a traced run
TRACE_TICKS = 16


def _request_count(cell: Dict, seconds: float) -> int:
    tp = cell["traffic_params"]
    if "requests" in tp:
        return int(tp["requests"])
    horizon = cell["warmup_s"] + seconds + ARRIVALS_AFTER_S
    return int(math.ceil(tp["rate_per_s"] * horizon)) + 1


def run(cell: Dict, conf: Dict, mix: Dict, seed: int, seconds: float,
        trace_on: bool, device: torch.device, t0: float,
        control: bool = False) -> types.SimpleNamespace:
    """Drive the cell once; returns the record the metrics read, with
    ``correct`` and the numbers compared."""
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    clock = time.perf_counter
    parts = {"start": clock() - t0}
    B, max_len = cell["engine"]["slots"], cell["engine"]["max_len"]
    family = catalog.family(conf["family"])
    spec = family.spec(conf)
    cfg = family.port_config(conf)
    t = clock()
    w = family.draw(spec, seed, device, cfg.padded_vocab)
    _sync(device)
    parts["weights"] = clock() - t
    t = clock()
    engine = ServeEngine(family.port_params(w), cfg, B, max_len,
                         device=device, cuda_graph=device.type == "cuda")
    _sync(device)
    parts["engine"] = clock() - t
    t = clock()
    engine.step()                      # kernels, the graph: before traffic
    _sync(device)
    parts["first_tick"] = clock() - t

    offered = catalog.generator(mix["generator"]).requests(
        mix, _request_count(cell, seconds), seed, spec["vocab"], max_len,
        cell["traffic_params"].get("rate_per_s", 0.0))
    # what set-up made lives to the end: out of the collector's way, so
    # that its passes over the window's garbage stay short
    gc.collect()
    gc.freeze()
    t_start = clock()
    w0 = t_start + cell["warmup_s"]
    w1 = w0 + seconds
    recs = [Served(r.rid, t_start + r.offset, len(r.prompt), r.max_new)
            for r in offered]
    due_in = [s for s in recs if w0 <= s.due < w1]
    running: Dict[int, Served] = {}
    ticks: List[tuple] = []
    nxt = 0
    prof = None
    trace_left = TRACE_TICKS if trace_on else 0

    while True:
        now = clock()
        if (now >= w1 and prof is None
                and not any(math.isnan(s.first) for s in due_in)):
            if not trace_left:
                break
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        while nxt < len(offered) and recs[nxt].due <= now:
            s = recs[nxt]
            s.submitted = now
            s.prompt = offered[nxt].prompt.tolist()
            s.req = Request(rid=s.rid, prompt=s.prompt,
                            max_new_tokens=s.max_new)
            engine.submit(s.req)
            nxt += 1
        if not engine.queue and not any(engine.active):
            if nxt >= len(offered):
                raise RuntimeError(f"{cell['name']}: the traffic ran out "
                                   "before the window's requests were "
                                   "served")
            until = recs[nxt].due if now >= w1 else min(recs[nxt].due, w1)
            time.sleep(max(0.0, until - clock()))
            continue
        ta = clock()
        if prof is not None:
            with torch.profiler.record_function("portbench.tick"):
                finished = engine.step()
        else:
            finished = engine.step()
        tb = clock()
        tokens, work = _account(engine, finished, running, recs, family,
                                spec, ta, tb)
        ticks.append((ta, tb, tokens, work, len(engine.queue)))
        if prof is not None:
            trace_left -= 1
            if not trace_left:
                _sync(device)
                prof.stop()
                break

    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    queue_left = len(engine.queue)
    done = [s for s in recs if w0 <= s.finished <= w1]
    for s in recs:
        if s.req is not None:
            s.output, s.req = list(s.req.output), None
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    digest = trace.digest(prof, "tick") if prof is not None else None
    del prof

    outcome = check.served(cell, family, spec, w, done, seed, control)
    del w
    tk = np.array(ticks, dtype=np.float64).reshape(-1, 5)
    parts["warmup"] = w0 - t_start
    return types.SimpleNamespace(
        cell=cell, spec=spec, seconds=seconds, window=(w0, w1),
        setup_s=w0 - t0, requests=recs, ticks=tk,
        unit_s=[b - a for a, b in tk[:, :2] if w0 <= b <= w1],
        lateness=np.array([s.submitted - s.due for s in recs
                           if w0 <= s.due < w1]),
        queue_left=queue_left, setup_parts=parts,
        memory_peak_bytes=peak, trace=digest,
        attempted=sum(1 for s in recs
                      if w0 <= s.due < w1 or w0 <= s.admitted <= w1),
        **outcome)


def _account(engine, finished, running: Dict[int, Served],
             recs: List[Served], family, spec: Dict, ta: float, tb: float):
    """Book one tick: admissions, tokens and their times, finishes.
    Returns (output tokens produced, model FLOPs of the requests that
    held a slot)."""
    for r in [r for r in engine.active if r is not None] + finished:
        if r.rid not in running:
            s = recs[r.rid]
            s.admitted = ta
            running[r.rid] = s
    tokens, work = 0, 0.0
    for s in running.values():
        s.context += 1
        work += family.decode_token_flops(spec, s.context)
        n = len(s.req.output)
        if n > s.n_out:
            tokens += n - s.n_out
            s.n_out = n
            if math.isnan(s.first):
                s.first = tb
            s.last = tb
    for r in finished:
        running.pop(r.rid).finished = tb
    return tokens, work


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
