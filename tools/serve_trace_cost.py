#!/usr/bin/env python3
"""What tracing the serving tick costs on the card, at a benchmark
cell's shape.

    python3 tools/serve_trace_cost.py [--cells CELL ...] [--replays N]
        [--out FILE]

For each cell (``portbench/workloads/<cell>.json``: its configuration,
slots and positions; the weights drawn as the benchmark draws them) a
``ServeEngine`` is built with every slot holding a request, and its first
tick captures the plain and the instrumented graph.  Then, on the same
inputs and in turns, ``--replays`` replays of each graph are timed one by
one with CUDA events around them (the instrumented graph's extra event
nodes are its whole difference), the section timings are read after each
instrumented replay (the host time of ``serve.marks``, which a traced
tick spends while the next step runs), and their sum is held against the
replay's outer time.  Also reported: the memory the second capture
added to the shared pool (``memory_reserved`` around it), the card's
name and power limit, and, from 4 ticks under ``torch.profiler`` (2 of
them instrumented), the sections' mean and that the ``serve.*`` spans
are host ranges with no device-side copy.  One JSON object a cell goes
to standard output and, with ``--out``, to a file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=20)
    return out.stdout.strip().splitlines()[0]


def measure(name: str, replays: int, seed: int = 2**31 + 5) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import catalog
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cell = catalog.workload(name)
    conf = catalog.config(cell["config"])
    family = catalog.family(conf["family"])
    spec, cfg = family.spec(conf), family.port_config(conf)
    B, max_len = cell["engine"]["slots"], cell["engine"]["max_len"]
    dev = torch.device("cuda", 0)
    w = family.draw(spec, seed, dev, cfg.padded_vocab)
    engine = ServeEngine(family.port_params(w), cfg, B, max_len, device=dev)
    for i in range(B):
        engine.submit(Request(rid=i, prompt=[1 + i] * (max_len // 2),
                              max_new_tokens=8))

    reserved = {}
    marked = engine._marked_step

    def watched(cache):
        # the second call is the instrumented capture (the first, the
        # eager warm-up)
        key = "warmup" if "warmup" not in reserved else "capture"
        before = torch.cuda.memory_reserved(dev)
        out = marked(cache)
        reserved[key] = torch.cuda.memory_reserved(dev) - before
        return out

    engine._marked_step = watched
    t = time.perf_counter()
    engine.step()
    torch.cuda.synchronize(dev)
    first_tick_s = time.perf_counter() - t
    del engine._marked_step

    def timed(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    plain, inst, sums, marks_ms = [], [], [], []
    for _ in range(5):                       # warm both
        timed(engine._graph), timed(engine._igraph)
    for i in range(2 * replays):
        if i % 2:
            inst.append(timed(engine._igraph))
            t = time.perf_counter()
            ms = telemetry.section_ms(engine._marks)
            marks_ms.append((time.perf_counter() - t) * 1e3)
            sums.append(sum(ms))
        else:
            plain.append(timed(engine._graph))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            engine.step()
        torch.cuda.synchronize(dev)
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    host = [e.name for e in prof.events()
            if e.device_type == cpu and e.name.startswith("serve.")]
    twins = [e.name for e in prof.events()
             if e.device_type == cuda and e.name.startswith("serve.")]
    log = engine.log.ticks()
    last = {s: float(np.nanmean(log[s][-4:])) for s in telemetry.SECTIONS}
    med = statistics.median
    return {
        "cell": name, "power": _power(), "torch": torch.__version__,
        "slots": B, "max_len": max_len, "replays": replays,
        "first_tick_s": first_tick_s,
        "marks": len(engine._marks),
        "plain_ms": {"median": med(plain), "min": min(plain),
                     "max": max(plain)},
        "instrumented_ms": {"median": med(inst), "min": min(inst),
                            "max": max(inst)},
        "instrumented_extra_ms": med(inst) - med(plain),
        "sections_over_replay": med(s / t for s, t in zip(sums, inst)),
        "marks_host_ms": {"median": med(marks_ms), "max": max(marks_ms)},
        "capture_reserved_bytes": reserved.get("capture"),
        "profiled_sections_ms": last,
        "host_spans": sorted(set(host)), "host_span_count": len(host),
        "device_twins": sorted(set(twins)),
        "counters": engine.log.counters(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+",
                    default=["qwen2.5-3b.serve.chat",
                             "phi3-medium-14b.serve.batch"])
    ap.add_argument("--replays", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    rows = []
    for name in args.cells:
        rows.append(measure(name, args.replays))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
