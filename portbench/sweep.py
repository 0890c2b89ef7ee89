"""Find a Poisson cell's knee once, by a sweep of offered rates on the
chip: the highest rate at which the engine's queue does not grow over
the window.

    python3 -m portbench.sweep --workload <cell> --rates 4,5,6 \
        [--seconds 30] [--seed 1]

Each rate is one run of the cell (its warm-up, then the window) in this
process; a line a rate gives the queue at the window's start and end,
the tokens per second and the tails.  The cell's file keeps the rate
chosen from it (about four fifths of the knee).
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from portbench import catalog, readers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(catalog.REPO / "src"))
    import torch
    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA device", file=sys.stderr)
        return 2
    base = catalog.workload(args.workload)
    conf = catalog.config(base["config"])
    mix = catalog.mix(base["traffic"])
    drv = catalog.driver(base["driver"])
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell["traffic_params"]["rate_per_s"] = rate
        rec = drv.run(cell, conf, mix, args.seed, args.seconds, False,
                      torch.device("cuda", 0), time.perf_counter())
        tk = rec.ticks
        w0, w1 = rec.window
        inside = tk[(tk[:, 1] >= w0) & (tk[:, 1] <= w1)]
        print(json.dumps({
            "rate": rate, "queue_start": int(inside[0, 4]),
            "queue_end": int(inside[-1, 4]),
            "queue_max": int(inside[:, 4].max()),
            "out_tok_s": readers.out_tok_s(rec),
            "ttft_p95_ms": readers.ttft_p95_ms(rec),
            "tpot_p95_ms": readers.tpot_p95_ms(rec),
            "queue_wait_p95_ms": readers.queue_wait_p95_ms(rec),
            "tick_ms_median": float(1e3 * sorted(inside[:, 1] - inside[:, 0])
                                    [len(inside) // 2]),
            "correct": rec.correct}), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
