"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root.  Reads the cell ``portbench/workloads/<cell>
.json``, its configuration and traffic mix, and ``BENCHMARK.json`` for
the metrics the cell reports (its end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``); puts ``src`` on the path, draws
the weights and the traffic from the seed, warms up, measures for
``--seconds``, checks the outputs against the plain reference and
prints one JSON line last on standard output.  The numbers compared,
each with its limit, are the last lines on standard error.

Exits 2, printing no result, without as many CUDA devices as the cell
asks for; 3 if JAX or the JAX package was loaded into the process; any
other failure raises.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from portbench import catalog  # noqa: E402

#: top-level module names that may not be loaded into a run
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``BANNED``, the whole
    name compared (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def measure(cell: Dict, conf: Dict, mix: Dict, seed: int, seconds: float,
            trace: bool, metrics: List[Dict], device, t0: float,
            **kwargs) -> Dict:
    """Drive the cell once on ``device`` and reduce the record to the
    result line's fields (``checks`` last)."""
    rec = catalog.driver(cell["driver"]).run(
        cell, conf, mix, seed, seconds, trace, device, t0, **kwargs)
    values = {}
    for m in metrics:
        v = catalog.metric_reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": rec.correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": values,
           "device": {"memory_peak_bytes": int(rec.memory_peak_bytes)}}
    if trace and rec.trace is not None:
        from portbench import trace as tr
        lo, hi = tr.window(rec.trace)
        out["device"].update(busy_s=tr.busy_us(rec.trace, lo, hi) / 1e6,
                             window_s=(hi - lo) / 1e6)
        out["breakdown"] = {"device_ops": tr.device_ops(rec.trace),
                            "idle_gaps": tr.idle_gaps(rec.trace)}
    out["record"] = rec
    out["checks"] = rec.checks
    return out


def _unit_ms(rec) -> Optional[Dict[str, float]]:
    """Median, 99th percentile and longest unit of work of the window (a
    tick, a step: the record's ``unit_s``)."""
    import numpy as np
    d = np.asarray(getattr(rec, "unit_s", ()), dtype=np.float64) * 1e3
    if not len(d):
        return None
    return {"median": float(np.median(d)),
            "p99": float(np.percentile(d, 99)), "max": float(d.max()),
            "n": int(len(d))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = catalog.workload(args.workload)
    conf = catalog.config(cell["config"])
    mix = catalog.mix(cell["traffic"])
    metrics = catalog.cell_metrics(catalog.benchmark(), cell["name"],
                                   bool(args.trace))
    sys.path.insert(0, str(catalog.REPO / "src"))

    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = measure(cell, conf, mix, args.seed, args.seconds,
                  bool(args.trace), metrics, device, T0)
    rec = out.pop("record")
    found = banned_modules()
    if found:
        print(f"loaded into the run: {', '.join(found)}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": cell["chips"], **out["device"]}
    out["checks"] = checks
    print(json.dumps({"run": cell["name"], "seed": args.seed,
                      "power": _power_limit(),
                      "queue_left": getattr(rec, "queue_left", None),
                      "late_s_max": float(rec.lateness.max(initial=0.0))
                      if hasattr(rec, "lateness") else None,
                      "setup_parts": getattr(rec, "setup_parts", None),
                      "unit_ms": _unit_ms(rec),
                      "checked_tokens": getattr(rec, "checked_tokens", None)}),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
