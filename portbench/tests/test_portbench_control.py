"""The control of each cell's check, on the card at the cell's own size:
the plain reference computed with its linear layers in fp8 (the
precision below the configuration's bf16), put in the program's place,
must fail one of the cell's numbers where the program passes them all:
the tokens the control puts first, on the requests the program served,
lie further below the float32 reference's best than the limit.

A short window at the cell's own load is enough: the readings need the
requests it finishes, not its timing.  On the
card:

    python3 -m pytest -q -m cuda portbench/tests/test_portbench_control.py

and, for the readings a limit is set from (a dozen seeds or more):

    python3 -m portbench.tests.test_portbench_control \
        --workload <cell> --seeds 1,2,3 [--seconds 15]

which prints one JSON line a seed: the program's numbers and the
control's.
"""
import argparse
import json
import sys
import time

import pytest

from portbench import catalog

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
SECONDS = 15.0


def readings(name: str, seed: int, seconds: float = SECONDS) -> dict:
    import torch
    sys.path.insert(0, str(catalog.REPO / "src"))
    cell = catalog.workload(name)
    rec = catalog.driver(cell["driver"]).run(
        cell, catalog.config(cell["config"]), catalog.mix(cell["traffic"]),
        seed, seconds, False, torch.device("cuda", 0), time.perf_counter(),
        control=True)
    out = {"cell": name, "seed": seed,
           "program": {k: c["value"] for k, c in rec.checks.items()},
           "control": rec.control,
           "limits": {k: c["limit"] for k, c in rec.checks.items()}}
    del rec
    torch.cuda.empty_cache()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in SEEDS:
        r = readings(name, seed)
        lim = r["limits"]
        assert all(r["program"][k] <= lim[k] for k in lim), r
        assert any(r["control"][k] > lim[k] for k in lim), r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="control readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=SECONDS)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
