#!/usr/bin/env python3
"""Peak memory of the plain recurrences' forward and backward, step loop
against block form, at a train_4k cell's per-device shapes.

    PYTHONPATH=src python3 tools/recurrence_peak.py [--block L ...]

The dry-run (``python -m repro_torch.launch.dryrun``) runs a train cell's
microbatches with each rank's shards on the ``meta`` device and counts
the bytes of local storage alive at once (``launch.dryrun._Counter``).
This tool does the same for one recurrence alone: forward and the
backward of a sum, on ``meta`` tensors of one microbatch's per-device
shard (rwkv6-1.6b and recurrentgemma-2b x train_4k x 16x16: 2 rows of
4096 steps on 2 of 32 heads, and 1 row on 160 of 2560 RG-LRU channels),
for the witnesses ``wkv6_ref`` and ``rglru_ref`` (a Python loop over T,
which the model's plain path ran before) and the forms the plain path
runs now, ``wkv6_blocks`` (at each ``--block``) and ``rglru_doubling``.
It prints one JSON line a form: its peak bytes and its op count.  No
card and no storage: every number is counted from shapes.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels.rglru_scan import rglru_doubling, rglru_ref
from repro_torch.kernels.rwkv6_scan import BLOCK, wkv6_blocks, wkv6_ref
from repro_torch.launch.dryrun import _Counter

#: one microbatch's shard a device, train_4k on the 16x16 mesh
WKV_SHAPE = (4, 4096, 64)        # (B x heads, T, head size)
RGLRU_SHAPE = (1, 4096, 160)     # (B, T, channels)


def _peak(fn, inputs) -> dict:
    leaves = [t.requires_grad_() for t in inputs]
    counter = _Counter(leaves)
    ops = 0

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal ops
            ops += 1
            return func(*args, **(kwargs or {}))

    with counter.mode, Count():
        outs = fn(*leaves)
        total = sum(o.sum() for o in outs)
        torch.autograd.grad(total, leaves)
    return {"peak_bytes": counter.peak,
            "inputs_bytes": sum(t.numel() * t.element_size()
                                for t in leaves),
            "ops": ops}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block", type=int, nargs="*", default=[BLOCK])
    args = ap.parse_args()
    meta = dict(dtype=torch.float32, device="meta")
    BH, T, N = WKV_SHAPE

    def wkv_inputs():
        return [torch.empty((BH, T, N), **meta) for _ in range(4)] + [
            torch.empty((BH, 1, N), **meta), torch.empty((BH, N, N), **meta)]

    rows = [("wkv6_ref", None, lambda *a: wkv6_ref(*a))]
    rows += [("wkv6_blocks", L,
              lambda *a, L=L: wkv6_blocks(*a, block=L)) for L in args.block]
    for name, L, fn in rows:
        out = {"form": name, "shape": list(WKV_SHAPE), "block": L,
               **_peak(fn, wkv_inputs())}
        print(json.dumps(out), flush=True)
    B, T, W = RGLRU_SHAPE
    for name, fn in (("rglru_ref", rglru_ref),
                     ("rglru_doubling", rglru_doubling)):
        inputs = [torch.empty((B, T, W), **meta) for _ in range(2)] + [
            torch.empty((B, W), **meta)]
        print(json.dumps({"form": name, "shape": list(RGLRU_SHAPE),
                          **_peak(fn, inputs)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
