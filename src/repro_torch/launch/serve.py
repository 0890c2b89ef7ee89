"""Serving launcher of the port: one continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen2.5-3b] \
        [--smoke] [--use-kernels] [--kv-quant] [--requests 6] [--max-new 12]

Serves the published config of ``--arch`` (random weights from seed 0)
on the card by default; ``--smoke`` takes the reduced sibling, and
``--device cpu`` runs on the CPU.  Nine archs serve: qwen2.5-3b,
qwen1.5-32b, phi3-medium-14b, gemma3-4b, granite-moe-1b-a400m,
moonshot-v1-16b-a3b, rwkv6-1.6b, recurrentgemma-2b and qwen2-vl-2b (text
only, with plain RoPE at the cache index, as the reference's decode).
whisper-medium fails with ``NotImplementedError`` before any weight is
drawn: the reference's ``ServeEngine`` has no enc-dec path.
``--use-kernels`` runs every hand-written CUDA kernel of the decode
path: the fused SwiGLU (dense and vlm MLPs, e.g. all 34 of gemma3-4b's
layers), the WKV6 recurrence (rwkv) and the RG-LRU recurrence (hybrid);
a MoE arch's experts are plain products, as in the reference, so its
decode runs no hand-written kernel.
Decode attention stays plain: the flash-attention kernel serves
attention without a cache (``forward``), and a decode query sits at a
per-slot position against a per-slot cache fill, which that kernel,
like the reference's, does not take (it counts query rows from 0).  The planner options of ``repro.launch.serve``
(``--plan``, ``--plan-store``, ``--tenants``) come with the planner slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import init_model, resolve_device
from repro_torch.runtime.serve_loop import (Request, ServeEngine,
                                          require_servable)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2.5-3b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=False, help="serve the reduced smoke config")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--use-kernels", action="store_true",
                    help="run the hand-written CUDA kernels of the path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              kv_quant=args.kv_quant,
                              use_kernels=args.use_kernels)
    require_servable(cfg)
    params = init_model(cfg, seed=0, device=device)
    engine = ServeEngine(params, cfg, batch_slots=args.slots,
                         max_len=args.max_len, device=device)
    for i in range(args.requests):
        engine.submit(Request(rid=i, prompt=[2 + i, 7, 3 * i + 1],
                              max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt*1e3:.0f} ms "
          f"({total/dt:.0f} tok/s, {engine.ticks} ticks, {args.slots} slots, "
          f"{cfg.name} on {device}, kv_quant={cfg.kv_quant}, "
          f"use_kernels={cfg.use_kernels})")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        print(f"  rid={r.rid} out={r.output}")


if __name__ == "__main__":
    main()
