"""Serving launcher of the port: one continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen2.5-3b] \
        [--smoke] [--use-kernels] [--kv-quant] [--requests 6] [--max-new 12] \
        [--plan] [--plan-store DIR] [--device cuda|cpu] [--no-cuda-graph]
    PYTHONPATH=src python -m repro_torch.launch.serve --use-kernels \
        --tenants "qwen2.5-3b:2:1,rwkv6-1.6b:1" [--plan-store DIR]

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
like the reference's, does not take (it counts query rows from 0).

On the card each engine replays its decode step as one captured CUDA
graph a tick (``ServeEngine(cuda_graph=True)``); ``--no-cuda-graph`` runs
the eager step instead, for comparison, and ``--cuda-graph`` with
``--device cpu`` raises.

``--plan`` attaches the PipeOrgan accelerator plan of the decode step (a
``PlanRequest`` of ``decode_graph`` through the shared planner facade,
priced by the torch engine on the engine's device: the CUDA
``price_rows`` on the card, its plain version with ``--device cpu``);
with ``--plan-store`` the plan is admitted from / saved to a directory of
``PlanArtifact``s, so a warm store serves with zero planner invocations.
``--tenants "arch[:share[:priority]],..."`` serves several archs as
co-resident tenants: their decode graphs go through
``resolve_multi_tenant`` and an ``AdmissionScheduler`` drives one
``ServeEngine`` per tenant (tenant ``i``'s weights from seed ``i``) in the
resolved plan's mode.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import (MultiTenantRequest, PAPER_HW, PlanRequest,
                              PlanStore, TenantSpec, Topology,
                              resolve_multi_tenant)
from repro_torch.models import init_model, resolve_device
from repro_torch.runtime.serve_loop import (AdmissionScheduler, Request,
                                            ServeEngine, decode_graph,
                                            require_servable)


def parse_tenants(spec: str) -> list:
    """Parse ``"arch[:share[:priority]],..."`` into (arch, share, prio)."""
    out = []
    for part in filter(None, spec.split(",")):
        bits = part.split(":")
        if len(bits) > 3 or not bits[0]:
            raise ValueError(f"bad tenant spec {part!r}; "
                             "expected arch[:share[:priority]]")
        arch = bits[0]
        share = float(bits[1]) if len(bits) > 1 else 1.0
        prio = int(bits[2]) if len(bits) > 2 else 0
        out.append((arch, share, prio))
    if len(out) < 2:
        raise ValueError("--tenants needs at least two tenants")
    return out


def _config(arch: str, args):
    cfg = dataclasses.replace(get_config(arch, smoke=args.smoke),
                              kv_quant=args.kv_quant,
                              use_kernels=args.use_kernels)
    require_servable(cfg)
    return cfg


def _plan_request(graph, device: torch.device) -> PlanRequest:
    return PlanRequest(graph, hw=PAPER_HW, topology=Topology.AMP,
                       device=device.type)


def tenant_request(tenants: list, cfgs: list,
                   device: torch.device) -> MultiTenantRequest:
    """The multi-tenant request of ``parse_tenants``' output: tenant ``i``
    is named ``arch#i``, its decode graph renamed to match (the plan keys
    tenants by name, and one arch may be two tenants)."""
    specs = []
    for i, ((arch, share, prio), cfg) in enumerate(zip(tenants, cfgs)):
        graph = decode_graph(cfg)
        graph = dataclasses.replace(graph, name=f"{graph.name}#{i}")
        specs.append(TenantSpec(_plan_request(graph, device),
                                share=share, priority=prio,
                                name=f"{arch}#{i}"))
    return MultiTenantRequest(tuple(specs))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_tenants(args, device: torch.device):
    """The multi-tenant serving path: plan the substrate split, then run
    one admission-scheduled engine per tenant.  Every tenant's config is
    checked before any weight is drawn.  Returns the ``MultiTenantPlan``
    and the ``AdmissionScheduler`` after its run."""
    tenants = parse_tenants(args.tenants)
    plan_store = PlanStore(args.plan_store) if args.plan_store else None
    cfgs = [_config(arch, args) for arch, _, _ in tenants]
    request = tenant_request(tenants, cfgs, device)
    engines = {}
    for i, (spec, cfg) in enumerate(zip(request.tenants, cfgs)):
        params = init_model(cfg, seed=i, device=device)
        engines[spec.name] = ServeEngine(params, cfg, batch_slots=args.slots,
                                         max_len=args.max_len, device=device,
                                         cuda_graph=args.cuda_graph)

    t0 = time.perf_counter()
    plan = resolve_multi_tenant(request, store=plan_store)
    t_plan = time.perf_counter() - t0
    print(f"multi-tenant plan: mode={plan.mode} source={plan.source} "
          f"({t_plan*1e3:.0f} ms)")
    print(f"  makespan {plan.makespan_cycles:.3e} cy vs serialized "
          f"{plan.serialized_cycles:.3e} cy "
          f"(speedup {plan.speedup_vs_serialized:.2f}x), "
          f"DRAM {plan.dram_bytes:.3e} B vs {plan.serialized_dram:.3e} B")
    for t in plan.tenants:
        band = f"cols[{t.band[0]}:{t.band[1]})" if t.band else "whole array"
        print(f"  {t.name}: {band}, {t.latency_cycles:.3e} cy/token, "
              f"dram_bw_fraction={t.dram_bw_fraction:.2f}, "
              f"link_dx={t.link_interference:.1f}")

    sched = AdmissionScheduler.from_plan(plan, engines)
    rid = 0
    for name in engines:           # a bursty stream per tenant
        for _ in range(args.requests):
            sched.submit(name, Request(rid=rid,
                                       prompt=[2 + rid, 7, 3 * rid + 1],
                                       max_new_tokens=args.max_new))
            rid += 1
    t0 = time.perf_counter()
    done = sched.run()
    _sync(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for v in done.values() for r in v)
    print(f"served {sum(map(len, done.values()))} requests / {total} tokens "
          f"in {dt*1e3:.0f} ms ({total/dt:.0f} tok/s, {sched.ticks} "
          f"scheduler ticks) across {len(engines)} tenants "
          f"(mode={sched.mode}, on {device}, "
          f"use_kernels={args.use_kernels})")
    st = sched.stats()
    for name in sorted(engines):
        print(f"  {name}: {st[f'{name}.completed']:.0f} done, "
              f"mean finish tick {st.get(f'{name}.mean_finish_tick', 0):.1f}")
    return plan, sched


def serve_one(args, device: torch.device):
    """One engine for ``--arch``, planned with ``--plan``/``--plan-store``.
    Returns the ``ServeEngine`` and its finished requests."""
    cfg = _config(args.arch, args)
    params = init_model(cfg, seed=0, device=device)
    plan_request = plan_store = None
    if args.plan or args.plan_store:
        plan_request = _plan_request(decode_graph(cfg), device)
        if args.plan_store:
            plan_store = PlanStore(args.plan_store)
    engine = ServeEngine(params, cfg, batch_slots=args.slots,
                         max_len=args.max_len, device=device,
                         plan_request=plan_request, plan_store=plan_store,
                         cuda_graph=args.cuda_graph)
    for i in range(args.requests):
        engine.submit(Request(rid=i, prompt=[2 + i, 7, 3 * i + 1],
                              max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = engine.run()
    _sync(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt*1e3:.0f} ms "
          f"({total/dt:.0f} tok/s, {engine.ticks} ticks, {args.slots} slots, "
          f"{cfg.name} on {device}, kv_quant={cfg.kv_quant}, "
          f"use_kernels={cfg.use_kernels}, "
          f"cuda_graph={engine.cuda_graph})")
    print("engine: " + " ".join(f"{k}={v}" for k, v in
                                engine.log.counters().items()))
    if engine.plan is not None:
        print(f"decode plan: source={engine.plan_source} "
              f"{engine.plan.latency_cycles:.3e} cycles/token, "
              f"{engine.plan.dram_bytes:.3e} DRAM B/token")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        print(f"  rid={r.rid} out={r.output}")
    return engine, done


def main(argv: Optional[List[str]] = None):
    """Serve as the arguments say; returns what ``serve_one`` (or, with
    ``--tenants``, ``serve_tenants``) returns."""
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
    ap.add_argument("--cuda-graph", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="replay each decode tick as one captured CUDA "
                         "graph (default: on a CUDA device)")
    ap.add_argument("--plan", action="store_true",
                    help="attach the accelerator plan for the decode step")
    ap.add_argument("--plan-store", default=None, metavar="DIR",
                    help="admit/persist the plan as an artifact in DIR "
                         "(implies --plan)")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help='serve co-resident tenants on one substrate: '
                         '"arch[:share[:priority]],..." (>= 2 entries)')
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.tenants:
        return serve_tenants(args, device)
    return serve_one(args, device)


if __name__ == "__main__":
    main()
