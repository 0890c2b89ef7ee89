#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build, check and serve on one card.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA H100 (it
imports ``src/repro_torch``, never JAX and nothing of ``repro``):

1. device: requires CUDA; prints versions, the card's name and power
   limit, and turns TF32 off for float32 products;
2. build: compiles every kernel of the serving path with ``nvcc``;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch
   version at the main path's shapes, with times, the bound and a
   PyTorch yardstick (``library_ms``);
4. serve: qwen2.5-3b at full width (random bf16 weights from a seed)
   answers 6 requests through ``ServeEngine`` with the kernels on; the
   launch counts of that run must show every kernel on the path; one
   decode step is then compared with the plain path from the same cache;
5. small reference: the smoke config in float32 on the card, decode
   logits against prefill logits.

Any failure raises and exits non-zero.  The second-last line is the JSON
kernel table; the last line is the device record.  The full results go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data sheet: HBM3 rate and dense peaks by input type
#: (bf16 on the tensor cores; float32 on the CUDA cores, TF32 is off)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
#: kernel vs plain: f32 differs only in summation order (fp32 atomics
#: over F chunks); bf16 also in where h and the output round to bf16
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
#: full-width decode step, kernel path vs plain path, relative to the
#: largest logit: the plain path rounds g and u to bf16 before silu, the
#: kernel rounds only h, and 36 bf16 layers compound the difference
LOGIT_TOL = 5e-2
#: smoke config in float32: decode vs prefill differ in summation order
SMALL_TOL = 1e-4

FUSED_MLP_SHAPES = [("decode", 4), ("prefill", 256), ("ragged", 5)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, sync, target_ms: float = 200.0) -> float:
    """Mean device time of ``fn`` by CUDA events, after a warm-up."""
    import torch
    for _ in range(2):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    sync()
    iters = max(5, min(200, math.ceil(target_ms / max(
        start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    results = build.build(["fused_mlp"])
    print(f"build: {len(results)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for r in results:
        print(f"  {r.name}: {r.path.name} ({r.seconds:.1f} s)")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"    {line.strip()}")


def check_fused_mlp(label: str, T: int, D: int, F: int, dtype_name: str):
    """One shape: the kernel against its plain version, with times."""
    import torch
    from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(T * 7 + D + F)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    x = rnd(T, D)
    wg, wu = rnd(D, F, scale=D ** -0.5), rnd(D, F, scale=D ** -0.5)
    wd = rnd(F, D, scale=F ** -0.5)
    out = fused_mlp(x, wg, wu, wd)
    exp = fused_mlp_ref(x, wg, wu, wd)
    torch.cuda.synchronize()
    check(out.dtype == dtype and out.shape == (T, D),
          f"fused_mlp {label}: {out.dtype} {tuple(out.shape)}")
    diff = (out.float() - exp.float()).abs()
    tol = KERNEL_TOL[dtype_name]
    ok = bool((diff <= tol + tol * exp.float().abs()).all())
    row = {"shape": label, "T": T, "D": D, "F": F, "dtype": dtype_name,
           "max_abs_err": float(diff.max()), "tol": tol, "ok": ok}
    if label != "mask-check":
        sync = torch.cuda.synchronize
        plain_ms = time_ms(lambda: fused_mlp_ref(x, wg, wu, wd), sync)
        ms = time_ms(lambda: fused_mlp(x, wg, wu, wd), sync)
        library_ms = time_ms(
            lambda: (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd, sync)
        size = torch.finfo(dtype).bits // 8
        nbytes = (2 * T * D + 3 * D * F) * size
        ops = 6 * T * D * F
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
        row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
    print("fused_mlp " + json.dumps(row))
    check(ok, f"fused_mlp {label} {dtype_name}: max err "
              f"{row['max_abs_err']:.3g} above tol {tol}")
    return row


def phase_kernels():
    rows = [check_fused_mlp(label, T, 2048, 11008, dt)
            for label, T in FUSED_MLP_SHAPES
            for dt in ("bfloat16", "float32")]
    # ragged D and F too (the shapes above are ragged only in T)
    rows += [check_fused_mlp("mask-check", 5, 200, 300, dt)
             for dt in ("bfloat16", "float32")]
    return rows


def phase_serve():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_mlp import fused_mlp
    from repro_torch.models import decode_step, init_model
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), use_kernels=True)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve: {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
          f"ff={cfg.d_ff} vocab={cfg.vocab}, {n_params / 1e9:.3f} B params "
          f"in {cfg.dtype}, init {time.perf_counter() - t0:.1f} s")

    # warm-up engine (cuBLAS handles, the kernel library) before the run
    warm = ServeEngine(params, cfg, batch_slots=4, max_len=128,
                       device="cuda")
    warm.submit(Request(rid=-1, prompt=[1, 2], max_new_tokens=2))
    warm.run()
    del warm

    engine = ServeEngine(params, cfg, batch_slots=4, max_len=128,
                         device="cuda")
    for i in range(6):
        engine.submit(Request(rid=i, prompt=[2 + i, 7, 3 * i + 1],
                              max_new_tokens=12))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"fused_mlp": fused_mlp.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(done) == 6 and not engine.truncated,
          f"served {len(done)} of 6 requests")
    for r in done:
        check(len(r.output) == 12, f"rid {r.rid}: {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.output),
              f"rid {r.rid}: token out of vocab {r.output}")
    want = cfg.n_layers * engine.ticks
    check(launches["fused_mlp"] == want,
          f"fused_mlp launched {launches['fused_mlp']} times, "
          f"expected {cfg.n_layers} x {engine.ticks} ticks = {want}")
    tokens = sum(len(r.output) for r in done)
    serve = {"requests": len(done), "tokens": tokens, "ticks": engine.ticks,
             "seconds": dt, "tokens_per_s": tokens / dt,
             "ms_per_tick": dt / engine.ticks * 1e3,
             "peak_memory_gb": peak_gb, "launches": launches}
    print("serve " + json.dumps(serve))
    for r in sorted(done, key=lambda r: r.rid)[:2]:
        print(f"  rid={r.rid} out={r.output}")

    # one decode step from the same cache state, kernel path vs plain
    feed = torch.tensor([[3 + s] for s in range(engine.B)], device="cuda")
    index = torch.from_numpy(engine.pos.copy()).to("cuda")
    logits = {}
    with torch.inference_mode():
        for use in (True, False):
            cache = {k: v.clone() for k, v in engine.cache.items()}
            c = dataclasses.replace(cfg, use_kernels=use)
            logits[use], _ = decode_step(params, c, feed, cache, index)
    check(logits[True].shape == (engine.B, 1, cfg.padded_vocab),
          f"kernel-path logits {tuple(logits[True].shape)}")
    # the padded vocab rows hold -1e30 on both paths; compare real ones
    lk = logits[True][..., :cfg.vocab].float()
    lp = logits[False][..., :cfg.vocab].float()
    check(bool(torch.isfinite(lk).all()), "kernel-path logits not finite")
    rel = float((lk - lp).abs().max() / lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    serve.update(logit_rel_diff=rel, logit_tol=LOGIT_TOL,
                 argmax_agreement=agree)
    print(f"decode step, kernel vs plain path: max |diff| / max |logit| = "
          f"{rel:.3g} (tol {LOGIT_TOL}), argmax agreement {agree:.2f}")
    check(rel <= LOGIT_TOL, f"kernel path logits off by {rel:.3g}")
    serve["profile"] = profile_ticks(params, cfg, serve["ms_per_tick"])
    return serve


def profile_ticks(params, cfg, ms_per_tick: float, ticks: int = 8):
    """Device time of a steady decode tick, by ``torch.profiler``: the
    sum of kernel durations per tick, the fused_mlp kernel's part, and
    the device's busy share of the unprofiled tick time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve_loop import Request, ServeEngine
    engine = ServeEngine(params, cfg, batch_slots=4, max_len=128,
                         device="cuda")
    for i in range(4):
        engine.submit(Request(rid=i, prompt=[5 + i], max_new_tokens=64))
    for _ in range(4):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler saw no device events; device time "
              "not measured")
        return None
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    mlp_us = sum(e.time_range.elapsed_us() for e in kernels
                 if "fused_mlp_kernel" in e.name)
    out = {"ticks": ticks, "device_ms_per_tick": dev_us / ticks / 1e3,
           "fused_mlp_ms_per_tick": mlp_us / ticks / 1e3,
           "device_ops_per_tick": len(kernels) / ticks,
           "busy_share": dev_us / ticks / 1e3 / ms_per_tick}
    print("profile " + json.dumps(out))
    return out


def phase_small_reference():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_cache, \
        init_model
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              dtype=torch.float32, use_kernels=True)
    params = init_model(cfg, seed=1, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=gen, device="cuda")
    with torch.inference_mode():
        full, _ = forward(params, cfg, toks)
        cache = init_cache(cfg, 2, 8, device="cuda")
        steps = []
        for i in range(8):
            lg, cache = decode_step(params, cfg, toks[:, i:i + 1], cache, i)
            steps.append(lg[:, 0])
    err = float((torch.stack(steps, 1) - full).abs().max())
    scale = float(full.abs().max())
    print(f"small reference ({cfg.name}, float32, kernels on): decode vs "
          f"prefill max err {err:.3g} (logit scale {scale:.3g}, tol "
          f"{SMALL_TOL} abs + rel)")
    check(err <= SMALL_TOL * (1 + scale), "decode disagrees with prefill")
    return {"max_abs_err": err, "tol": SMALL_TOL}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    serve = phase_serve()
    small = phase_small_reference()

    main_row = next(r for r in rows
                    if r["shape"] == "decode" and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "fused_mlp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:48",
        "launches": serve["launches"]["fused_mlp"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    record = {"card": smi, "kernels": kernels, "fused_mlp_rows": rows,
              "serve": serve, "small_reference": small,
              "seconds": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"total {record['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
