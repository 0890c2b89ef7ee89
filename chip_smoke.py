#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build, check, serve, plan and
train on one card.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA H100 (it
imports ``src/repro_torch``, never JAX and nothing of ``repro``):

1. device: requires CUDA; prints versions, the card's name and power
   limit, and turns TF32 off for float32 products;
2. build: compiles every kernel (fused_mlp, maxplus_scan, price_rows,
   rwkv6_scan, rglru_scan, flash_attention, decode_attention) with
   ``nvcc``, one process
   per source, all started together, and prints each CUDA function's
   registers and spills;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch
   version at the main paths' shapes, with times, the bound, a PyTorch
   yardstick (``library_ms``, where one call computes the function) and,
   for ``fused_mlp``, the launch- or latency-bound kernels and flash
   attention, the kernel's device time by the profiler; ``fused_mlp``
   at qwen2.5-3b and gemma3-4b widths (decode, prefill, ragged T, ragged
   D and F), at D = 5120 (phi3-medium-14b's and qwen1.5-32b's decode in
   the rows regime, their (1, 512) prefill in the ``wgmma`` regime), at
   qwen2-vl-2b's width (decode, and its (2, 1024) forward's prefill) and
   past D = 5120 ((512, 5128, 13824) and (512, 8192, 28672), 16-CTA
   clusters of the ``wgmma`` regime),
   each row with its regime, device ms, bound and cuBLAS x 3 ms, and flash attention at the model paths' shapes (whisper's
   non-causal encoder over 1500 frames, its cross-attention in forward
   and in decode, one query row, among them), in bf16
   (tensor cores, also held to a limit in bf16 ulps) and float32, each
   also called twice and required to give the same bits; just before
   and after each flash timing window, the card's SM clock, power and
   temperature by ``nvidia-smi``; ``wkv6`` at rwkv6-1.6b's decode (the
   step regime) and prefill shapes up to one 4096-token prompt (the
   chunked regime), each row in its regime, called twice and required to
   give the same bits, its and the plain version's error against the
   recurrence in float64, and on every chunked row the step kernel's
   device time on the same inputs (the "before" column), which the
   chunked kernel must beat; ``rglru_chunked`` at recurrentgemma-2b's
   decode (the step regime, bit-equal to ``rglru_ref``) and prefill
   shapes (the split regime, bit-equal to ``rglru_split_ref``, within
   the reference suite's tolerance of ``rglru_ref``), the same
   repeatability, float64 and step-kernel columns; ``maxplus_chunked``
   at the simulator's row shapes and past one 1024-step tile;
   ``decode_attention`` at the two benchmark cells' serving shapes
   (qwen2.5-3b 64 x 2048, 16 / 2 heads; phi3-medium-14b 32 x 2048,
   40 / 10) at a mean fill of 338 positions and a full one of 2047, and
   at gemma3-4b's, recurrentgemma-2b's (its ring wrapped) and whisper's
   decode shapes, and at the MoE archs' served shapes (4 x 128; 16 / 8
   heads at hd 64, 16 / 16 at hd 128), bf16 and float32: against the
   plain version (bf16 also element by element, in bf16 ulps, against
   its float32 computation, beside two planted faults that must read
   above the limit), twice for the same bits, device ms by CUDA events
   and the profiler beside the bound (the admitted K and V bytes), the
   plain version (``_sdpa``'s computation) and
   ``scaled_dot_product_attention``;
4. models, one on the card at a time, each at full width with random
   bf16 weights from a seed, each built by ``init_model`` on a card that
   holds no other, its peak memory held to the weights + 2 GB:
   qwen2.5-3b, rwkv6-1.6b, recurrentgemma-2b, gemma3-4b,
   phi3-medium-14b, qwen1.5-32b, granite-moe-1b-a400m,
   moonshot-v1-16b-a3b and qwen2-vl-2b (text only) each answer 6 requests
   through ``ServeEngine`` with the kernels on, eagerly and with each
   tick one replay of a captured CUDA graph (the main path), the two
   runs' tokens and last logits the same bits, ms/tick, tokens/s and
   peak GB for both; the wrappers' counts of the eager run must show
   every kernel of its path once per layer that runs it and tick
   (fused_mlp, wkv6, rglru_chunked, decode_attention on every attention
   layer; the MoE archs' experts are plain products) and no other kernel
   (flash attention runs only without a cache, so never in decode), those
   of the graph run
   once per layer in its warm-up step and capture, and a profiled graph
   run one ``cudaGraphLaunch`` a tick and every kernel once per layer
   and tick inside the replays; both engines' steady ticks are profiled
   for device time and busy share; one decode step is then compared with
   the plain path from the same cache, and taken again from another
   copy of the cache for the same bits (the MoE archs layer by layer:
   each layer's attention in bf16, and beside it the same with each
   row's newest key left out, which must read above the limit; each
   whole layer in float32); the two recurrent archs also run
   ``forward`` on a (2, 512) prompt, each layer's output with the
   kernels is held against the plain path's from the same input, and the
   logits against the plain path with its recurrence in float64; their
   kernel-vs-plain comparisons run the same weights in float32 (these
   random-weight nets amplify any difference from layer to layer, see
   ``_float32_twin``) and the kernel path's device time by kernel
   (``profile_forward``); rwkv6-1.6b also runs the kernel-path
   ``forward`` on a (1, 4096) prompt, timed and profiled with its launch
   counts (its correctness at that length is the ``prefill-long`` kernel
   row's); gemma3-4b runs ``forward`` on a (1, 8192) prompt,
   the reference's chunked-attention length, with one flash launch per
   layer, each layer held against the plain path (``_sdpa_chunked``) in
   float32 and the bf16 logits against the plain path's;
   phi3-medium-14b, qwen1.5-32b, granite-moe-1b-a400m and
   moonshot-v1-16b-a3b run ``forward`` on a (1, 512) prompt
   (``forward_slice``): bf16 logits against the plain path on the
   positions whose MoE routing agrees in every layer, the routing flips
   counted, and each layer in float32, one layer's twin at a time;
   qwen2-vl-2b runs ``forward`` on 2 prompts of 256 patch embeddings and
   768 tokens (``forward_vlm``: one flash and one ``fused_mlp`` launch a
   layer, bf16 logits against the plain path, each layer in float32, one
   layer's twin at a time); whisper-medium (``whisper_arch``, not served:
   the reference's ``ServeEngine`` has no enc-dec path) runs
   ``encode_frames`` and ``whisper_forward`` on 4 x 1500 frames and 4 x 64
   tokens (72 flash launches, nothing else), bf16 logits against the
   plain path and each encoder and decoder layer as a float32 twin, then
   32 teacher-forced ``whisper_decode_step``s from the encoded cache (24
   flash and 24 decode_attention launches a step), each step's logits against
   the forward's at that position, and one step against the plain path
   and again from a copy of the cache for the same bits;
5. plan: the 8 XR-bench tasks on ``PAPER_HW``/AMP through
   ``get_planner().plan(PlanRequest(g, engine=...))``, the torch engine
   on ``cuda`` and the numpy engine in turns (three rounds, the order
   alternating, each pass from cold caches); every pricing call with
   rows of a recurrence goes through the CUDA ``price_rows`` in one
   launch, whatever its edge counts, and the host time of its packing,
   copy-launch-copy round trip and ``SegmentCost`` assembly is taken
   apart; each plan must equal the numpy engine's and
   ``tests/golden/xrbench_plans.json``; one more torch pass under the
   profiler sums the kernel's device time; every real call of the run is
   then held against the plain version bit for bit, and the largest
   call, the call with the widest rows, all rows in one call and
   synthetic calls (E = 33, 70, 200; rows too large for a block's shared
   memory) are timed;
6. simulate: every segment of those plans through
   ``simulate_segment(engine="torch")``, whose max-plus scans all go
   through the CUDA ``maxplus_chunked``, against ``engine="numpy"``,
   and one scan's call time through the staged copy beside the same
   scan through two pageable copies;
7. small reference: the ten smoke configs in float32 on the card,
   decode logits (the decode-attention kernel) against prefill logits
   (the flash kernel) at every position (the hybrid past its local attention's
   ring-buffer wrap, gemma3-4b past its local window, the MoE configs
   with capacity for every token, whisper's decode against
   ``whisper_forward``, qwen2-vl's text-only decode against the dense
   forward of the same weights);
8. plan the LM zoo (``plan_lm``): the 29 graphs of
   ``repro_torch.configs.lm_graphs`` (a decode step and the prefill
   buckets of each of the ten archs, at their published configs) from
   cold caches with the torch engine on ``cuda`` (every pricing call with
   device rows is one CUDA ``price_rows`` launch) and with the numpy
   engine, each plan against ``tests/golden/lm_plans.json`` and the other
   engine's, every torch plan through ``verify_plan`` with no finding,
   and ``repro_torch.launch.lint --strict`` over a ``PlanStore`` of them;
9. planned serving (``serve_planned``): ``repro_torch.launch.serve
   --use-kernels`` on qwen2.5-3b at full width without a plan, then
   twice with ``--plan-store``: the first run plans (the planner invoked
   once; its pricing calls counted, and ``price_rows`` launched once for
   each with device rows), the second reads the store (no planner
   invocation, no pricing call, no launch); the three runs' tokens are
   the same bits, and each engine replays its CUDA graph once a tick;
10. tenants (``tenants``): ``repro_torch.launch.serve --use-kernels
   --tenants qwen2.5-3b:2:1,rwkv6-1.6b:1 --plan-store`` at full width:
   the multi-tenant plan of the torch engine on ``cuda`` against the
   numpy engine's, reloaded warm from the store with no planner
   invocation; then the ``AdmissionScheduler`` in each of its three
   modes on fresh engines of the same weights, timed, each run's
   ``fused_mlp`` and ``wkv6`` captures and graph replays checked, and
   every request's
   tokens, in the launcher's run and in every mode, bit-equal to the
   same request served alone on an engine of its tenant;
11. train (``train``): ``repro_torch.launch.train --arch qwen2.5-3b
   --steps 6 --batch 8 --seq 4096`` in-process at full width and depth
   (4 microbatches of 2 x 4096, remat, bf16 weights, float32 moments):
   per step the wall time, tokens/s, loss, gradient norm and MFU, the
   resident and peak memory, the first step's loss against the plain
   ``loss_fn`` of the same batch, the loss falling, every value finite,
   no hand-written kernel launched (training runs the plain path, as the
   reference does), and one more step's device time by category under
   the profiler; then at full width and 2 layers (``--layers 2 --steps 6
   --ckpt-every 3 --batch 8 --seq 1024``) a straight run, a run with a
   fault injected at step 4 and a run of 3 steps resumed to 6 by a
   fresh process, the last two bit-equal to the first, each
   checkpoint's save timed;
12. mesh (``mesh``): this process as one NCCL rank on the (1, 1) host
   mesh: ``launch.train`` in a world of one (``WORLD_SIZE=1``) for the
   train phase's first 3 steps (each step's loss and gradient norm
   against that phase's, bit-equal or the difference recorded, s/step,
   peak GB, no kernel launched, the collectives one more step issues by
   ``CommDebugMode``); the 2-layer
   straight, faulted (the mesh re-formed) and resumed runs on the mesh,
   bit-equal; ``make_prefill_step`` of qwen2.5-3b with the kernels on
   (1, 4096) with DTensor parameters (36 ``fused_mlp`` and 36
   ``flash_attention`` launches in that run alone, logits against the
   mesh-less kernel path, each kernel against its plain version at
   those shapes), and ``pipeline_spmd_fn`` at one stage with one
   decoder layer over 4 microbatches, bit-equal to the layer on each;
13. dryrun (``dryrun``, on the host, started at the beginning in a
   process of its own): ``launch.dryrun.run_cell`` for qwen2.5-3b x
   train_4k x 16x16 and moonshot-v1-16b-a3b x decode_32k x 2x16x16 on
   fake groups of 256 and 512 ranks, each cell's per-device peak within
   the card's memory.

Any failure raises and exits non-zero.  The second-last line is the JSON
kernel table; the last line is the device record.  The full results go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
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
#: (bf16 on the tensor cores; float32 and float64 on the CUDA cores,
#: TF32 is off; the planner's kernels run float64)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "float64": 34e12}
#: kernel vs plain: f32 differs only in summation order (partials over
#: splits of F, summed in split order); bf16 also in where h and the
#: output round to bf16
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
#: full-width decode step, kernel path vs plain path, or forward, kernel
#: path vs the plain path with its recurrence in float64, relative to the
#: largest logit: for qwen2.5-3b the plain path rounds g and u to bf16
#: before silu, the kernel rounds only h, and 36 bf16 layers compound the
#: difference; the recurrences differ only in float32 summation order
LOGIT_TOL = 5e-2
#: one layer of a recurrent arch in float32 at full width, kernel path vs
#: plain path from the same input, relative to the output's largest
#: value: summation order in the recurrence only
LAYER_TOL = 1e-4
#: one decode layer's attention of a MoE arch in bf16 at full width,
#: kernel path vs plain path from the same input, relative to the
#: output's largest value: the plain path rounds the scores to bf16, the
#: kernel does not, and both round the output and its projection.  On an
#: H100 granite-moe-1b-a400m and moonshot-v1-16b-a3b read at most
#: 0.0056-0.0060 over four feeds each, and with each row's newest key
#: left out at least 0.15-0.23 in every layer
MOE_ATTN_TOL_BF16 = 3e-2
#: smoke configs in float32: decode vs prefill differ in summation order
SMALL_TOL = 1e-4
#: ``init_model`` may hold this much above the weights at its peak (one
#: layer's float32 draws: qwen1.5-32b's largest is 0.56 GB)
INIT_PEAK_OVER_BYTES = 2e9
#: what may stay allocated on the card when the next model is built
CLEAN_CARD_BYTES = 1e9

#: (label, T, D, F): qwen2.5-3b width (the serve path's 4 slots, a
#: 256-token prompt, a ragged T), gemma3-4b width (4 slots, and the
#: (1, 8192) forward's prefill), D = 5120: phi3-medium-14b's and
#: qwen1.5-32b's 4 slots (the rows regime) and their (1, 512) forwards
#: (the wgmma regime, 640-column D-slices), qwen2-vl-2b's 4 slots and
#: its (2, 256 + 768) forward, and two prefills wider than any arch of
#: the zoo (D = 5128 and 8192: 16-CTA clusters of the wgmma regime)
FUSED_MLP_SHAPES = [("decode", 4, 2048, 11008), ("prefill", 256, 2048, 11008),
                    ("ragged", 5, 2048, 11008),
                    ("decode-gemma", 4, 2560, 10240),
                    ("prefill-gemma", 8192, 2560, 10240),
                    ("decode-phi3", 4, 5120, 17920),
                    ("decode-qwen32", 4, 5120, 27392),
                    ("prefill-qwen32", 512, 5120, 27392),
                    ("prefill-phi3", 512, 5120, 17920),
                    ("decode-vlm", 4, 1536, 8960),
                    ("prefill-vlm", 2048, 1536, 8960),
                    ("prefill-d5128", 512, 5128, 13824),
                    ("prefill-d8192", 512, 8192, 28672)]
#: prefill rows that float32 checks without timing
FUSED_MLP_UNTIMED = {("prefill-gemma", "float32"),
                     ("prefill-qwen32", "float32"),
                     ("prefill-phi3", "float32"),
                     ("prefill-vlm", "float32"),
                     ("prefill-d5128", "float32"),
                     ("prefill-d8192", "float32")}

#: the simulator scans one row of T <= 512 bursts (DEFAULT_MAX_BURSTS);
#: a row past one tile of 1024 steps carries between tiles; (label, B, T)
MAXPLUS_SHAPES = [("path", 1, 512), ("path-353", 1, 353), ("path-9", 1, 9),
                  ("batch", 64, 512), ("tiles-1500", 1, 1500)]
#: max-plus kernel vs plain: fractional inputs, tree-order (kernel) vs
#: prefix-sum (plain) rounding; integer inputs must be bit-equal
MAXPLUS_RTOL = 1e-12
#: torch vs numpy engine: plan floats; simulated latency (1e-9 past 2^24)
PLAN_RTOL = 1e-6
SIM_RTOL = 1e-6
SIM_RTOL_BIG = 1e-9
GOLDEN = ROOT / "tests" / "golden" / "xrbench_plans.json"
LM_GOLDEN = ROOT / "tests" / "golden" / "lm_plans.json"

#: the recurrences' kernel vs plain, the reference suites' tolerances
#: (tests/test_kernels.py): WKV6's step regime differs in summation order
#: (four partial sums, fused multiply-adds), its chunked regime also in
#: carrying the decays as products across a chunk; RG-LRU's step regime
#: should be bit-equal, its split regime differs in its segments'
#: carry-ins (bit-equal to ``rglru_split_ref``)
WKV6_TOL = 2e-3
RGLRU_TOL = 1e-4
#: (label, BH, T, s0, decay): decode = 4 slots x 32 heads, one token
#: (the step regime); prefill = 2 prompts x 32 heads of S = 512
#: (rwkv6-1.6b), prefill-long one prompt of 4096 tokens (RWKV-6's training
#: context; the chunked regime); decay None is the model's
#: exp(-exp(x)), "zeros" the same with some decays underflowed to 0
WKV6_SHAPES = [("decode", 128, 1, True, None),
               ("prefill", 64, 512, False, None),
               ("prefill-s0", 64, 512, True, None),
               ("ragged", 64, 77, True, None),
               ("extreme-decay", 64, 128, True, 1e-4),
               ("zero-decay", 64, 93, True, "zeros"),
               ("prefill-long", 32, 4096, False, None)]
#: (label, B, T, h0) at W = 2560 (recurrentgemma-2b)
RGLRU_SHAPES = [("decode", 4, 1, True), ("prefill", 2, 512, False),
                ("prefill-h0", 2, 512, True), ("ragged", 3, 77, True)]

#: flash kernel vs plain, the reference suite's tolerances
#: (tests/test_kernels.py): float32 differs in summation order only;
#: bf16 also where the output rounds (the plain version rounds once, as
#: the kernel does, but from another fp32 sum)
FLASH_TOL = {"bfloat16": 3e-2, "float32": 3e-4}
#: bf16 flash rows are also held element by element to this many bf16
#: ulps of the larger of |exp| and the RMS of exp's row (``_ulp_err``):
#: FLASH_TOL is about as large as a long row's typical output.  On an
#: H100 every row read 2.0-2.25 ulps, and the reference with one kv tile
#: cut from the rows that reach it 112-612; bf16 decode-attention rows,
#: against the plain version in float32, 0.90-1.63, the reference with
#: one chunk cut 140-870 and with the newest key left out 33-389
FLASH_ULP_LIMIT = 4.0
#: (label, B, S, T, H, Hkv, hd, causal, window): gemma3-4b's forward at
#: (1, 8192) and (2, 2048), local (window 1024) and global; a ragged S;
#: recurrentgemma-2b's forward (10 heads, 1 KV head, window 2048);
#: whisper's cross-attention shape (not causal, T != S); and the (1, 512)
#: forwards of qwen1.5-32b (MHA 40/40), phi3-medium-14b (GQA 40/10),
#: granite-moe-1b-a400m (16/8 at hd 64) and moonshot-v1-16b-a3b (16/16);
#: qwen2-vl-2b's (2, 256 patches + 768 text) forward (GQA 12/2, hd 128);
#: whisper-medium's 4 x 1500-frame encoder (not causal, T not a multiple
#: of the kv tile), its decoder's self-attention and cross-attention over
#: 64 tokens, and the cross-attention of its decode step (one query row)
FLASH_SHAPES = [("local-8192", 1, 8192, 8192, 8, 4, 256, True, 1024),
                ("global-8192", 1, 8192, 8192, 8, 4, 256, True, 0),
                ("local-2x2048", 2, 2048, 2048, 8, 4, 256, True, 1024),
                ("global-2x2048", 2, 2048, 2048, 8, 4, 256, True, 0),
                ("ragged-777", 1, 777, 777, 8, 4, 256, True, 0),
                ("hybrid-2x512", 2, 512, 512, 10, 1, 256, True, 2048),
                ("cross-128x1500", 1, 128, 1500, 16, 16, 64, False, 0),
                ("qwen32-1x512", 1, 512, 512, 40, 40, 128, True, 0),
                ("phi3-1x512", 1, 512, 512, 40, 10, 128, True, 0),
                ("granite-1x512", 1, 512, 512, 16, 8, 64, True, 0),
                ("moonshot-1x512", 1, 512, 512, 16, 16, 128, True, 0),
                ("vlm-2x1024", 2, 1024, 1024, 12, 2, 128, True, 0),
                ("whisper-enc-4x1500", 4, 1500, 1500, 16, 16, 64, False, 0),
                ("whisper-self-4x64", 4, 64, 64, 16, 16, 64, True, 0),
                ("whisper-cross-4x64", 4, 64, 1500, 16, 16, 64, False, 0),
                ("whisper-xdec-4x1", 4, 1, 1500, 16, 16, 64, False, 0)]


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


def smi_reading() -> dict:
    """One reading of the card's SM clock (MHz), power draw and limit (W)
    and temperature (C) by ``nvidia-smi``; empty where a field reads
    "[N/A]"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.splitlines()
    try:
        mhz, watts, limit, temp = (float(x) for x in out[0].split(","))
    except (IndexError, ValueError):
        return {}
    return {"sm_mhz": mhz, "power_w": watts, "power_limit_w": limit,
            "temp_c": temp}


def smi_around(fn):
    """``fn()`` and the card's readings just before and just after it, so
    that no other process runs beside a timed window."""
    before = smi_reading()
    result = fn()
    return result, {"before": before, "after": smi_reading()}


def phase_build():
    """Build every kernel library; the registers, stack and spills of each
    CUDA function by ``-Xptxas -v``, by name."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    results = build.build(["fused_mlp", "maxplus_scan", "price_rows",
                           "rwkv6_scan", "rglru_scan", "flash_attention",
                           "decode_attention"])
    print(f"build: {len(results)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    usage = {}
    for r in results:
        print(f"  {r.name}: {r.path.name} ({r.seconds:.1f} s)")
        for fn, u in build.ptxas_usage(r.log).items():
            usage[fn] = u
            print(f"    {fn}: {json.dumps(u)}")
    return usage


def check_fused_mlp(label: str, T: int, D: int, F: int, dtype_name: str,
                    timed: bool = True):
    """One shape: the kernel against its plain version, a second call
    bitwise equal to the first, and (``timed``) its times."""
    import torch
    from repro_torch.kernels.fused_mlp import (choose_regime, fused_mlp,
                                               fused_mlp_ref, wgmma_ctas)
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
    again = fused_mlp(x, wg, wu, wd)
    exp = fused_mlp_ref(x, wg, wu, wd)
    torch.cuda.synchronize()
    check(out.dtype == dtype and out.shape == (T, D),
          f"fused_mlp {label}: {out.dtype} {tuple(out.shape)}")
    check(torch.equal(out, again),
          f"fused_mlp {label} {dtype_name}: two calls on the same inputs "
          f"differ")
    del again
    diff = (out.float() - exp.float()).abs()
    tol = KERNEL_TOL[dtype_name]
    ok = bool((diff <= tol + tol * exp.float().abs()).all())
    row = {"shape": label, "T": T, "D": D, "F": F, "dtype": dtype_name,
           "regime": choose_regime(T, D, dtype == torch.bfloat16)[0],
           "ctas": (wgmma_ctas(D) if choose_regime(
               T, D, dtype == torch.bfloat16)[0] == "wgmma" else None),
           "max_abs_err": float(diff.max()), "tol": tol, "ok": ok,
           "repeatable": True}
    if timed:
        sync = torch.cuda.synchronize
        plain_ms = time_ms(lambda: fused_mlp_ref(x, wg, wu, wd), sync)
        ms = time_ms(lambda: fused_mlp(x, wg, wu, wd), sync)
        dev_us = device_us(lambda: fused_mlp(x, wg, wu, wd),
                           MODEL_KERNELS["fused_mlp"], calls=5)
        library_ms = time_ms(
            lambda: (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd, sync)
        size = torch.finfo(dtype).bits // 8
        nbytes = (2 * T * D + 3 * D * F) * size
        ops = 6 * T * D * F
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
        row.update(ms=ms, device_ms=_us_to_ms(dev_us), plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
    print("fused_mlp " + json.dumps(row))
    if timed:
        print(f"fused_mlp {label} ({T}, {D}, {F}) {dtype_name}: regime "
              f"{row['regime']}, device {row['device_ms']} ms, bound "
              f"{row['bound_ms']:.4g} ms ({row['bound_by']}), cuBLAS x 3 "
              f"{row['library_ms']:.4g} ms")
    check(ok, f"fused_mlp {label} {dtype_name}: max err "
              f"{row['max_abs_err']:.3g} above tol {tol}")
    return row


def fused_mlp_occupancy():
    """How many of each ``fused_mlp`` kernel fit the card at once: the
    ``wgmma`` regime's 8- and 16-CTA clusters, the ``cluster`` regime's
    per D-slice tile, the rows regime's blocks per SM at D = 2560 and
    5120 (by the CUDA occupancy calculator), and the SM count."""
    import torch
    from repro_torch.kernels import fused_mlp as fm
    lib = fm._library()
    row = {"shape": "occupancy",
           "sms": torch.cuda.get_device_properties(0).multi_processor_count,
           "clusters": {**{
               f"wgmma {ctas}": lib.fused_mlp_max_active_clusters(1, ctas)
               for ctas in fm.WGMMA_CLUSTERS}, **{
               f"cluster {tile}": lib.fused_mlp_max_active_clusters(2, tile)
               for tile in fm.CLUSTER_DC_TILES}},
           "rows_blocks_per_sm": {
               f"{name} D={d}": lib.fused_mlp_rows_blocks_per_sm(code, d)
               for name, code in (("float32", 0), ("bfloat16", 1))
               for d in (2560, 5120)}}
    print("fused_mlp " + json.dumps(row))
    check(min(row["clusters"].values()) > 0
          and min(row["rows_blocks_per_sm"].values()) > 0,
          f"fused_mlp: a kernel does not fit the card: {row}")
    return row


def phase_kernels():
    rows = [check_fused_mlp(label, T, D, F, dt,
                            timed=(label, dt) not in FUSED_MLP_UNTIMED)
            for label, T, D, F in FUSED_MLP_SHAPES
            for dt in ("bfloat16", "float32")]
    # ragged D and F too (the shapes above are ragged only in T)
    rows += [check_fused_mlp("mask-check", 5, 200, 300, dt, timed=False)
             for dt in ("bfloat16", "float32")]
    # the wgmma regime's ragged edges: T, D and F no multiples of the tiles,
    # F no multiple of 8 (padded for TMA)
    rows.append(check_fused_mlp("mask-check-wgmma", 70, 2600, 300,
                                "bfloat16", timed=False))
    rows.append(fused_mlp_occupancy())
    floor_ms = launch_floor_ms()
    print(f"launch floor: {floor_ms * 1e3:.2f} us per one-element torch op")
    mp_rows = [check_maxplus(label, B, T, floor_ms)
               for label, B, T in MAXPLUS_SHAPES]
    exact = check_maxplus_exact()
    return rows, mp_rows, exact, floor_ms


def device_us(fn, kernel_name: str, calls: int = 20, per_call=None):
    """Mean device time of ``kernel_name`` per call of ``fn``, from
    ``torch.profiler`` (None if three windows saw no such kernel).  With
    ``per_call``, the number of such kernels one call launches, all
    alike: the mean per recorded kernel times ``per_call``, which a
    record the profiler drops does not bias (windows of 5 calls have held
    4 launches, which the sum over calls reads 20% low); a count other
    than ``calls * per_call`` is printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a window has now and then come back with no kernel record at all:
    # such a window is taken again, twice at most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel_name in e.name]
        if evs:
            break
    if not evs:
        return None
    if per_call is None:
        return sum(evs) / calls
    if len(evs) != calls * per_call:
        print(f"profile: {len(evs)} {kernel_name} kernels recorded for "
              f"{calls} calls of {per_call}")
    return sum(evs) / len(evs) * per_call


def launch_floor_ms() -> float:
    """Time per call of PyTorch's own smallest launch (a one-element
    in-place add), back to back: the floor under any tiny kernel."""
    import torch
    x = torch.zeros(1, device="cuda")
    return time_ms(lambda: x.add_(1.0), torch.cuda.synchronize)


def _bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_maxplus(label: str, B: int, T: int, floor_ms: float):
    """One shape: the max-plus kernel against its plain version."""
    import torch
    from repro_torch.kernels.maxplus_scan import (maxplus_chunked,
                                                  maxplus_chunked_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B * 1000 + T)

    def rnd(*shape, scale):
        return torch.rand(shape, generator=gen, device="cuda",
                          dtype=torch.float64) * scale

    # cycle-count-like inputs: u rising, s a fractional service time
    u = rnd(B, T, scale=50.0).cumsum(dim=1) + 2.0 ** 25
    s, h0 = rnd(B, T, scale=3.0), rnd(B, scale=100.0)
    out = maxplus_chunked(u, s, h0)
    exp = maxplus_chunked_ref(u, s, h0)
    torch.cuda.synchronize()
    check(out.shape == (B, T) and out.dtype == torch.float64,
          f"maxplus_chunked {label}: {out.dtype} {tuple(out.shape)}")
    diff = (out - exp).abs()
    rel = float((diff / exp.abs()).max())
    sync = torch.cuda.synchronize
    bound_ms, bound_by = _bound((3 * B * T + B) * 8, 2 * B * T, "float64")
    row = {"shape": label, "B": B, "T": T,
           "max_abs_err": float(diff.max()), "max_rel_err": rel,
           "tol_rel": MAXPLUS_RTOL, "bit_equal": bool(torch.equal(out, exp)),
           "ms": time_ms(lambda: maxplus_chunked(u, s, h0), sync),
           "plain_ms": time_ms(lambda: maxplus_chunked_ref(u, s, h0), sync),
           "device_ms": _us_to_ms(device_us(
               lambda: maxplus_chunked(u, s, h0), "maxplus_kernel")),
           "launch_floor_ms": floor_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None}
    print("maxplus_chunked " + json.dumps(row))
    check(rel <= MAXPLUS_RTOL, f"maxplus_chunked {label}: max rel err "
                               f"{rel:.3g} above {MAXPLUS_RTOL}")
    return row


def check_maxplus_exact():
    """Integer-valued scans past 2^24 cycles: kernel, plain version and
    the scalar loop must agree bit for bit."""
    import numpy as np
    import torch
    from repro_torch.kernels.maxplus_scan import (maxplus_chunked,
                                                  maxplus_chunked_ref,
                                                  maxplus_scan_reference)
    rng = np.random.default_rng(3)
    u = rng.integers(2 ** 25, 2 ** 30, (4, 4096)).astype(np.float64)
    u[:, ::7] = -math.inf
    u[0, :] = -math.inf
    u[0, 0] = float(2 ** 26)              # the reference suite's case
    s = rng.integers(0, 9, (4, 4096)).astype(np.float64)
    s[0, :] = 1.5
    loop = np.stack([maxplus_scan_reference(u[b], s[b]) for b in range(4)])
    ut = torch.from_numpy(u).to("cuda")
    st = torch.from_numpy(s).to("cuda")
    h0 = torch.full((4,), -math.inf, dtype=torch.float64, device="cuda")
    out = maxplus_chunked(ut, st, h0).cpu().numpy()
    plain = maxplus_chunked_ref(ut, st, h0).cpu().numpy()
    ok = bool(np.array_equal(out, loop) and np.array_equal(plain, loop)
              and loop[0, -1] > 2 ** 26 + 6000)
    print(f"maxplus_chunked beyond 2^24, integer inputs (4, 4096): "
          f"bit-equal to the scalar loop: {ok}")
    check(ok, "maxplus_chunked is not bit-equal beyond 2^24")
    return {"bit_equal_beyond_2pow24": ok}


def _norm_err(out, exp, tol: float):
    """max |out - exp|, and whether every element is within tol abs +
    tol rel (``torch.testing.assert_close``'s rule)."""
    diff = (out - exp).abs()
    return float(diff.max()), bool((diff <= tol + tol * exp.abs()).all())


def check_wkv6(label: str, BH: int, T: int, N: int, with_s0: bool,
               floor_ms: float, decay=None):
    """One shape: the WKV6 kernel in its regime against its plain version,
    called twice and required to give the same bits; the kernel's and the
    plain version's error against the recurrence in float64; and on a
    chunked row the step kernel's device time on the same inputs (the
    "before" column)."""
    import torch
    from repro_torch.kernels import rwkv6_scan
    from repro_torch.kernels.rwkv6_scan import choose_regime, wkv6, wkv6_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(BH * 1000 + T)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    r, k, v = (rnd(BH, T, N, scale=0.5) for _ in range(3))
    # decays as the model makes them: exp(-exp(decay_raw)), in (0, 1)
    if decay in (None, "zeros"):
        w = torch.exp(-torch.exp(rnd(BH, T, N) - 4.0))
        if decay == "zeros":                 # exp(-exp(x)) underflowed
            w[:, ::3, ::5] = 0.0
    else:
        w = torch.full((BH, T, N), decay, device="cuda")
    u = rnd(BH, 1, N, scale=0.3)
    s0 = rnd(BH, N, N, scale=0.2) if with_s0 else None
    regime = choose_regime(T, N)
    y, s = wkv6(r, k, v, w, u, s0)
    y2, s2 = wkv6(r, k, v, w, u, s0)
    ye, se = wkv6_ref(r, k, v, w, u, s0)
    y64, s64 = _wkv6_float64(r, k, v, w, u, s0, exact=True)
    torch.cuda.synchronize()
    check(y.shape == (BH, T, N) and s.shape == (BH, N, N),
          f"wkv6 {label}: {tuple(y.shape)} {tuple(s.shape)}")
    repeatable = bool(torch.equal(y, y2) and torch.equal(s, s2))
    check(repeatable, f"wkv6 {label}: two calls gave different bits")
    err_y, ok_y = _norm_err(y, ye, WKV6_TOL)
    err_s, ok_s = _norm_err(s, se, WKV6_TOL)
    ok = (ok_y and ok_s and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(s).all()))

    def f64_err(a, b):
        return max(float((a.double() - y64).abs().max()),
                   float((b.double() - s64).abs().max()))

    sync = torch.cuda.synchronize
    nbytes = (5 * BH * T * N + BH * N + (2 if with_s0 else 1) * BH * N * N
              ) * 4
    # what the function needs per step and row: r S (2 N^2), the state
    # update (3 N^2), and the bonus, which factorises as
    # v_j sum_i r_i u_i k_i (5 N)
    bound_ms, bound_by = _bound(nbytes, BH * T * (5 * N * N + 5 * N),
                                "float32")
    step_ms = None
    if regime != "step":
        step_ms = _us_to_ms(device_us(
            lambda: rwkv6_scan._launch(r, k, v, w, u, s0, "step"),
            MODEL_KERNELS["wkv6"], calls=5 if T > 1024 else 20, per_call=1))
    row = {"shape": label, "BH": BH, "T": T, "N": N, "s0": with_s0,
           "decay": decay, "regime": regime,
           "value_split": (rwkv6_scan.value_split(
               BH, N, torch.cuda.get_device_properties(0).multi_processor_count)
               if regime == "chunked" else None),
           "max_abs_err": max(err_y, err_s), "tol": WKV6_TOL, "ok": ok,
           "float64_err": f64_err(y, s), "plain_float64_err": f64_err(ye, se),
           "repeatable": repeatable,
           "ms": time_ms(lambda: wkv6(r, k, v, w, u, s0), sync),
           "plain_ms": time_ms(lambda: wkv6_ref(r, k, v, w, u, s0), sync),
           "device_ms": _us_to_ms(device_us(
               lambda: wkv6(r, k, v, w, u, s0), MODEL_KERNELS["wkv6"],
               per_call=1)),
           "step_device_ms": step_ms,
           "launch_floor_ms": floor_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None}
    print("wkv6 " + json.dumps(row))
    check(ok, f"wkv6 {label}: max err {row['max_abs_err']:.3g} above tol "
              f"{WKV6_TOL}")
    if step_ms is not None:
        check(row["device_ms"] < step_ms,
              f"wkv6 {label}: the chunked kernel ({row['device_ms']:.4g} ms) "
              f"is not faster than the step kernel ({step_ms:.4g} ms)")
    return row


def check_rglru(label: str, B: int, T: int, W: int, with_h0: bool,
                floor_ms: float):
    """One shape: the RG-LRU kernel in its regime, called twice and
    required to give the same bits, and bit-equal to the plain version of
    its regime (``rglru_ref`` for step, ``rglru_split_ref`` for split);
    within ``RGLRU_TOL`` of ``rglru_ref``; its and the plain version's
    error against the recurrence in float64; and on a split row the step
    kernel's device time on the same inputs (the "before" column)."""
    import torch
    from repro_torch.kernels import rglru_scan
    from repro_torch.kernels.rglru_scan import (choose_regime, rglru_chunked,
                                                rglru_ref, rglru_split_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B * 1000 + T + W)
    # decays a_t in (0.05, 0.95) and inputs b_t as the model's are shaped
    a = torch.sigmoid(torch.randn(B, T, W, generator=gen,
                                  device="cuda")) * 0.9 + 0.05
    b = torch.randn(B, T, W, generator=gen, device="cuda") * 0.5
    h0 = (torch.randn(B, W, generator=gen, device="cuda") if with_h0
          else None)
    regime = choose_regime(T)
    h, hl = rglru_chunked(a, b, h0)
    h2, hl2 = rglru_chunked(a, b, h0)
    he, hle = rglru_ref(a, b, h0)
    hs, hls = rglru_split_ref(a, b, h0) if regime == "split" else (he, hle)
    h64, _ = _rglru_float64(a, b, h0)
    torch.cuda.synchronize()
    check(h.shape == (B, T, W) and hl.shape == (B, 1, W),
          f"rglru_chunked {label}: {tuple(h.shape)} {tuple(hl.shape)}")
    repeatable = bool(torch.equal(h, h2) and torch.equal(hl, hl2))
    bit_equal = bool(torch.equal(h, hs) and torch.equal(hl, hls))
    err, ok = _norm_err(h, he, RGLRU_TOL)
    sync = torch.cuda.synchronize
    nbytes = (3 * B * T * W + (2 if with_h0 else 1) * B * W) * 4
    bound_ms, bound_by = _bound(nbytes, 2 * B * T * W, "float32")
    step_ms = None
    if regime != "step":
        step_ms = _us_to_ms(device_us(
            lambda: rglru_scan._launch(a, b, h0, "step"),
            MODEL_KERNELS["rglru_chunked"], per_call=1))
    row = {"shape": label, "B": B, "T": T, "W": W, "h0": with_h0,
           "regime": regime,
           "split_plan": (rglru_scan.split_plan(
               B, T, W, torch.cuda.get_device_properties(0)
               .multi_processor_count) if regime == "split" else None),
           "max_abs_err": err, "tol": RGLRU_TOL, "ok": ok,
           "bit_equal": bit_equal,
           "bit_equal_to": ("rglru_split_ref" if regime == "split"
                            else "rglru_ref"),
           "float64_err": float((h - h64).abs().max()),
           "plain_float64_err": float((he - h64).abs().max()),
           "repeatable": repeatable,
           "ms": time_ms(lambda: rglru_chunked(a, b, h0), sync),
           "plain_ms": time_ms(lambda: rglru_ref(a, b, h0), sync),
           "device_ms": _us_to_ms(device_us(
               lambda: rglru_chunked(a, b, h0),
               MODEL_KERNELS["rglru_chunked"], per_call=1)),
           "step_device_ms": step_ms,
           "launch_floor_ms": floor_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None}
    print("rglru_chunked " + json.dumps(row))
    check(repeatable, f"rglru_chunked {label}: two calls gave different "
                      "bits")
    check(bit_equal, f"rglru_chunked {label}: not bit-equal to "
                     f"{row['bit_equal_to']}")
    check(ok, f"rglru_chunked {label}: max err {err:.3g} above tol "
              f"{RGLRU_TOL}")
    if regime != "step":
        check(None not in (row["device_ms"], step_ms)
              and row["device_ms"] < step_ms,
              f"rglru_chunked {label}: the split kernel "
              f"({row['device_ms']} ms) is not faster than the step "
              f"kernel ({step_ms} ms)")
    return row


def phase_recurrence_kernels(floor_ms: float):
    """Both recurrence kernels at the shapes of the serve (decode: 4
    slots) and forward (prefill: B = 2, S = 512) phases, ragged T, and
    WKV6 at the reference suite's extreme decay."""
    wkv = [check_wkv6(label, BH, T, 64, s0, floor_ms, decay)
           for label, BH, T, s0, decay in WKV6_SHAPES]
    rg = [check_rglru(label, B, T, 2560, h0, floor_ms)
          for label, B, T, h0 in RGLRU_SHAPES]
    return wkv, rg


def admitted_keys(S: int, T: int, causal: bool, window: int) -> int:
    """Number of (query, key) pairs the masks admit, summed over rows:
    row i admits keys lo..hi with hi = min(i, T - 1) (causal) or T - 1,
    and lo = max(0, i - window + 1) (window > 0) or 0."""
    import numpy as np
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = (np.maximum(0, i - window + 1) if window > 0
          else np.zeros(S, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def _top_kernel(fn) -> str:
    """Name of the device kernel that takes most of one call of ``fn``,
    by ``torch.profiler`` (the backend a library call ran)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0) + e.time_range.elapsed_us()
    return max(times, key=times.get)[:120] if times else "not measured"


#: flash regime -> suffix of its CUDA function, flash_attention_kernel_*
FLASH_FUNCTIONS = {"wgmma": "wgmma", "mma": "mma", "cuda_cores": "fp32"}


def _ulp_err(out, exp) -> float:
    """max |out - exp| in bf16 ulps of max(|exp|, the RMS of exp's row
    over hd): an element near 0 takes its row's scale, to which the
    products' rounding is relative."""
    import torch
    scale = torch.maximum(exp.abs(), exp.pow(2).mean(-1, keepdim=True).sqrt())
    _, e = torch.frexp(scale)            # scale = m 2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(scale), e - 8)
    return float(((out - exp).abs() / ulp).max())


def check_flash(label: str, B: int, S: int, T: int, H: int, Hkv: int,
                hd: int, causal: bool, window: int, dtype_name: str,
                usage: dict):
    """One shape: the flash kernel (model layout, ``attention_op``) in
    its regime against the plain version, called twice and required to
    give the same bits, with its registers and spills (from ``usage``),
    its time by CUDA events and by the profiler, the card's readings
    around each timing window, the bound and
    ``scaled_dot_product_attention`` as the yardstick.  bf16 rows are
    also held to ``FLASH_ULP_LIMIT`` ulps; on causal rows longer than one
    kv tile the reading of the reference with the oldest kv tile (64
    keys) cut from the rows that reach it shows that this limit sees such
    a fault."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_mask, attention_op,
                                                     attention_op_ref,
                                                     choose_regime)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B * 100000 + S + T + hd)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(B, S, H, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd)
    exp = attention_op_ref(q, k, v, causal=causal, window=window)

    def kernel():
        return attention_op(q, k, v, causal=causal, window=window)

    regime = choose_regime(dtype, hd)
    out = kernel()
    repeatable = bool(torch.equal(out, kernel()))
    torch.cuda.synchronize()
    check(out.dtype == q.dtype and out.shape == q.shape,
          f"flash_attention {label}: {out.dtype} {tuple(out.shape)}")
    check(repeatable, f"flash_attention {label} {dtype_name}: two calls "
                      "gave different bits")
    tol = FLASH_TOL[dtype_name]
    err, ok = _norm_err(out.float(), exp.float(), tol)
    ok = ok and bool(torch.isfinite(out).all())
    ulp_err = fault_ulp = None
    if dtype == torch.bfloat16:
        ulp_err = _ulp_err(out.float(), exp.float())
        cut = min(window if window > 0 else S, S) - 64
        if causal and cut > 0:
            fault = attention_op_ref(q, k, v, causal=True, window=cut)
            fault_ulp = _ulp_err(fault.float(), exp.float())
            del fault
    del exp
    fn_name = f"flash_attention_kernel_{FLASH_FUNCTIONS[regime]}<{hd}>"
    ms, clocks_events = smi_around(
        lambda: time_ms(kernel, torch.cuda.synchronize))
    dev_us, clocks_profiler = smi_around(
        lambda: device_us(kernel, MODEL_KERNELS["flash_attention"], calls=5,
                          per_call=1))
    # the yardstick: one PyTorch call, (B, H, S, hd) views, GQA inside
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = (_mask(S, T, causal, window, "cuda") if window > 0 else None)

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float() - out.float())
                    .abs().max())
    sync = torch.cuda.synchronize
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * H + 2 * B * T * Hkv) * hd * size
    pairs = admitted_keys(S, T, causal, window)
    bound_ms, bound_by = _bound(nbytes, 4 * hd * H * B * pairs, dtype_name)
    row = {"shape": label, "B": B, "S": S, "T": T, "H": H, "Hkv": Hkv,
           "hd": hd, "causal": causal, "window": window,
           "dtype": dtype_name, "admitted_pairs_per_head": B * pairs,
           "regime": regime, "function": fn_name,
           "ptxas": usage.get(fn_name), "max_abs_err": err, "tol": tol,
           "ulp_err": ulp_err, "ulp_limit": FLASH_ULP_LIMIT,
           "edge_tile_fault_ulp": fault_ulp, "ok": ok,
           "repeatable": repeatable, "ms": ms,
           "device_ms": _us_to_ms(dev_us), "clocks_events": clocks_events,
           "clocks_profiler": clocks_profiler,
           "plain_ms": time_ms(lambda: attention_op_ref(
               q, k, v, causal=causal, window=window), sync),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": time_ms(library, sync),
           "library_kernel": _top_kernel(library),
           "library_max_abs_err": lib_err}
    print("flash_attention " + json.dumps(row))
    check(ok, f"flash_attention {label} {dtype_name}: max err {err:.3g} "
              f"above tol {tol}")
    if ulp_err is not None:
        check(ulp_err <= FLASH_ULP_LIMIT,
              f"flash_attention {label} bfloat16: {ulp_err:.3g} ulps above "
              f"the limit {FLASH_ULP_LIMIT}")
    if fault_ulp is not None:
        check(fault_ulp > FLASH_ULP_LIMIT,
              f"flash_attention {label}: a cut edge tile reads "
              f"{fault_ulp:.3g} ulps, within the limit {FLASH_ULP_LIMIT}")
    return row


def phase_flash(usage: dict):
    """The flash kernel at the model paths' shapes, bf16 and float32."""
    return [check_flash(*shape, dt, usage) for shape in FLASH_SHAPES
            for dt in ("bfloat16", "float32")]


#: decode attention's shapes: (label, B, T, H, Hkv, hd, window, fill),
#: fill the mean admitted positions of a slot ("wrapped": every slot past
#: the ring's wrap); the first four are the two benchmark cells' shapes,
#: the last two the MoE archs' decode as ``serve_arch`` serves them (4
#: slots of 128, G = 2 at hd 64 and G = 1 at hd 128), filled into both
#: of their chunks
DECODE_SHAPES = [
    ("chat-338", 64, 2048, 16, 2, 128, 2048, 338),
    ("chat-2047", 64, 2048, 16, 2, 128, 2048, 2047),
    ("batch-338", 32, 2048, 40, 10, 128, 2047, 338),
    ("batch-2047", 32, 2048, 40, 10, 128, 2047, 2047),
    ("gemma3-local", 4, 2048, 8, 4, 256, 1024, 1024),
    ("hybrid-wrapped", 4, 2048, 10, 1, 256, 2048, "wrapped"),
    ("whisper-self", 4, 448, 16, 16, 64, 448, 224),
    ("granite-moe-serve", 4, 128, 16, 8, 64, 128, 64),
    ("moonshot-serve", 4, 128, 16, 16, 128, 128, 64)]


def _decode_positions(B: int, T: int, fill, gen):
    """(B, 1) int64 positions: a full fill puts every slot at T - 1, a
    mean fill spreads the slots' positions evenly over [0, 2 fill - 2]
    (mean fill - 1, 0 and the top among them), "wrapped" draws them in
    [T, 3 T)."""
    import torch
    if fill == "wrapped":
        return torch.randint(T, 3 * T, (B, 1), generator=gen, device="cuda")
    if fill >= T - 1:
        return torch.full((B, 1), T - 1, dtype=torch.long, device="cuda")
    top = 2 * fill - 2
    return torch.tensor([[round(top * b / (B - 1))] for b in range(B)],
                        dtype=torch.long, device="cuda")


def check_decode_attention(label: str, B: int, T: int, H: int, Hkv: int,
                           hd: int, window: int, fill, dtype_name: str,
                           usage: dict):
    """One shape: the decode-attention kernel against its plain version,
    called twice for the same bits, with its registers and spills, its
    time by CUDA events and by the profiler (split and combine passes),
    the card's readings around each window, the bound (the admitted K and
    V bytes, q and o) and ``scaled_dot_product_attention`` over the ring
    mask as the yardstick.  bf16 rows are also held element by element to
    ``FLASH_ULP_LIMIT`` ulps of the plain version in float32 from the same
    bf16 inputs (``FLASH_TOL`` is about as large as a long row's typical
    output); two faults planted in that reference show that the limit
    sees them (``_decode_faults``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (choose_chunk,
                                                      decode_attention_op,
                                                      decode_attention_ref,
                                                      ring_mask)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B * 1000 + T + hd)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(B, 1, H, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd)
    pos = _decode_positions(B, T, fill, gen)

    def kernel():
        return decode_attention_op(q, k, v, pos, window)

    out = kernel()
    repeatable = bool(torch.equal(out, kernel()))
    exp = decode_attention_ref(q, k, v, pos, window)
    torch.cuda.synchronize()
    check(out.dtype == q.dtype and out.shape == q.shape,
          f"decode_attention {label}: {out.dtype} {tuple(out.shape)}")
    check(repeatable, f"decode_attention {label} {dtype_name}: two calls "
                      "gave different bits")
    tol = FLASH_TOL[dtype_name]
    err, ok = _norm_err(out.float(), exp.float(), tol)
    ok = ok and bool(torch.isfinite(out).all())
    del exp
    mask = ring_mask(pos, T, window)
    admitted = int(mask.sum())
    chunk = choose_chunk(B, Hkv, T, hd,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    ulp_err, faults = None, {}
    if dtype == torch.bfloat16:
        q32, k32, v32 = q.float(), k.float(), v.float()
        exp32 = decode_attention_ref(q32, k32, v32, pos, window)
        ulp_err = _ulp_err(out.float(), exp32)
        faults = {name: _ulp_err(f, exp32) for name, f in _decode_faults(
            q32, k32, v32, pos, mask, chunk).items()}
        del q32, k32, v32, exp32
    ms, clocks_events = smi_around(
        lambda: time_ms(kernel, torch.cuda.synchronize))
    dev_us, clocks_profiler = smi_around(
        lambda: device_us(kernel, MODEL_KERNELS["decode_attention"],
                          calls=5))
    # the yardstick: one PyTorch call on (B, H, 1, hd) views, GQA inside
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float() - out.float())
                    .abs().max())
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * admitted * Hkv + 2 * B * H) * hd * size
    bound_ms, bound_by = _bound(nbytes, 4 * hd * H * admitted, dtype_name)
    sync = torch.cuda.synchronize
    split = (f"decode_attention_kernel_split_bf16<{hd}, {chunk}>"
             if dtype == torch.bfloat16 else
             f"decode_attention_kernel_split_fp32<{hd}>")
    row = {"shape": label, "B": B, "T": T, "H": H, "Hkv": Hkv, "hd": hd,
           "window": window, "dtype": dtype_name,
           "mean_fill": admitted / B, "chunk": chunk, "function": split,
           "ptxas": usage.get(split), "max_abs_err": err, "tol": tol,
           "ulp_err": ulp_err, "ulp_limit": FLASH_ULP_LIMIT,
           "fault_ulp": faults, "ok": ok, "repeatable": repeatable, "ms": ms,
           "device_ms": _us_to_ms(dev_us), "clocks_events": clocks_events,
           "clocks_profiler": clocks_profiler,
           "plain_ms": time_ms(lambda: decode_attention_ref(
               q, k, v, pos, window), sync),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": time_ms(library, sync),
           "library_kernel": _top_kernel(library),
           "library_max_abs_err": lib_err}
    print("decode_attention " + json.dumps(row))
    check(ok, f"decode_attention {label} {dtype_name}: max err {err:.3g} "
              f"above tol {tol}")
    if ulp_err is not None:
        check(ulp_err <= FLASH_ULP_LIMIT,
              f"decode_attention {label} bfloat16: {ulp_err:.3g} ulps above "
              f"the limit {FLASH_ULP_LIMIT}")
    for name, ulps in faults.items():
        check(ulps > FLASH_ULP_LIMIT,
              f"decode_attention {label}: the fault '{name}' reads "
              f"{ulps:.3g} ulps, within the limit {FLASH_ULP_LIMIT}")
    return row


def _decode_faults(q, k, v, pos, mask, chunk: int) -> dict:
    """The plain version (``_sdpa``) in float32 with a fault planted in
    its mask: "chunk_cut" leaves out the second of the kernel's chunks
    of cache slots, as a kernel that dropped a chunk would; "newest_key"
    leaves out each row's newest key (slot pos mod T), an off-by-one in
    the fill, where the row admits another key."""
    import torch
    from repro_torch.models.layers import _sdpa
    T = k.shape[1]
    cut = mask.clone()
    cut[:, :, chunk:2 * chunk] = False
    j = torch.arange(T, device=pos.device)
    newest = mask & ((j != (pos % T)[:, :, None])
                     | (mask.sum(-1, keepdim=True) < 2))
    return {"chunk_cut": _sdpa(q, k, v, cut, None),
            "newest_key": _sdpa(q, k, v, newest, None)}


def phase_decode_attention(usage: dict):
    """The decode-attention kernel at the serving paths' shapes, bf16 and
    float32."""
    return [check_decode_attention(*shape, dt, usage)
            for shape in DECODE_SHAPES for dt in ("bfloat16", "float32")]


def _us_to_ms(us):
    return None if us is None else us / 1e3


def _price_bound(lay, n_final: int):
    """Bound of one ragged call: each input read once (the seven float64
    edge arrays, mem_stall, row_ptr, the flag bytes, in_ptr, in_idx) and
    the packed output written once; ~16 float64 operations per edge, 4
    per incoming entry (divide, multiply, two maxima), 3 per final edge
    and 1 per row."""
    B, N, M = lay.B, lay.N, lay.M
    nbytes = (56 * N + 8 * B + 4 * (B + 1) + N + 4 * (N + 1) + 4 * M
              + 8 * (3 * B + N))
    ops = 16 * N + 4 * M + 3 * n_final + B
    return _bound(nbytes, ops, "float64")


def check_price_rows(label: str, rows, floor_ms: float, timed: bool = True):
    """One call's rows, staged as the planner stages them and priced
    through the planner's round trip (``kernels.price_rows.price_rows``):
    against the plain version on the same inputs on the card, bit for
    bit, and two calls bitwise equal; with ``timed``, its times, bound
    and block plan."""
    import numpy as np
    import torch
    from repro_torch.core.pipeline_model_torch import stage_rows
    from repro_torch.kernels.price_rows import (block_plan, price_rows,
                                                price_rows_plain, unstage)
    dev = torch.device("cuda")
    stage, lay = stage_rows(rows, pin=True)
    plan = block_plan(stage, lay)
    got = price_rows(stage, lay, dev)
    again = price_rows(stage, lay, dev)
    args = unstage(stage.to(dev), lay)
    exp = price_rows_plain(*args).cpu().numpy()
    bit_equal = bool(np.array_equal(got, exp))
    repeatable = bool(np.array_equal(got, again))
    check(bit_equal and repeatable,
          f"price_rows {label}: kernel bit-equal to plain: {bit_equal}, "
          f"repeatable: {repeatable}")
    edges = [r.n_edges for r in rows]
    row = {"shape": label, "B": lay.B, "N": lay.N, "M": lay.M,
           "E_max": max(edges), "E_min": min(edges),
           "max_abs_err": float(np.abs(got - exp).max()),
           "bit_equal": bit_equal, "repeatable": repeatable,
           "regime": plan.regime, "rows_per_block": plan.rows_per_block,
           "smem_bytes": plan.smem_bytes, "blocks": plan.blocks,
           "global_blocks": plan.global_blocks,
           "device_ms": _us_to_ms(device_us(
               lambda: price_rows(stage, lay, dev), "price_rows_kernel",
               per_call=1))}
    if timed:
        sync = torch.cuda.synchronize
        bound_ms, bound_by = _price_bound(
            lay, sum(int(r.final.sum()) for r in rows))
        # ms: the whole round trip a call (copy up, launch, copy down,
        # wait), as the planner makes it
        row.update(
            ms=time_ms(lambda: price_rows(stage, lay, dev), sync),
            plain_ms=time_ms(lambda: price_rows_plain(*args), sync),
            launch_floor_ms=floor_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
    print("price_rows " + json.dumps(row))
    return row


def _snapshot_plan(plan) -> dict:
    """The fields ``tests/test_golden_plans.py`` pins (copied, since that
    file imports the JAX package)."""
    return {
        "topology": plan.topology.value,
        "latency_cycles": plan.latency_cycles,
        "dram_bytes": plan.dram_bytes,
        "segments": [{
            "start": s.segment.start, "stop": s.segment.stop,
            "depth": s.segment.depth,
            "org": s.org.value if s.org is not None else None,
            "via_global_buffer": (bool(s.placement.via_global_buffer)
                                  if s.placement is not None else None),
            "latency_cycles": s.cost.latency_cycles,
            "dram_bytes": s.cost.dram_bytes,
            "congested": s.cost.congested,
            "branches": [list(b) for b in s.branches],
            "edges": [list(e) for e in s.edges],
        } for s in plan.segments],
    }


def _plans_differ(got: dict, want: dict):
    """First difference of two snapshots: structure exact, floats within
    ``PLAN_RTOL``; None when they agree."""
    def close(a, b):
        return abs(a - b) <= PLAN_RTOL * max(abs(a), abs(b))
    if got["topology"] != want["topology"]:
        return "topology"
    if len(got["segments"]) != len(want["segments"]):
        return (f"{len(got['segments'])} segments, not "
                f"{len(want['segments'])}")
    for i, (gs, ws) in enumerate(zip(got["segments"], want["segments"])):
        for key in ("start", "stop", "depth", "org", "via_global_buffer",
                    "congested", "branches", "edges"):
            if gs[key] != ws[key]:
                return f"segment {i}: {key} {gs[key]!r} != {ws[key]!r}"
        for key in ("latency_cycles", "dram_bytes"):
            if not close(gs[key], ws[key]):
                return f"segment {i}: {key} {gs[key]} != {ws[key]}"
    for key in ("latency_cycles", "dram_bytes"):
        if not close(got[key], want[key]):
            return f"{key} {got[key]} != {want[key]}"
    return None


def _cold_planner_caches():
    from repro_torch.core import flow_batch_cache_clear, get_planner, \
        span_cache_clear
    from repro_torch.core import noc, pipeline_model_torch, planner
    get_planner().clear_cache()
    span_cache_clear()
    planner._pair_traffic.cache_clear()
    planner._cached_place.cache_clear()
    flow_batch_cache_clear()
    noc.route_incidence_cache_clear()
    pipeline_model_torch.price_cache_clear()


#: engine order of the plan phase's timed rounds, each engine's pass
#: from cold caches; the order alternates so that neither engine always
#: runs first
PLAN_ROUNDS = [("torch", "numpy"), ("numpy", "torch"), ("torch", "numpy")]


def phase_planner():
    """Plan the 8 XR-bench tasks on the card with each engine in turns,
    check every plan, and record the torch engine's pricing calls: their
    rows, launches, and the host time of their three parts."""
    import statistics

    import torch
    from repro_torch.configs.xrbench import all_tasks
    from repro_torch.core import (PAPER_HW, PlanRequest, Topology,
                                  get_planner, pipeline_model_torch)
    from repro_torch.kernels import price_rows as kpr
    tasks = all_tasks()
    golden = json.loads(GOLDEN.read_text())
    planner = get_planner()
    pmt = pipeline_model_torch

    def timed(fn, key, clock, each=None):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            clock[key] += dt
            if each is not None:
                each.append(dt)
            return out
        return wrapper

    def plan_all(engine):
        """One pass over the tasks from cold caches; with the torch
        engine, the device rows of each pricing call and the host time
        of its parts (packing, the copy-launch-copy round trip,
        ``SegmentCost`` assembly).  The round trip is the time from the
        end of packing to the start of assembly, between which
        ``pipeline_model_torch.price_rows`` makes only the kernel's
        call, so that the kernel's wrapper itself is not replaced."""
        _cold_planner_caches()
        calls = []
        clock = dict.fromkeys(("price_rows", "pack", "round_trip",
                               "assemble"), 0.0)
        trips = []
        packed = [0.0]
        real = (pmt.price_rows, pmt.stage_rows, pmt._assemble)

        def recording(rows, device=None):
            calls.append([r for r in rows if r.host_cost is None])
            return real[0](rows, device=device)

        def packing(*args, **kwargs):
            out = timed(real[1], "pack", clock)(*args, **kwargs)
            packed[0] = time.perf_counter()
            return out

        def assembling(*args, **kwargs):
            dt = time.perf_counter() - packed[0]
            clock["round_trip"] += dt
            trips.append(dt)
            return timed(real[2], "assemble", clock)(*args, **kwargs)

        kpr.price_rows.launches = 0
        if engine == "torch":
            pmt.price_rows = timed(recording, "price_rows", clock)
            pmt.stage_rows = packing
            pmt._assemble = assembling
        plans, wall = {}, {}
        try:
            for name in sorted(tasks):
                t0 = time.perf_counter()
                plans[name] = planner.plan(PlanRequest(
                    tasks[name], hw=PAPER_HW, topology=Topology.AMP,
                    engine=engine))
                torch.cuda.synchronize()
                wall[name] = time.perf_counter() - t0
        finally:
            pmt.price_rows, pmt.stage_rows, pmt._assemble = real
        device_calls = [c for c in calls if c]
        return {"plans": plans, "wall": wall, "calls": device_calls,
                "launches": kpr.price_rows.launches,
                "groups": sum(pmt.price_cache_info()[:2]), "clock": clock,
                "trips": trips}

    turns = []
    for rnd, order in enumerate(PLAN_ROUNDS):
        for engine in order:
            t = plan_all(engine)
            t.update(engine=engine, round=rnd, total_s=sum(t["wall"].values()))
            turns.append(t)
            print(f"plan round {rnd} {engine}: {t['total_s']:.3f} s"
                  + (f", price_rows {t['clock']['price_rows']:.4f} s, "
                     f"{t['launches']} launches for {len(t['calls'])} calls"
                     if engine == "torch" else ""))
    torch_turns = [t for t in turns if t["engine"] == "torch"]
    numpy_turns = [t for t in turns if t["engine"] == "numpy"]
    for t in torch_turns:
        check(t["launches"] > 0 and t["launches"] == len(t["calls"]),
              f"price_rows launched {t['launches']} times for "
              f"{len(t['calls'])} calls with device rows")
    for name in sorted(tasks):
        want_numpy = _snapshot_plan(numpy_turns[0]["plans"][name])
        check(_plans_differ(want_numpy, golden[name]) is None,
              f"plan of {name}, numpy engine vs golden file")
        for t in torch_turns:
            snap = _snapshot_plan(t["plans"][name])
            for other, want in (("numpy engine", want_numpy),
                                ("golden file", golden[name])):
                diff = _plans_differ(snap, want)
                check(diff is None, f"plan of {name}, torch engine (round "
                                    f"{t['round']}) vs {other}: {diff}")
        print(f"plan {name}: {len(want_numpy['segments'])} segments, "
              f"latency {want_numpy['latency_cycles']:.6g} cycles; wall "
              f"torch {[round(t['wall'][name], 4) for t in torch_turns]} s, "
              f"numpy {[round(t['wall'][name], 4) for t in numpy_turns]} s")

    # the kernel's device time over one more torch pass, by the profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_turn = plan_all("torch")
    kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "price_rows_kernel" in e.name]
    for name in sorted(tasks):
        check(_plans_differ(_snapshot_plan(prof_turn["plans"][name]),
                            golden[name]) is None,
              f"plan of {name}, profiled torch pass vs golden file")

    first = torch_turns[0]
    calls = first["calls"]
    sizes = {}
    for c in calls:
        for r in c:
            e_pad = pmt._bucket_edges(r.n_edges)
            sizes[e_pad] = sizes.get(e_pad, 0) + 1
    median = {e: statistics.median(t["total_s"] for t in turns
                                   if t["engine"] == e)
              for e in ("torch", "numpy")}
    split = {k: statistics.median(t["clock"][k] for t in torch_turns)
             for k in ("price_rows", "pack", "round_trip", "assemble")}
    out = {"tasks": len(tasks), "launches": first["launches"],
           "calls": len(calls), "groups": first["groups"],
           "rows": sum(len(c) for c in calls), "rows_by_e_pad": sizes,
           "edges_max": max(r.n_edges for c in calls for r in c),
           "largest_call": max(len(c) for c in calls),
           "price_rows_s": split["price_rows"],
           "price_rows_split_s": {k: split[k] for k in
                                  ("pack", "round_trip", "assemble")},
           "price_rows_s_by_turn": [t["clock"]["price_rows"]
                                    for t in torch_turns],
           # one round trip (copy up, launch, copy down) a call, in each
           # torch turn: median and largest
           "round_trip_ms_by_turn": [
               [statistics.median(t["trips"]) * 1e3, max(t["trips"]) * 1e3]
               for t in torch_turns],
           "turns": [{"round": t["round"], "engine": t["engine"],
                      "total_s": t["total_s"]} for t in turns],
           "median_total_s": median,
           "wall_s": {e: [t["wall"] for t in turns if t["engine"] == e]
                      for e in ("torch", "numpy")},
           "plan_device_ms": sum(kernel_us) / 1e3,
           "profiled_kernels": len(kernel_us),
           "profiled_launches": prof_turn["launches"],
           "plans_equal_numpy_and_golden": True}
    print("plan " + json.dumps({k: v for k, v in out.items()
                                if k != "wall_s"}))
    return out, first["plans"], calls


#: synthetic calls beyond the planning run's shapes: (label, edge counts)
#: with up to 4 incoming edges an edge; rows past the reference's 32-edge
#: bucket, and rows too large for a block's shared memory (global scratch,
#: alone and beside small rows)
PRICE_SYNTHETIC = [("synthetic E=33", [33] * 32),
                   ("synthetic E=70", [70] * 32),
                   ("synthetic E=200", [200] * 32),
                   ("synthetic E=600 (global)", [600] * 4),
                   ("synthetic E=600 + small (mixed)", [600] + [8] * 63)]


def phase_price_rows(calls, floor_ms: float):
    """The pricing kernel against its plain version, bit for bit, on
    every real call of the planning run; timed on the largest call, the
    call holding the widest rows, every device row of the run in one
    call, and the synthetic calls."""
    from repro_torch.testing import synthetic_rows
    each = [check_price_rows(f"call {i}", rows, floor_ms, timed=False)
            for i, rows in enumerate(calls)]
    e_max = max(r.n_edges for c in calls for r in c)
    widest = max((c for c in calls if any(r.n_edges == e_max for r in c)),
                 key=len)
    out = [check_price_rows("largest call", max(calls, key=len), floor_ms),
           check_price_rows(f"call with E={e_max}", widest, floor_ms),
           check_price_rows("all rows", [r for c in calls for r in c],
                            floor_ms)]
    for seed, (label, edges) in enumerate(PRICE_SYNTHETIC):
        out.append(check_price_rows(label, synthetic_rows(edges, seed=seed),
                                    floor_ms))
    return out, each


def phase_simulate(plans):
    """Every segment of the torch-engine plans through the torch
    simulator engine on the card, against the numpy engine (each timed
    from cold simulator caches, then both again in turns); one scan's
    call time, staged and through pageable copies."""
    import numpy as np
    import torch
    from repro_torch.core import (PAPER_HW, Topology, sim_cache_clear,
                                  simulate_segment)
    from repro_torch.kernels.maxplus_scan import maxplus_chunked, \
        maxplus_scan
    segs = [(name, i, seg) for name in sorted(plans)
            for i, seg in enumerate(plans[name].segments)]
    sim_cache_clear()
    maxplus_chunked.launches = 0
    simulate_segment.maxplus_scans = 0
    t0 = time.perf_counter()
    sims = [simulate_segment(seg, PAPER_HW, Topology.AMP, engine="torch")
            for _, _, seg in segs]
    dt = time.perf_counter() - t0
    launches = maxplus_chunked.launches
    scans = simulate_segment.maxplus_scans
    check(launches > 0 and launches == scans,
          f"maxplus_chunked launched {launches} times for {scans} scans")
    sim_cache_clear()
    t0 = time.perf_counter()
    worst = 0.0
    for (name, i, seg), st in zip(segs, sims):
        sn = simulate_segment(seg, PAPER_HW, Topology.AMP, engine="numpy")
        check(st.link_loads == sn.link_loads,
              f"simulate {name} segment {i}: link loads differ")
        tol = SIM_RTOL_BIG if sn.latency_cycles > 2 ** 24 else SIM_RTOL
        rel = (abs(st.latency_cycles - sn.latency_cycles)
               / max(abs(sn.latency_cycles), 1e-300))
        worst = max(worst, rel)
        check(rel <= tol, f"simulate {name} segment {i}: latency "
                          f"{st.latency_cycles} vs {sn.latency_cycles}")
    numpy_s = time.perf_counter() - t0

    def timed(engine):
        sim_cache_clear()
        t0 = time.perf_counter()
        for _, _, seg in segs:
            simulate_segment(seg, PAPER_HW, Topology.AMP, engine=engine)
        return time.perf_counter() - t0

    # the first torch pass runs first from whatever the planner left warm:
    # both engines again, in turns, unchecked
    again = {"torch": timed("torch"), "numpy": timed("numpy")}
    # what one scan costs the simulator: numpy in, copies, launch, numpy
    # out, at the path's largest shape; beside it the same scan with u and
    # s copied from pageable memory one by one and h0 filled by a kernel
    u = np.cumsum(np.full(512, 7.0))
    s = np.full(512, 3.0)

    def pageable():
        d = torch.device("cuda")
        return maxplus_chunked(
            torch.from_numpy(u[None]).to(d), torch.from_numpy(s[None]).to(d),
            torch.full((1,), -math.inf, dtype=torch.float64, device=d)
        ).cpu().numpy()

    def call_ms(fn, n_calls=200):
        fn()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        return (time.perf_counter() - t0) / n_calls * 1e3

    def staged():
        return maxplus_scan(u, s, engine="torch")

    check(np.array_equal(staged(), pageable()[0]),
          "maxplus_scan: the staged and pageable paths differ")
    # in turns, so drift on the host weighs on both alike
    scan_call_ms, pageable_ms = call_ms(staged), call_ms(pageable)
    scan_call_ms2, pageable_ms2 = call_ms(staged), call_ms(pageable)
    out = {"segments": len(segs), "scans": scans, "launches": launches,
           "torch_s": dt, "numpy_s": numpy_s,
           "torch_s_again": again["torch"], "numpy_s_again": again["numpy"],
           "scan_call_ms": min(scan_call_ms, scan_call_ms2),
           "pageable_scan_call_ms": min(pageable_ms, pageable_ms2),
           "max_rel_latency_diff": worst,
           "over_2pow24": sum(s.latency_cycles > 2 ** 24 for s in sims)}
    print("simulate " + json.dumps(out))
    return out


#: the hand-written kernels of the model paths and the name of each
#: kernel's CUDA function (as the profiler reports it)
MODEL_KERNELS = {"fused_mlp": "fused_mlp_kernel", "wkv6": "wkv6_kernel",
                 "rglru_chunked": "rglru_kernel",
                 "flash_attention": "flash_attention_kernel",
                 "decode_attention": "decode_attention_kernel"}


def _model_kernels():
    from repro_torch.kernels.decode_attention import decode_attention_op
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_mlp import fused_mlp
    from repro_torch.kernels.rglru_scan import rglru_chunked
    from repro_torch.kernels.rwkv6_scan import wkv6
    return {"fused_mlp": fused_mlp, "wkv6": wkv6,
            "rglru_chunked": rglru_chunked,
            "flash_attention": flash_attention,
            "decode_attention": decode_attention_op}


def _zero_counts():
    for fn in _model_kernels().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _model_kernels().items()}


def _per_call(cfg, forward: bool = False) -> dict:
    """Launches of each model kernel per decode step (or per ``forward``
    when ``forward``): one per layer that runs it.  The hybrid's MLP
    never takes ``fused_mlp`` (the reference calls ``swiglu`` there
    without the config); flash attention runs on every attention layer
    of a forward and never in decode, the decode-attention kernel on
    every attention layer of a decode step (self-attention over the
    cache) and never in a forward.  A MoE layer's experts are plain
    products, as in the reference.  A vlm layer is a dense one.  The
    encoder-decoder's MLP is plain GELU (no kernel in the reference): its
    forward runs flash in every encoder layer and twice in every decoder
    layer (self- and cross-attention), its decode step flash once a
    decoder layer (cross-attention)."""
    n = {"fused_mlp": 0, "wkv6": 0, "rglru_chunked": 0, "flash_attention": 0,
         "decode_attention": 0}
    attn = cfg.n_layers
    if cfg.arch_kind == "encdec":
        n["flash_attention"] = (cfg.n_enc_layers + 2 * cfg.n_layers
                                if forward else cfg.n_layers)
    elif cfg.arch_kind == "moe":
        n["flash_attention"] = cfg.n_layers if forward else 0
    elif cfg.arch_kind == "rwkv":
        n["wkv6"] = cfg.n_layers
        attn = 0
    elif cfg.arch_kind == "hybrid":
        rec = sum(cfg.block_pattern[l % len(cfg.block_pattern)] == "rglru"
                  for l in range(cfg.n_layers))
        n["rglru_chunked"] = rec
        attn = cfg.n_layers - rec
        n["flash_attention"] = attn if forward else 0
    else:
        n["fused_mlp"] = cfg.n_layers
        n["flash_attention"] = cfg.n_layers if forward else 0
    n["decode_attention"] = 0 if forward else attn
    return n


def _copy(tree, dtype=None):
    """A copy of a tree of tensors; floating tensors cast to ``dtype``
    when one is given."""
    if isinstance(tree, dict):
        return {k: _copy(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v, dtype) for v in tree)
    if dtype is not None and tree.is_floating_point():
        return tree.to(dtype, copy=True)
    return tree.clone()


def _float32_twin(params, cfg):
    """The same weights in float32, for comparing kernel and plain paths
    of the recurrent archs.  With random weights these nets amplify any
    difference from layer to layer (``forward_arch`` records how far the
    two paths drift apart), and in bf16 a last-bit difference in the
    recurrence flips roundings, so a bf16 comparison would measure the
    net's amplification, not the kernel."""
    import torch
    return (_copy(params, torch.float32),
            dataclasses.replace(cfg, dtype=torch.float32))


def _load_model(arch: str):
    """``arch``'s published config with the kernels on and its weights
    from seed 0, built on a card that holds no other model (at most
    ``CLEAN_CARD_BYTES`` allocated before), with ``init_model``'s peak
    memory held to the weights plus ``INIT_PEAK_OVER_BYTES``."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = dataclasses.replace(get_config(arch), use_kernels=True)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held <= CLEAN_CARD_BYTES,
          f"{arch}: {held / 1e9:.2f} GB still allocated before its init")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    init = {"seconds": secs, "weights_gb": weights / 1e9,
            "peak_gb": peak / 1e9, "peak_over_weights_gb":
            (peak - weights) / 1e9, "limit_over_gb":
            INIT_PEAK_OVER_BYTES / 1e9, "held_before_gb": held / 1e9}
    print(f"{arch}: {cfg.arch_kind} {cfg.n_layers}L d={cfg.d_model} "
          f"ff={cfg.d_ff} vocab={cfg.vocab}, {n_params / 1e9:.3f} B params "
          f"in {cfg.dtype}, init {secs:.1f} s; init peak "
          f"{peak / 1e9:.3f} GB for {weights / 1e9:.3f} GB of weights "
          f"(+{(peak - weights) / 1e9:.3f} GB, limit "
          f"+{INIT_PEAK_OVER_BYTES / 1e9:.1f})")
    check(peak <= weights + INIT_PEAK_OVER_BYTES,
          f"{arch}: init_model peaked {(peak - weights) / 1e9:.3f} GB above "
          f"its weights")
    return cfg, params, n_params, init


def _rel_logit_diff(lk, lp, cfg, chunk: int = 1024, keep=None):
    """max |kernel - plain| / max |plain| over the real vocab rows (the
    padded rows hold -1e30 on both paths), and the argmax agreement, for
    (B, S, vocab) logits; with ``keep``, a (B, S) mask, over the positions
    it holds only.  Taken over ``chunk`` positions at a time, so no
    float32 copy of a whole long-prompt tensor is made."""
    import torch
    if keep is not None:
        lk, lp = lk[keep][None], lp[keep][None]
    diff = scale = agree = 0.0
    for s0 in range(0, lk.shape[1], chunk):
        a = lk[:, s0:s0 + chunk, :cfg.vocab].float()
        b = lp[:, s0:s0 + chunk, :cfg.vocab].float()
        check(bool(torch.isfinite(a).all()),
              f"{cfg.name}: kernel-path logits not finite")
        diff = max(diff, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
        agree += float((a.argmax(-1) == b.argmax(-1)).float().sum())
    return diff / scale, agree / (lk.shape[0] * lk.shape[1])


#: the profiler has now and then dropped a kernel record from a window
#: (``device_us``): a launch count read from its events may fall short of
#: the launches by this share, never exceed them
PROFILE_DROP_SHARE = 0.02


def _kernel_events(prof) -> dict:
    """Each model kernel's launches in a profiled window, from its device
    events (``fused_mlp``'s reduction of F splits and
    ``decode_attention``'s combine pass, second CUDA functions of one
    launch, not counted), and the host's ``cudaGraphLaunch`` calls."""
    import torch
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {name: sum(fn in n and "reduce" not in n and "combine" not in n
                     for n in names)
           for name, fn in MODEL_KERNELS.items()}
    out["graph_launches"] = sum(e.name.startswith("cudaGraphLaunch")
                                for e in prof.events()
                                if e.device_type
                                == torch.autograd.DeviceType.CPU)
    return out


def _check_events(label: str, seen: dict, want: dict) -> None:
    """Profiler counts against the launches they must show, allowing
    ``PROFILE_DROP_SHARE`` of dropped records and none extra."""
    for name, n in want.items():
        check(n * (1 - PROFILE_DROP_SHARE) <= seen[name] <= n,
              f"{label}: the profiler saw {seen[name]} {name} launches, "
              f"expected {n}")


def _wrapper_launches(engine, per_tick: dict) -> dict:
    """What the kernels' wrappers count in an engine's run: once per
    layer and tick eagerly; with the CUDA graph, once per layer in each
    warm-up step and in each capture (the plain and the instrumented
    graph), whatever the ticks (replays launch no wrapper)."""
    from repro_torch.runtime.serve_loop import GRAPH_WARMUP_STEPS
    if engine.cuda_graph:
        steps = (GRAPH_WARMUP_STEPS + engine.log.captures if engine.ticks
                 else 0)
    else:
        steps = engine.ticks
    return {name: n * steps for name, n in per_tick.items()}


def _check_engine_launches(label: str, engines, launches: dict) -> None:
    """The wrappers' counts of a run of ``engines`` (``_wrapper_launches``
    summed), and each graph engine's one replay a tick."""
    for e in engines:
        check(not e.cuda_graph or e.graph_replays == e.ticks,
              f"{label}: {e.graph_replays} graph replays in {e.ticks} "
              "ticks")
    for name in launches:
        want = sum(_wrapper_launches(e, _per_call(e.cfg))[name]
                   for e in engines)
        check(launches[name] == want,
              f"{label}: {name} launched {launches[name]} times, "
              f"expected {want}")


def _serve_run(params, cfg, cuda_graph: bool):
    """A fresh engine answers the 6 requests; (engine, finished requests,
    each tick's seconds on the host clock: a tick ends in its sync)."""
    import torch
    from repro_torch.runtime.serve_loop import Request, ServeEngine
    engine = ServeEngine(params, cfg, batch_slots=4, max_len=128,
                         device="cuda", cuda_graph=cuda_graph)
    for i in range(6):
        engine.submit(Request(rid=i, prompt=[2 + i, 7, 3 * i + 1],
                              max_new_tokens=12))
    torch.cuda.synchronize()
    done, tick_s = [], []
    while engine.queue or any(r is not None for r in engine.active):
        t0 = time.perf_counter()
        done += engine.step()
        tick_s.append(time.perf_counter() - t0)
    return engine, done, tick_s


def _serve_record(arch, cfg, engine, done, tick_s, launches, peak_gb):
    check(len(done) == 6 and all(len(r.output) == 12 for r in done),
          f"{arch}: served {len(done)} of 6 requests "
          f"({[len(r.output) for r in done]} tokens)")
    for r in done:
        check(all(0 <= t < cfg.vocab for t in r.output),
              f"{arch} rid {r.rid}: token out of vocab {r.output}")
    tokens = sum(len(r.output) for r in done)
    steady = tick_s[1:]
    return {"cuda_graph": engine.cuda_graph, "requests": len(done),
            "tokens": tokens, "ticks": engine.ticks,
            "seconds": sum(tick_s), "tokens_per_s": tokens / sum(tick_s),
            "first_tick_ms": tick_s[0] * 1e3,
            "ms_per_tick": sum(steady) / len(steady) * 1e3,
            "steady_tokens_per_s": tokens * len(steady) / len(tick_s)
            / sum(steady),
            "peak_memory_gb": peak_gb, "launches": launches,
            "graph_replays": engine.graph_replays}


def serve_arch(arch: str, params, cfg):
    """``arch`` at full width answers 6 requests through ``ServeEngine``
    with the kernels on, twice: eagerly (``cuda_graph=False``) and with
    each tick one replay of a captured CUDA graph, the main path.  The
    two runs' tokens and last logits must be the same bits.  The
    wrappers count every kernel of the path once per layer that runs it
    and tick eagerly, and once per layer in the graph's warm-up and
    capture; a third run of the graph engine under the profiler must show
    one ``cudaGraphLaunch`` a tick and, inside the replays, every kernel
    once per layer and tick.  ms/tick is the mean of the ticks after the
    first (the graph engine captures in its first).  Then one decode step
    is compared with the plain path from the same cache: in bf16 for the
    dense, moe and vlm archs, through ``_float32_twin`` (the cache cast to
    float32) for the recurrent ones.  A MoE arch's bf16 reading is
    recorded with the plain step given the kernel path's expert picks
    (``_pinned_routing``) and without, and not held: these random-weight
    nets grow the last bits in which any two decode attentions differ
    into another output (granite-moe-1b-a400m reads 0.12 between
    ``_sdpa`` and a float32 witness with no kernel, the picks pinned).
    A MoE arch is held instead layer by layer (``_decode_layers``): each
    layer's attention in bf16, the served path (``MOE_ATTN_TOL_BF16``),
    and each whole layer in float32 (``LAYER_TOL``); in bf16 the kernel
    path with each row's newest key left out (``_newest_key_dropped``)
    must read above the bf16 limit in every layer, which shows that the
    limit sees such a fault.  The kernel path's
    step is taken a second time from another copy of the cache and must
    give the same bits.  A vlm serves text only, as the reference's
    decode."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step
    from repro_torch.runtime.serve_loop import (GRAPH_WARMUP_STEPS, Request,
                                                ServeEngine)

    n_params = sum(t.numel() for t in _leaves(params))
    parts = {}                           # host seconds of each part
    t_part = time.perf_counter()

    def lap(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    # warm-up engine (cuBLAS handles, the kernel libraries) before the run
    warm = ServeEngine(params, cfg, batch_slots=4, max_len=128,
                       device="cuda", cuda_graph=False)
    warm.submit(Request(rid=-1, prompt=[1, 2], max_new_tokens=2))
    warm.run()
    del warm

    per_tick = _per_call(cfg)
    runs = {}
    for label, graph in (("eager", False), ("graph", True)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        engine, done, tick_s = _serve_run(params, cfg, graph)
        torch.cuda.synchronize()
        launches = _counts()
        _check_engine_launches(f"{arch} {label}", [engine], launches)
        runs[label] = (engine, done, _serve_record(
            arch, cfg, engine, done, tick_s, launches,
            torch.cuda.max_memory_allocated() / 1e9))
        lap(f"{label}_run")
    (eager, e_done, e_rec), (graph, g_done, serve) = (runs.pop("eager"),
                                                      runs.pop("graph"))
    e_tokens = {r.rid: r.output for r in e_done}
    check({r.rid: r.output for r in g_done} == e_tokens,
          f"{arch}: the graph engine's tokens differ from the eager "
          "engine's")
    # the last tick's logits: recorded; a difference is stated, not fatal
    # (the tokens above are the check)
    logits_equal = bool(torch.equal(graph.logits, eager.logits))
    logits_diff = float((graph.logits.float() - eager.logits.float()
                         ).abs().max())
    del graph, g_done

    # the graph engine once more under the profiler: the replays' kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p_engine, p_done, _ = _serve_run(params, cfg, True)
        torch.cuda.synchronize()
    seen = _kernel_events(prof)
    del prof
    check({r.rid: r.output for r in p_done} == e_tokens,
          f"{arch}: the profiled graph run's tokens differ")
    ticks = p_engine.ticks
    want = {name: n * (ticks + GRAPH_WARMUP_STEPS)
            for name, n in per_tick.items()}
    want["graph_launches"] = ticks
    _check_events(f"{arch} graph run", seen, want)
    del p_engine, p_done
    lap("profiled_graph_run")

    serve.update(arch=arch, params_b=n_params / 1e9,
                 replayed_launches=seen, eager=e_rec,
                 tokens_bit_equal=True, logits_bit_equal=logits_equal,
                 logits_max_abs_diff=logits_diff)
    print("serve " + json.dumps(serve))
    print(f"{arch} serve: graph {serve['ms_per_tick']:.2f} ms/tick "
          f"({serve['steady_tokens_per_s']:.1f} tok/s steady, first tick "
          f"{serve['first_tick_ms']:.1f} ms, peak "
          f"{serve['peak_memory_gb']:.2f} GB), eager "
          f"{e_rec['ms_per_tick']:.2f} ms/tick "
          f"({e_rec['steady_tokens_per_s']:.1f} tok/s, peak "
          f"{e_rec['peak_memory_gb']:.2f} GB); tokens bit-equal, last "
          f"logits bit-equal: {logits_equal} (max |diff| {logits_diff:.3g})")
    for r in sorted(e_done, key=lambda r: r.rid)[:2]:
        print(f"  rid={r.rid} out={r.output}")

    # one decode step from the same cache state, kernel path vs plain
    engine = eager
    feed = torch.tensor([[3 + s] for s in range(engine.B)], device="cuda")
    index = torch.from_numpy(engine.pos.copy()).to("cuda")
    p_cmp, c_cmp = ((params, cfg) if cfg.arch_kind in ("dense", "moe",
                                                        "vlm")
                    else _float32_twin(params, cfg))
    logits, routes = {}, {True: [], False: []}
    moe = bool(cfg.n_experts)
    with torch.inference_mode():
        for use in (True, False):
            c = dataclasses.replace(c_cmp, use_kernels=use)
            with _routings(routes[use]):
                logits[use], _ = decode_step(
                    p_cmp, c, feed, _copy(engine.cache, c_cmp.dtype), index)
        unpinned = None
        if moe:
            flips = sum(int(_routing_diffs(rk, rp)[0].sum())
                        for rk, rp in zip(routes[True], routes[False]))
            unpinned = {"logit_rel_diff": _rel_logit_diff(
                logits[True], logits[False], cfg)[0], "routing_flips": flips}
            with _pinned_routing([r[0] for r in routes[True]]):
                logits[False], _ = decode_step(
                    p_cmp, dataclasses.replace(c_cmp, use_kernels=False),
                    feed, _copy(engine.cache, c_cmp.dtype), index)
        again, _ = decode_step(p_cmp, c_cmp, feed,
                               _copy(engine.cache, c_cmp.dtype), index)
        layer_rels = {}
        if moe:
            for name, dtype in (("bfloat16", cfg.dtype),
                                ("float32", torch.float32)):
                layer_rels[name] = _decode_layers(
                    params, cfg, engine.cache, feed, index, dtype)
            with _newest_key_dropped():
                layer_rels["bfloat16_fault"] = _decode_layers(
                    params, cfg, engine.cache, feed, index, cfg.dtype)
    repeatable = bool(torch.equal(again, logits[True]))
    del again, engine, eager
    check(repeatable, f"{arch}: two decode steps from the same cache gave "
                      "different bits")
    check(logits[True].shape == (4, 1, cfg.padded_vocab),
          f"{arch}: kernel-path logits {tuple(logits[True].shape)}")
    rel, agree = _rel_logit_diff(logits[True], logits[False], cfg)
    dt_name = str(c_cmp.dtype).removeprefix("torch.")
    serve.update(logit_rel_diff=rel, logit_tol=LOGIT_TOL,
                 logit_dtype=dt_name, argmax_agreement=agree,
                 decode_repeatable=repeatable, routing_unpinned=unpinned,
                 layer_rel_diff=layer_rels or None, layer_tol=LAYER_TOL,
                 attention_tol_bf16=MOE_ATTN_TOL_BF16)
    bf16, f32, fault = (layer_rels.get(k) for k in (
        "bfloat16", "float32", "bfloat16_fault"))
    print(f"{arch} decode step ({dt_name}), kernel vs plain path"
          f"{' (expert picks pinned)' if moe else ''}: max "
          f"|diff| / max |logit| = {rel:.3g} (tol {LOGIT_TOL}"
          f"{', not held: see below' if moe else ''}), argmax "
          f"agreement {agree:.2f}, a second step bit-equal: {repeatable}"
          + (f"; unpinned {unpinned['logit_rel_diff']:.3g} with "
             f"{unpinned['routing_flips']} routing flips; each layer "
             f"kernel vs plain from the same input: bf16 attention max "
             f"{max(bf16['attention']):.3g} (tol {MOE_ATTN_TOL_BF16}), "
             f"with the newest key dropped min {min(fault['attention']):.3g}"
             f"; float32 layer max {max(f32['layer']):.3g} "
             f"(tol {LAYER_TOL})" if moe else ""))
    if moe:
        check(max(bf16["attention"]) <= MOE_ATTN_TOL_BF16,
              f"{arch}: a decode layer's bf16 kernel-path attention is off "
              f"by {max(bf16['attention']):.3g}: {bf16['attention']}")
        check(min(fault["attention"]) > MOE_ATTN_TOL_BF16,
              f"{arch}: a decode layer's attention with the newest key "
              f"dropped reads {min(fault['attention']):.3g}, within the "
              f"limit {MOE_ATTN_TOL_BF16}: {fault['attention']}")
        check(max(f32["layer"]) <= LAYER_TOL,
              f"{arch}: a decode layer's float32 kernel-path output is off "
              f"by {max(f32['layer']):.3g}: {f32['layer']}")
    else:
        check(rel <= LOGIT_TOL,
              f"{arch}: kernel path logits off by {rel:.3g}")
    del p_cmp, logits
    gc.collect()
    lap("decode_step_vs_plain")
    serve["profile"] = profile_ticks(params, cfg, serve["ms_per_tick"],
                                     cuda_graph=True)
    lap("profile_graph")
    serve["eager"]["profile"] = profile_ticks(
        params, cfg, e_rec["ms_per_tick"], cuda_graph=False)
    lap("profile_eager")
    serve["part_seconds"] = parts
    print(f"{arch} serve parts (s): " + json.dumps(parts))
    return serve


def _decode_layers(params, cfg, cache, feed, index, dtype) -> dict:
    """One decode step of a uniform-layer arch in ``dtype``, one layer at
    a time (in float32 each layer's twin: a float32 copy of a whole MoE
    model need not fit the card): each layer on the kernel path against
    the plain path from the same input and a copy of that layer's cache,
    the plain path given the kernel path's expert picks
    (``_pinned_routing``); the next layer takes the kernel path's output.
    Each layer's max |diff| / max |output| ("layer"), and the same of its
    attention's output ("attention", before the residual add: in bf16 the
    layer's output rounds the residual stream, whose largest values
    dwarf one attention's part)."""
    import torch
    from repro_torch.models.transformer import (_embed, _layer,
                                                _uniform_layer,
                                                layer_windows)
    cast = dtype if dtype != cfg.dtype else None
    kern = dataclasses.replace(cfg, dtype=dtype)
    plain = dataclasses.replace(kern, use_kernels=False)
    x = _embed(params["embed"], feed).to(dtype)
    positions = index[:, None]
    rels = {"layer": [], "attention": []}
    for l, win in enumerate(layer_windows(cfg)):
        lp = _layer(params["layers"], l)
        lp = lp if cast is None else _copy(lp, cast)
        lc = _layer(cache, l)
        lc = lc if cast is None else _copy(lc, cast)
        routes, attn = [], []
        with _routings(routes), _attention_outputs(attn):
            out, _ = _uniform_layer(kern, x, lp, win, positions, _copy(lc),
                                    index)
        with _pinned_routing([r[0] for r in routes]), \
                _attention_outputs(attn):
            want, _ = _uniform_layer(plain, x, lp, win, positions,
                                     _copy(lc), index)
        rels["layer"].append(_layer_rel(out.float(), want.float()))
        rels["attention"].append(_layer_rel(attn[0].float(), attn[1].float()))
        x = out
        del lp, lc, want, attn
    return rels


@contextlib.contextmanager
def _attention_outputs(out: list):
    """While active, each ``attention`` call of a decoder layer appends
    its output to ``out``."""
    from repro_torch.models import transformer
    attention = transformer.attention

    def recording(*args, **kwargs):
        o = attention(*args, **kwargs)
        out.append(o)
        return o

    transformer.attention = recording
    try:
        yield
    finally:
        transformer.attention = attention


@contextlib.contextmanager
def _newest_key_dropped():
    """While active, the decode kernel reads each row as if it sat one
    position earlier: before the ring wraps, its newest key (the one the
    step has just written) is left out, an off-by-one in the fill."""
    from repro_torch.models import layers
    op = layers.decode_attention_op

    def faulty(q, k, v, positions, window):
        return op(q, k, v, (positions - 1).clamp(min=0), window)

    layers.decode_attention_op = faulty
    try:
        yield
    finally:
        layers.decode_attention_op = op


def profile_ticks(params, cfg, ms_per_tick: float, cuda_graph: bool,
                  ticks: int = 8):
    """Device time of a steady decode tick, by ``torch.profiler``: the
    sum of kernel durations per tick, each hand-written kernel's part and
    launches, the host's ``cudaGraphLaunch`` calls per tick (one with the
    graph, none eagerly), and the device's busy share of the unprofiled
    tick time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve_loop import Request, ServeEngine
    engine = ServeEngine(params, cfg, batch_slots=4, max_len=128,
                         device="cuda", cuda_graph=cuda_graph)
    for i in range(4):
        engine.submit(Request(rid=i, prompt=[5 + i], max_new_tokens=64))
    for _ in range(4):
        engine.step()
    torch.cuda.synchronize()
    # the eager window traces device activity only: its thousands of host
    # ops a tick took the profiler 6-38 s an arch to parse, and nothing
    # here reads them (an eager tick launches no graph)
    with profile(activities=[ProfilerActivity.CUDA] if not cuda_graph else
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    out = _device_time(prof, ticks, "_per_tick")
    if out is None:
        return None
    seen = _kernel_events(prof)
    want = {name: n * ticks for name, n in _per_call(cfg).items()}
    want["graph_launches"] = ticks if cuda_graph else 0
    _check_events(f"{cfg.name} profile", seen, want)
    out.update(ticks=ticks, cuda_graph=cuda_graph,
               graph_launches_per_tick=seen["graph_launches"] / ticks,
               launches_per_tick={name: seen[name] / ticks
                                  for name in MODEL_KERNELS},
               busy_share=out["device_ms_per_tick"] / ms_per_tick)
    print(f"profile {cfg.name} " + json.dumps(out))
    return out


def _device_time(prof, calls: int, suffix: str = ""):
    """Device time of a profiled window per one of its ``calls``: the sum
    of kernel durations (``device_ms``), each hand-written model kernel's
    part (``<name>_ms``) and the device operation count
    (``device_ops``), each key ending in ``suffix``; None if the profiler
    saw no device events."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler saw no device events; device time "
              "not measured")
        return None
    out = {f"device_ms{suffix}": sum(e.time_range.elapsed_us()
                                     for e in kernels) / calls / 1e3}
    for name, fn_name in MODEL_KERNELS.items():
        us = sum(e.time_range.elapsed_us() for e in kernels
                 if fn_name in e.name)
        if us:
            out[f"{name}_ms{suffix}"] = us / calls / 1e3
    out[f"device_ops{suffix}"] = len(kernels) / calls
    return out


def _wkv6_float64(r, k, v, w, u, s0=None, exact: bool = False):
    """``wkv6_ref``'s recurrence in float64, rounded to float32 on the
    way out (kept in float64 with ``exact``)."""
    import torch
    r, k, v, w, u = (t.double() for t in (r, k, v, w, u))
    BH, T, N = r.shape
    s = (torch.zeros((BH, N, N), dtype=torch.float64, device=r.device)
         if s0 is None else s0.double())
    ys = []
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append(torch.bmm(r[:, t, None, :],
                            s + u[:, 0, :, None] * kv)[:, 0])
        s = w[:, t, :, None] * s + kv
    if exact:
        return torch.stack(ys, dim=1), s
    return torch.stack(ys, dim=1).float(), s.float()


def _rglru_float64(a, b, h0=None):
    """``rglru_ref``'s recurrence in float64, rounded to float32 on the
    way out."""
    import torch
    a, b = a.double(), b.double()
    h = (torch.zeros_like(a[:, 0]) if h0 is None
         else h0.double().reshape(a[:, 0].shape))
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).float(), h[:, None, :].float()


def _wkv6_blocks_float64(r, k, v, log_w, u, s0=None):
    """``_wkv6_float64`` in the plain form's signature: the log decays."""
    return _wkv6_float64(r, k, v, log_w.double().exp(), u, s0)


@contextlib.contextmanager
def _recurrence_in_float64():
    """The models' plain path with its recurrence in float64, step by
    step (the witnesses' recurrences): a witness difference that owes
    nothing to the kernels."""
    from repro_torch.models import rglru, rwkv6
    plain = rwkv6.wkv6_blocks, rglru.rglru_doubling
    rwkv6.wkv6_blocks, rglru.rglru_doubling = (_wkv6_blocks_float64,
                                               _rglru_float64)
    try:
        yield
    finally:
        rwkv6.wkv6_blocks, rglru.rglru_doubling = plain


def _picks(rel):
    return [f"{rel[i]:.2g}" for i in sorted({0, 5, 11, 17, len(rel) - 1})
            if i < len(rel)]


def forward_arch(arch: str, params, cfg, B: int = 2, S: int = 512):
    """``forward`` at full width on a (B, S) prompt, timed in bf16 with
    the kernels (one launch per recurrent layer) and on the plain path.
    Then, through ``_float32_twin``, layer by layer: each layer's output
    with the kernels against the plain path's from the same input (the
    check, ``LAYER_TOL``), and the two paths run apart from the embedding
    to the logits.  A witness runs beside them: the plain path with its
    recurrence in float64 (``_recurrence_in_float64``), also apart from
    the embedding.  With random weights these nets grow any difference
    from layer to layer whatever its source: the float32 plain path
    itself ends far from the float64 one.  So the end-to-end check holds
    the kernel path against the float64 witness (``LOGIT_TOL``), and
    kernel vs float32 plain is reported beside plain vs witness."""
    import torch
    from repro_torch.models import forward
    from repro_torch.models.transformer import _layer_fns, _logits
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    secs, logits = {}, {}
    with torch.inference_mode():
        forward(params, cfg, toks[:, :8])                 # warm-up
        for use in (True, False):
            c = dataclasses.replace(cfg, use_kernels=use)
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            logits[use], _ = forward(params, c, toks)
            torch.cuda.synchronize()
            secs[use] = time.perf_counter() - t0
            if use:
                launches = _counts()
        bf16_rel, _ = _rel_logit_diff(logits[True], logits[False], cfg)
        del logits
        breakdown = profile_forward(params, cfg, toks)
        p32, c32 = _float32_twin(params, cfg)
        kernel_fns = _layer_fns(p32, c32)
        plain_fns = _layer_fns(p32, dataclasses.replace(c32,
                                                        use_kernels=False))
        positions = torch.arange(S, device="cuda")
        xk = xp = xw = p32["embed"][toks]
        layer_rel, apart_rel, witness_rel = [], [], []
        for fk, fp in zip(kernel_fns, plain_fns):
            nk, _ = fk(xk, positions, None, None)
            layer_rel.append(float((nk - fp(xk, positions, None, None)[0])
                                   .abs().max() / nk.abs().max()))
            xk, xp = nk, fp(xp, positions, None, None)[0]
            apart_rel.append(float((xk - xp).abs().max() / xp.abs().max()))
            with _recurrence_in_float64():
                xw, _ = fp(xw, positions, None, None)
            witness_rel.append(float((xw - xp).abs().max()
                                     / xp.abs().max()))
        lk, lp, lw = (_logits(p32, c32, x) for x in (xk, xp, xw))
        f32_rel, agree = _rel_logit_diff(lk, lp, cfg)
        w_rel, w_agree = _rel_logit_diff(lw, lp, cfg)
        kw_rel, _ = _rel_logit_diff(lk, lw, cfg)
        del p32, xk, xp, xw, lk, lp, lw
    for name, per_call in _per_call(cfg, forward=True).items():
        check(launches[name] == per_call,
              f"{arch} forward: {name} launched {launches[name]} times, "
              f"expected {per_call}")
    row = {"arch": arch, "B": B, "S": S, "kernel_s": secs[True],
           "plain_s": secs[False], "launches": launches,
           "profile": breakdown,
           "layer_rel_diff_max": max(layer_rel), "layer_tol": LAYER_TOL,
           "layer_rel_diff": layer_rel, "apart_rel_diff": apart_rel,
           "witness_rel_diff": witness_rel,
           "logit_rel_diff_float32": f32_rel,
           "argmax_agreement_float32": agree,
           "witness_logit_rel_diff": w_rel,
           "witness_argmax_agreement": w_agree,
           "kernel_vs_float64_logit_rel_diff": kw_rel,
           "logit_rel_diff_bf16": bf16_rel}
    print("forward " + json.dumps({k: v for k, v in row.items()
                                   if k not in ("layer_rel_diff",
                                                "apart_rel_diff",
                                                "witness_rel_diff")}))
    print(f"{arch} forward, run apart from the embedding (float32), "
          "max |diff| / max |x| after layers 1, 6, 12, 18, last: kernel vs "
          f"plain {_picks(apart_rel)}; plain with the recurrence in float64 "
          f"vs plain {_picks(witness_rel)}")
    check(max(layer_rel) <= LAYER_TOL,
          f"{arch} forward: a layer's kernel-path output is off by "
          f"{max(layer_rel):.3g} (tol {LAYER_TOL}): {layer_rel}")
    check(kw_rel <= LOGIT_TOL,
          f"{arch} forward: kernel-path logits off the plain path with its "
          f"recurrence in float64 by {kw_rel:.3g} (tol {LOGIT_TOL})")
    return row


def forward_long(arch: str, params, cfg, B: int = 1, S: int = 8192):
    """``forward`` at full width on a (B, S) prompt at the reference's
    chunked-attention length, timed in bf16 with the kernels (one flash
    and one ``fused_mlp`` launch per layer, nothing else) and on the
    plain path (``_sdpa_chunked``).  The bf16 logits of the two paths are
    compared in chunks of positions, so no float32 copy of the whole
    (B, S, vocab) tensor is made.  Then, through ``_float32_twin``, each
    layer's output with the kernels is held against the plain path's
    from the same input (``LAYER_TOL``)."""
    import torch
    from repro_torch.models import forward
    from repro_torch.models.layers import CHUNKED_ATTN_THRESHOLD
    from repro_torch.models.transformer import _layer_fns
    check(S >= CHUNKED_ATTN_THRESHOLD,
          f"S={S} does not reach the chunked path")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    secs, logits = {}, {}
    with torch.inference_mode():
        forward(params, cfg, toks[:, :64])                # warm-up
        forward(params, plain_cfg, toks)
        for use in (True, False):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            logits[use], _ = forward(params, cfg if use else plain_cfg,
                                     toks)
            torch.cuda.synchronize()
            secs[use] = time.perf_counter() - t0
            if use:
                launches = _counts()
        check(logits[True].shape == (B, S, cfg.padded_vocab),
              f"{arch} forward: logits {tuple(logits[True].shape)}")
        rel, agree = _rel_logit_diff(logits[True], logits[False], cfg)
        del logits
        breakdown = profile_forward(params, cfg, toks)
        p32, c32 = _float32_twin(params, cfg)
        kernel_fns = _layer_fns(p32, c32)
        plain_fns = _layer_fns(p32, dataclasses.replace(c32,
                                                        use_kernels=False))
        positions = torch.arange(S, device="cuda")
        x = p32["embed"][toks]
        layer_rel = []
        for fk, fp in zip(kernel_fns, plain_fns):
            nk, _ = fk(x, positions, None, None)
            layer_rel.append(float((nk - fp(x, positions, None, None)[0])
                                   .abs().max() / nk.abs().max()))
            x = nk
        del p32, x, nk
    for name, per_call in _per_call(cfg, forward=True).items():
        check(launches[name] == per_call,
              f"{arch} forward: {name} launched {launches[name]} times, "
              f"expected {per_call}")
    row = {"arch": arch, "B": B, "S": S, "kernel_s": secs[True],
           "plain_s": secs[False], "launches": launches,
           "profile": breakdown,
           "layer_rel_diff_max": max(layer_rel), "layer_tol": LAYER_TOL,
           "layer_rel_diff": layer_rel, "logit_rel_diff_bf16": rel,
           "logit_tol": LOGIT_TOL, "argmax_agreement_bf16": agree}
    print("forward " + json.dumps({k: v for k, v in row.items()
                                   if k != "layer_rel_diff"}))
    print(f"{arch} forward (float32 twin), each layer kernel vs plain from "
          f"the same input, max |diff| / max |x| after layers 1, 6, 12, 18, "
          f"last: {_picks(layer_rel)}")
    check(max(layer_rel) <= LAYER_TOL,
          f"{arch} forward: a layer's kernel-path output is off by "
          f"{max(layer_rel):.3g} (tol {LAYER_TOL}): {layer_rel}")
    check(rel <= LOGIT_TOL,
          f"{arch} forward: bf16 kernel-path logits off the plain path's by "
          f"{rel:.3g} (tol {LOGIT_TOL})")
    return row


def forward_timed(arch: str, params, cfg, B: int = 1, S: int = 4096):
    """``forward`` at full width on a (B, S) prompt with the kernels only:
    its host time, its launch counts (one per layer that runs a kernel)
    and its device time by kernel.  Correctness at this length is held by
    the kernel rows (``check_wkv6``'s ``prefill-long``); no plain or
    float64 forward runs here."""
    import torch
    from repro_torch.models import forward
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    with torch.inference_mode():
        forward(params, cfg, toks)                        # warm-up
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        logits, _ = forward(params, cfg, toks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _counts()
        check(logits.shape == (B, S, cfg.padded_vocab)
              and bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
              f"{arch} forward ({B}, {S}): logits "
              f"{tuple(logits.shape)} not finite or misshapen")
        del logits
        breakdown = profile_forward(params, cfg, toks)
    for name, per_call in _per_call(cfg, forward=True).items():
        check(launches[name] == per_call,
              f"{arch} forward ({B}, {S}): {name} launched "
              f"{launches[name]} times, expected {per_call}")
    row = {"arch": arch, "B": B, "S": S, "kernel_s": secs,
           "launches": launches, "profile": breakdown}
    print("forward " + json.dumps(row))
    return row


@contextlib.contextmanager
def _routings(out: list):
    """While active, each ``moe_ffn`` call appends its routing to ``out``:
    (the K experts each (sample, token) picked, in the router's order;
    which of them were kept at capacity), each (B, S, K), read from
    ``layers.moe_dispatch``'s inputs and outputs."""
    from repro_torch.models import layers
    dispatch = layers.moe_dispatch

    def recording(idx, E, C):
        tok1, slot = dispatch(idx, E, C)
        out.append((idx, slot < C))
        return tok1, slot

    layers.moe_dispatch = recording
    try:
        yield
    finally:
        layers.moe_dispatch = dispatch


@contextlib.contextmanager
def _pinned_routing(idxs: list):
    """While active, the i-th ``moe_ffn`` call routes its tokens to the
    experts ``idxs[i]`` (another run's picks, as ``_routings`` records
    them), with gates from its own router's probabilities at those
    experts, renormalised as ``moe_route`` does."""
    import torch
    from repro_torch.models import layers
    route = layers.moe_route
    calls = iter(idxs)

    def pinned(p, x, cfg):
        probs, _, _ = route(p, x, cfg)
        idx = next(calls)
        gate = torch.gather(probs, -1, idx)
        return probs, gate / torch.clamp(gate.sum(-1, keepdim=True),
                                         min=1e-9), idx

    layers.moe_route = pinned
    try:
        yield
    finally:
        layers.moe_route = route


def _routing_diffs(rk, rp):
    """(B, S) masks of the positions whose routing differs between two
    runs of one layer: ``flips``, another set of experts picked, and
    ``drops``, the same experts with another set dropped at capacity."""
    import torch

    def picks(r):
        return torch.sort(r[0], dim=-1).values

    def kept(r):
        return torch.sort(torch.where(r[1], r[0], -1), dim=-1).values

    flips = (picks(rk) != picks(rp)).any(-1)
    return flips, (kept(rk) != kept(rp)).any(-1) & ~flips


@contextlib.contextmanager
def _attention_plain_version():
    """While active, attention without a cache under ``use_kernels``
    calls the flash kernel's plain version (``attention_op_ref``: float32
    scores and sums, one rounding on the way out) in place of the kernel:
    a path that differs from ``_sdpa``'s in rounding only and launches no
    kernel."""
    from repro_torch.kernels.flash_attention import attention_op_ref
    from repro_torch.models import layers
    kernel = layers.attention_op
    layers.attention_op = attention_op_ref
    try:
        yield
    finally:
        layers.attention_op = kernel


def forward_slice(arch: str, params, cfg, B: int = 1, S: int = 512):
    """``forward`` at full width on a (B, S) prompt in bf16, timed with
    the kernels (one flash launch per layer; one ``fused_mlp`` launch per
    layer for the dense archs, whose D = 5120 takes the wgmma regime) and
    on the plain path (``_sdpa``), both bit-equal to a second run; the
    kernel path's time over the plain path's is printed.

    A MoE layer picks its experts from the attention's output, and where
    a token's k-th and (k+1)-th router probabilities nearly tie, the last
    bits in which flash and ``_sdpa`` differ pick another expert.  Every
    (layer, token) whose routing differs between the two paths is
    counted, and the bf16 logits are held (``LOGIT_TOL``) on the
    positions whose routing agrees in every layer.  A flip changes that
    token's state in every later layer and, through attention, every
    later token's, so few positions may agree.  Three more bf16 readings
    are reported beside it, with every path given the kernel path's
    expert picks (``_pinned_routing``): kernel vs plain; the witness,
    the flash kernel's plain version (``_attention_plain_version``, no
    kernel) vs plain, which shows how far these random-weight nets grow
    a last-bit difference that owes nothing to the kernel; and kernel vs
    witness.

    Then in float32, one layer's twin at a time (a float32 copy of a
    whole model does not fit the card beside it): each layer's output
    with the kernels against the plain path's from the same input
    (``LAYER_TOL``), on the tokens whose routing agrees in that layer;
    and the two paths run apart from the embedding to the logits, held
    (``LOGIT_TOL``) on the positions whose routing agrees in every
    layer, flips counted."""
    import torch
    from repro_torch.models import forward
    from repro_torch.models.transformer import (BIG_WINDOW, _layer,
                                                _logits, _uniform_layer,
                                                layer_windows)
    moe = bool(cfg.n_experts)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    secs, logits, aux, routes = {}, {}, {}, {}

    def routing_apart(rk_list, rp_list):
        """Flips per layer and the (B, S) mask of positions whose routing
        agrees in every layer, for two runs' ``_routings`` records."""
        flips = drops = torch.zeros((B, S), dtype=torch.long, device="cuda")
        per_layer = []
        for rk, rp in zip(rk_list, rp_list):
            f, d = _routing_diffs(rk, rp)
            flips, drops = flips + f, drops + d
            per_layer.append(int(f.sum()))
        return (int(flips.sum()), int(drops.sum()), per_layer,
                (flips + drops) == 0)

    with torch.inference_mode():
        forward(params, cfg, toks[:, :8])                 # warm-up
        forward(params, plain_cfg, toks)
        for use in (True, False):
            c = cfg if use else plain_cfg
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            logits[use], aux[use] = forward(params, c, toks)
            torch.cuda.synchronize()
            secs[use] = time.perf_counter() - t0
            if use:
                launches = _counts()
            routes[use] = []
            with _routings(routes[use]):
                again, _ = forward(params, c, toks)
            check(bool(torch.equal(again, logits[use])),
                  f"{arch} forward (use_kernels={use}): a second run gave "
                  "different bits")
            del again
        check(logits[True].shape == (B, S, cfg.padded_vocab),
              f"{arch} forward: logits {tuple(logits[True].shape)}")
        n_flips, n_drops, layer_flips, agree = routing_apart(routes[True],
                                                             routes[False])
        n_agree = int(agree.sum())
        check(n_agree > 0, f"{arch} forward: every position's routing "
                           "differs between the paths in some layer")
        rel_all, _ = _rel_logit_diff(logits[True], logits[False], cfg)
        rel, agree_argmax = _rel_logit_diff(logits[True], logits[False], cfg,
                                            keep=agree)
        pinned = None
        if moe:
            picks = [r[0] for r in routes[True]]
            with _pinned_routing(picks):
                lpin, _ = forward(params, plain_cfg, toks)
            with _pinned_routing(picks), _attention_plain_version():
                lwit, _ = forward(params, cfg, toks)
            pinned = {"kernel_vs_plain": _rel_logit_diff(logits[True], lpin,
                                                         cfg)[0],
                      "witness_vs_plain": _rel_logit_diff(lwit, lpin,
                                                          cfg)[0],
                      "kernel_vs_witness": _rel_logit_diff(logits[True],
                                                           lwit, cfg)[0]}
            del lpin, lwit
        del logits
        breakdown = profile_forward(params, cfg, toks)

        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        plain32 = dataclasses.replace(c32, use_kernels=False)
        positions = torch.arange(S, device="cuda")
        xk = xp = params["embed"][toks].float()
        layer_rel, layer_diffs, rk_apart, rp_apart = [], [], [], []
        for l, win in enumerate(layer_windows(cfg)):
            lp = _copy(_layer(params["layers"], l), torch.float32)
            w = None if win >= BIG_WINDOW else win
            rk, rp = [], []
            with _routings(rk):
                nk, _ = _uniform_layer(c32, xk, lp, w, positions)
            with _routings(rp):
                same, _ = _uniform_layer(plain32, xk, lp, w, positions)
            with _routings(rp_apart):
                xp, _ = _uniform_layer(plain32, xp, lp, w, positions)
            keep = torch.ones((B, S), dtype=torch.bool, device="cuda")
            if moe:
                f, d = _routing_diffs(rk[0], rp[0])
                keep = ~(f | d)
            layer_diffs.append(int((~keep).sum()))
            layer_rel.append(float((nk - same)[keep].abs().max()
                                   / nk.abs().max()))
            rk_apart += rk
            xk = nk
            del lp, same
        head = {k: params[k].float() for k in ("embed", "ln_f", "unembed")
                if k in params}
        lk, lp32 = _logits(head, c32, xk), _logits(head, c32, xp)
        del head, xk, xp, nk
        a_flips, a_drops, a_layer_flips, a_agree = routing_apart(rk_apart,
                                                                 rp_apart)
        rel32, agree32_argmax = _rel_logit_diff(lk, lp32, cfg, keep=a_agree)
        rel32_all, _ = _rel_logit_diff(lk, lp32, cfg)
        del lk, lp32
    for name, per_call in _per_call(cfg, forward=True).items():
        check(launches[name] == per_call,
              f"{arch} forward: {name} launched {launches[name]} times, "
              f"expected {per_call}")
    row = {"arch": arch, "B": B, "S": S, "kernel_s": secs[True],
           "plain_s": secs[False],
           "kernel_over_plain": secs[True] / secs[False],
           "launches": launches, "profile": breakdown, "repeatable": True,
           "aux_kernel": float(aux[True]), "aux_plain": float(aux[False]),
           "routing_flips": n_flips, "routing_drop_diffs": n_drops,
           "routing_flips_by_layer": layer_flips,
           "positions_agreeing": n_agree, "positions": B * S,
           "logit_rel_diff_bf16": rel, "logit_tol": LOGIT_TOL,
           "argmax_agreement_bf16": agree_argmax,
           "logit_rel_diff_bf16_all_positions": rel_all,
           "bf16_pinned_routing": pinned,
           "layer_rel_diff_max": max(layer_rel), "layer_tol": LAYER_TOL,
           "layer_rel_diff": layer_rel,
           "layer_routing_diffs_float32": sum(layer_diffs),
           "layer_routing_diffs": layer_diffs,
           "apart_float32_routing_flips": a_flips,
           "apart_float32_routing_drop_diffs": a_drops,
           "apart_float32_flips_by_layer": a_layer_flips,
           "apart_float32_positions_agreeing": int(a_agree.sum()),
           "logit_rel_diff_float32": rel32,
           "argmax_agreement_float32": agree32_argmax,
           "logit_rel_diff_float32_all_positions": rel32_all}
    print("forward " + json.dumps({k: v for k, v in row.items()
                                   if k not in ("layer_rel_diff",
                                                "layer_routing_diffs",
                                                "routing_flips_by_layer",
                                                "apart_float32_flips_by_"
                                                "layer")}))
    print(f"{arch} forward ({B}, {S}), bf16: kernel path {secs[True]:.4g} "
          f"s, plain path {secs[False]:.4g} s, kernel / plain "
          f"{secs[True] / secs[False]:.3g}")
    print(f"{arch} forward ({B}, {S}), bf16, kernel vs plain: {n_flips} "
          f"(layer, token) routings pick other experts (after layers 1, 6, "
          f"12, 18, last: {_picks(layer_flips) if moe else []}) and "
          f"{n_drops} drop others; {n_agree} of {B * S} positions agree in "
          f"every layer, their logits off by {rel:.3g} (tol {LOGIT_TOL}; "
          f"all positions {rel_all:.3g}); with the kernel path's expert "
          f"picks: {pinned}")
    print(f"{arch} forward ({B}, {S}), float32 one layer's twin at a time: "
          f"each layer kernel vs plain from the same input, max |diff| / "
          f"max |x| after layers 1, 6, 12, 18, last: {_picks(layer_rel)}, "
          f"{sum(layer_diffs)} (layer, token) routings differ; run apart, "
          f"{a_flips} flips and {a_drops} drop differences, "
          f"{int(a_agree.sum())} of {B * S} positions agree in every layer, "
          f"their logits off by {rel32:.3g} (tol {LOGIT_TOL}; all "
          f"positions {rel32_all:.3g})")
    check(max(layer_rel) <= LAYER_TOL,
          f"{arch} forward: a layer's kernel-path output is off by "
          f"{max(layer_rel):.3g} (tol {LAYER_TOL}): {layer_rel}")
    check(rel <= LOGIT_TOL,
          f"{arch} forward: bf16 kernel-path logits off the plain path's by "
          f"{rel:.3g} (tol {LOGIT_TOL}) on the positions whose routing "
          "agrees")
    check(rel32 <= LOGIT_TOL,
          f"{arch} forward: float32 kernel-path logits off the plain "
          f"path's by {rel32:.3g} (tol {LOGIT_TOL}) on the positions whose "
          "routing agrees")
    return row


def _timed(fn):
    """(``fn()``, its seconds on the host clock, synchronised)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _layer_rel(kernel_out, plain_out) -> float:
    return float((kernel_out - plain_out).abs().max()
                 / kernel_out.abs().max())


def forward_vlm(arch: str, params, cfg, B: int = 2, S_text: int = 768):
    """qwen2-vl-2b's ``forward`` at full width on B prompts of
    ``cfg.n_patches`` patch embeddings (drawn from a seed) and ``S_text``
    text tokens, in bf16 with the kernels (one flash and one ``fused_mlp``
    launch a layer, nothing else) and on the plain path, timed; the bf16
    logits (text positions) against the plain path's (``LOGIT_TOL``).
    Then one layer's float32 twin at a time, M-RoPE positions as the
    forward's: each layer's output with the kernels against the plain
    path's from the same input (``LAYER_TOL``)."""
    import torch
    from repro_torch.models import forward
    from repro_torch.models.transformer import (_layer, _uniform_layer,
                                                _vlm_positions)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    P = cfg.n_patches
    toks = torch.randint(0, cfg.vocab, (B, S_text), generator=gen,
                         device="cuda")
    patches = torch.randn((B, P, cfg.d_model), generator=gen, device="cuda")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    secs, logits = {}, {}
    with torch.inference_mode():
        forward(params, cfg, toks[:, :8], patch_embeds=patches)  # warm-up
        forward(params, plain_cfg, toks, patch_embeds=patches)
        for use in (True, False):
            _zero_counts()
            (logits[use], _), secs[use] = _timed(lambda: forward(
                params, cfg if use else plain_cfg, toks,
                patch_embeds=patches))
            if use:
                launches = _counts()
        check(logits[True].shape == (B, S_text, cfg.padded_vocab),
              f"{arch} forward: logits {tuple(logits[True].shape)}")
        rel, agree = _rel_logit_diff(logits[True], logits[False], cfg)
        del logits
        breakdown = profile_forward(params, cfg, toks, fn=lambda: forward(
            params, cfg, toks, patch_embeds=patches))

        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        plain32 = dataclasses.replace(c32, use_kernels=False)
        mrope = _vlm_positions(cfg, B, S_text, "cuda")
        positions = torch.arange(P + S_text, device="cuda")
        x = torch.cat([patches @ params["patch_proj"].float(),
                       params["embed"][toks].float()], dim=1)
        layer_rel = []
        for l in range(cfg.n_layers):
            lp = _copy(_layer(params["layers"], l), torch.float32)
            nk, _ = _uniform_layer(c32, x, lp, None, positions,
                                   mrope_positions=mrope)
            same, _ = _uniform_layer(plain32, x, lp, None, positions,
                                     mrope_positions=mrope)
            layer_rel.append(_layer_rel(nk, same))
            x = nk
            del lp, same
        del x, nk
    for name, per_call in _per_call(cfg, forward=True).items():
        check(launches[name] == per_call,
              f"{arch} forward: {name} launched {launches[name]} times, "
              f"expected {per_call}")
    row = {"arch": arch, "B": B, "patches": P, "S_text": S_text,
           "S": P + S_text, "kernel_s": secs[True], "plain_s": secs[False],
           "launches": launches, "profile": breakdown,
           "layer_rel_diff_max": max(layer_rel), "layer_tol": LAYER_TOL,
           "layer_rel_diff": layer_rel, "logit_rel_diff_bf16": rel,
           "logit_tol": LOGIT_TOL, "argmax_agreement_bf16": agree}
    print("forward " + json.dumps({k: v for k, v in row.items()
                                   if k != "layer_rel_diff"}))
    print(f"{arch} forward ({B}, {P} + {S_text}), float32 one layer's twin "
          f"at a time, each layer kernel vs plain from the same input, max "
          f"|diff| / max |x| after layers 1, 6, 12, 18, last: "
          f"{_picks(layer_rel)}; bf16 logits off by {rel:.3g}")
    check(max(layer_rel) <= LAYER_TOL,
          f"{arch} forward: a layer's kernel-path output is off by "
          f"{max(layer_rel):.3g} (tol {LAYER_TOL}): {layer_rel}")
    check(rel <= LOGIT_TOL,
          f"{arch} forward: bf16 kernel-path logits off the plain path's by "
          f"{rel:.3g} (tol {LOGIT_TOL})")
    return row


def whisper_arch(arch: str, params, cfg, B: int = 4, S: int = 64,
                 steps: int = 32):
    """whisper-medium at full width on B x ``cfg.enc_frames`` frame
    embeddings (drawn from a seed) and B x S tokens, in bf16.

    ``encode_frames`` and ``whisper_forward`` with the kernels (flash in
    every encoder layer, and for self- and cross-attention in every
    decoder layer; nothing else: the GELU MLP is plain, as in the
    reference) and on the plain path, timed; the bf16 logits against the
    plain path's (``LOGIT_TOL``).  Each encoder and decoder layer as a
    float32 twin, one layer at a time, kernels against plain from the
    same input (``LAYER_TOL``).  Then ``steps`` teacher-forced
    ``whisper_decode_step``s from the encoded cache (one flash launch a
    decoder layer: cross-attention with one query row), each step's bf16
    logits against the forward's at that position (``LOGIT_TOL``), which
    holds only with the embedding of position ``index``.  One more step
    kernel vs plain from copies of the cache, and again from another copy
    for the same bits."""
    import torch
    from repro_torch.models import (encode_frames, init_cache,
                                    whisper_decode_step, whisper_forward)
    from repro_torch.models.common import rms_norm, sinusoidal_positions
    from repro_torch.models.transformer import _dec_layer, _enc_layer, _layer
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    T = cfg.enc_frames
    frames = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    secs, logits = {}, {}
    with torch.inference_mode():
        whisper_forward(params, cfg, frames, toks)            # warm-up
        whisper_forward(params, plain_cfg, frames, toks)
        enc, secs["encoder"] = _timed(lambda: encode_frames(params, cfg,
                                                            frames))
        for use in (True, False):
            _zero_counts()
            logits[use], secs[use] = _timed(lambda: whisper_forward(
                params, cfg if use else plain_cfg, frames, toks))
            if use:
                launches = _counts()
        check(logits[True].shape == (B, S, cfg.padded_vocab),
              f"{arch} forward: logits {tuple(logits[True].shape)}")
        rel, agree = _rel_logit_diff(logits[True], logits[False], cfg)
        breakdown = profile_forward(
            params, cfg, toks, label="whisper_forward",
            fn=lambda: whisper_forward(params, cfg, frames, toks))

        # teacher-forced decode from the encoded cache
        cache = dict(init_cache(cfg, B, 2 * S, device="cuda"), enc=enc)
        step_rel, step_launches, step_secs = [], [], []
        for i in range(steps):
            _zero_counts()
            (lg, cache), dt = _timed(lambda: whisper_decode_step(
                params, cfg, toks[:, i:i + 1], cache, i))
            step_launches.append(_counts())
            step_secs.append(dt)
            step_rel.append(_rel_logit_diff(lg, logits[True][:, i:i + 1],
                                            cfg)[0])
        feed = toks[:, steps:steps + 1]
        one = {}
        for use in (True, False):
            one[use], _ = whisper_decode_step(
                params, cfg if use else plain_cfg, feed, _copy(cache), steps)
        again, _ = whisper_decode_step(params, cfg, feed, _copy(cache), steps)
        repeatable = bool(torch.equal(again, one[True]))
        step_vs_plain, _ = _rel_logit_diff(one[True], one[False], cfg)
        del logits, one, again, cache

        # float32 twins, one layer at a time
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        plain32 = dataclasses.replace(c32, use_kernels=False)
        pos_enc = torch.arange(T, device="cuda")
        x = frames + sinusoidal_positions(T, cfg.d_model, device="cuda")
        enc_rel, dec_rel = [], []
        for l in range(cfg.n_enc_layers):
            lp = _copy(_layer(params["enc_layers"], l), torch.float32)
            nk = _enc_layer(c32, x, lp, pos_enc)
            enc_rel.append(_layer_rel(nk, _enc_layer(plain32, x, lp,
                                                     pos_enc)))
            x = nk
            del lp
        enc32 = rms_norm(x, params["ln_enc"], cfg.norm_eps)
        pos_dec = torch.arange(S, device="cuda")
        x = (params["embed"][toks].float()
             + sinusoidal_positions(S, cfg.d_model, device="cuda"))
        for l in range(cfg.n_layers):
            lp = _copy(_layer(params["dec_layers"], l), torch.float32)
            nk = _dec_layer(c32, x, lp, pos_dec, enc32)
            dec_rel.append(_layer_rel(nk, _dec_layer(plain32, x, lp, pos_dec,
                                                     enc32)))
            x = nk
            del lp
        del x, nk, enc32, enc
    for name, per_call in _per_call(cfg, forward=True).items():
        check(launches[name] == per_call,
              f"{arch} forward: {name} launched {launches[name]} times, "
              f"expected {per_call}")
    for i, got in enumerate(step_launches):
        for name, per_call in _per_call(cfg).items():
            check(got[name] == per_call,
                  f"{arch} decode step {i}: {name} launched {got[name]} "
                  f"times, expected {per_call}")
    row = {"arch": arch, "B": B, "frames": T, "S": S,
           "encoder_s": secs["encoder"], "kernel_s": secs[True],
           "plain_s": secs[False], "launches": launches,
           "profile": breakdown, "logit_rel_diff_bf16": rel,
           "logit_tol": LOGIT_TOL, "argmax_agreement_bf16": agree,
           "decode_steps": steps,
           "decode_step_s": sum(step_secs[1:]) / (steps - 1),
           "decode_step_launches": step_launches[0],
           "decode_vs_forward_rel_max": max(step_rel),
           "decode_vs_forward_rel": step_rel,
           "decode_step_vs_plain": step_vs_plain,
           "decode_repeatable": repeatable,
           "enc_layer_rel_diff_max": max(enc_rel),
           "dec_layer_rel_diff_max": max(dec_rel), "layer_tol": LAYER_TOL,
           "enc_layer_rel_diff": enc_rel, "dec_layer_rel_diff": dec_rel}
    print("forward " + json.dumps({k: v for k, v in row.items()
                                   if k not in ("enc_layer_rel_diff",
                                                "dec_layer_rel_diff",
                                                "decode_vs_forward_rel")}))
    print(f"{arch}: float32 twins, each layer kernel vs plain from the same "
          f"input, encoder after layers 1, 6, 12, 18, last "
          f"{_picks(enc_rel)}, decoder {_picks(dec_rel)}; {steps} decode "
          f"steps vs forward, bf16, {_picks(step_rel)}")
    check(max(enc_rel + dec_rel) <= LAYER_TOL,
          f"{arch}: a layer's kernel-path output is off by "
          f"{max(enc_rel + dec_rel):.3g} (tol {LAYER_TOL}): {enc_rel} "
          f"{dec_rel}")
    check(rel <= LOGIT_TOL,
          f"{arch} forward: bf16 kernel-path logits off the plain path's by "
          f"{rel:.3g} (tol {LOGIT_TOL})")
    check(max(step_rel) <= LOGIT_TOL,
          f"{arch}: a decode step's bf16 logits are off the forward's by "
          f"{max(step_rel):.3g} (tol {LOGIT_TOL}): {step_rel}")
    check(step_vs_plain <= LOGIT_TOL,
          f"{arch}: decode step kernel path off the plain path by "
          f"{step_vs_plain:.3g}")
    check(repeatable, f"{arch}: two decode steps from the same cache gave "
                      "different bits")
    return row


def profile_forward(params, cfg, toks, fn=None, label: str = "forward"):
    """Device time of one kernel-path ``forward`` (or of ``fn()``) by
    ``torch.profiler``: the sum of kernel durations, each hand-written
    kernel's part, and the rest (cuBLAS projections, the LM head, norms,
    RoPE)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward
    fn = fn or (lambda: forward(params, cfg, toks))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = _device_time(prof, 1)
    if out is None:
        return None
    out["other_ms"] = out["device_ms"] - sum(
        out.get(f"{name}_ms", 0.0) for name in MODEL_KERNELS)
    print(f"profile {label} {cfg.name} " + json.dumps(out))
    return out


#: the archs whose forward ``forward_slice`` runs at (1, 512)
SLICE_ARCHS = ("phi3-medium-14b", "qwen1.5-32b", "granite-moe-1b-a400m",
               "moonshot-v1-16b-a3b")
#: the last two archs of the zoo: qwen2-vl-2b serves (text only) and runs
#: ``forward_vlm``; whisper-medium runs ``whisper_arch`` (no serving)
ZOO_ARCHS = ("qwen2-vl-2b", "whisper-medium")


def phase_models():
    """Serve and run forward for each arch at full width, one model on
    the card at a time (``_load_model`` checks that the card holds no
    other)."""
    import torch
    serves, forwards, inits = {}, {}, {}
    for arch in ("qwen2.5-3b", "rwkv6-1.6b", "recurrentgemma-2b",
                 "gemma3-4b") + SLICE_ARCHS + ZOO_ARCHS:
        cfg, params, _, inits[arch] = _load_model(arch)
        if cfg.arch_kind == "encdec":
            # no serving: the reference's ServeEngine has no enc-dec path
            forwards[arch] = whisper_arch(arch, params, cfg)
            del params
            torch.cuda.empty_cache()
            continue
        serves[arch] = serve_arch(arch, params, cfg)
        if cfg.arch_kind == "vlm":
            forwards[arch] = forward_vlm(arch, params, cfg)
        elif arch in SLICE_ARCHS:
            forwards[arch] = forward_slice(arch, params, cfg)
        elif cfg.arch_kind != "dense":
            forwards[arch] = forward_arch(arch, params, cfg)
            if cfg.arch_kind == "rwkv":
                forwards[arch]["long"] = forward_timed(arch, params, cfg)
        elif arch == "gemma3-4b":
            forwards[arch] = forward_long(arch, params, cfg)
        del params
        torch.cuda.empty_cache()
    return serves, forwards, inits


def phase_small_reference():
    """Smoke configs in float32 on the card, kernels on: decode logits
    (plain attention) against forward logits (the flash kernel) at every
    position.  The hybrid decodes 14 tokens through a 32-token cache
    whose local attention keeps a ring of 8 slots (its window), so the
    ring wraps at t = 8; gemma3-4b's local layers (window 8) mask the
    oldest keys from t = 8 on.  Decode and forward compute the same
    function only where no token is dropped at capacity: a decode step
    (S = 1, C = 8 >= K) never drops one, and the MoE configs run with
    ``capacity_factor = n_experts / top_k``, so that forward's C >= S
    and it drops none either."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_cache, \
        init_model
    out = {}
    for arch, n, max_len in (("qwen2.5-3b", 8, 8), ("rwkv6-1.6b", 14, 32),
                             ("recurrentgemma-2b", 14, 32),
                             ("gemma3-4b", 14, 32),
                             ("phi3-medium-14b", 8, 8),
                             ("qwen1.5-32b", 8, 8),
                             ("granite-moe-1b-a400m", 8, 8),
                             ("moonshot-v1-16b-a3b", 8, 8)):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32, use_kernels=True)
        if cfg.n_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        params = init_model(cfg, seed=1, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        toks = torch.randint(0, cfg.vocab, (2, n), generator=gen,
                             device="cuda")
        with torch.inference_mode():
            full, _ = forward(params, cfg, toks)
            cache = init_cache(cfg, 2, max_len, device="cuda")
            steps = []
            for i in range(n):
                lg, cache = decode_step(params, cfg, toks[:, i:i + 1],
                                        cache, i)
                steps.append(lg[:, 0])
        per_t = (torch.stack(steps, 1) - full).abs().amax(dim=(0, 2))
        err = float(per_t.max())
        scale = float(full.abs().max())
        print(f"small reference ({cfg.name}, float32, kernels on, {n} "
              f"tokens, max_len {max_len}): decode vs prefill max err "
              f"{err:.3g} (logit scale {scale:.3g}, tol {SMALL_TOL} abs + "
              f"rel)")
        check(err <= SMALL_TOL * (1 + scale),
              f"{arch}: decode disagrees with prefill, per position "
              f"{per_t.tolist()}")
        out[arch] = {"tokens": n, "max_len": max_len, "max_abs_err": err,
                     "tol": SMALL_TOL}
    out.update(_small_zoo())
    return out


def _small_zoo():
    """The last two smoke configs in float32 on the card, kernels on.
    whisper: ``whisper_decode_step`` (self-attention plain from the cache,
    cross-attention through the flash kernel at S = 1) against
    ``whisper_forward`` at every position.  qwen2-vl: its decode is
    text-only with plain RoPE at the cache index (the reference's), so
    what it computes is the dense forward of the same weights with no
    patches; it is held against that, not against the vlm ``forward``
    with patches (which ``forward_vlm`` holds against its plain path)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, encode_frames, forward,
                                    init_cache, init_model,
                                    whisper_decode_step, whisper_forward)
    out = {}
    n = 12
    for arch in ZOO_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32, use_kernels=True)
        params = init_model(cfg, seed=1, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        toks = torch.randint(0, cfg.vocab, (2, n), generator=gen,
                             device="cuda")
        cache = init_cache(cfg, 2, n, device="cuda")
        with torch.inference_mode():
            if cfg.arch_kind == "encdec":
                frames = torch.randn((2, cfg.enc_frames, cfg.d_model),
                                     generator=gen, device="cuda")
                full = whisper_forward(params, cfg, frames, toks)
                cache["enc"] = encode_frames(params, cfg, frames)
                step, against = whisper_decode_step, "whisper_forward"
            else:
                full, _ = forward(params, dataclasses.replace(
                    cfg, arch_kind="dense"), toks)
                step, against = decode_step, "the dense forward"
            steps = []
            for i in range(n):
                lg, cache = step(params, cfg, toks[:, i:i + 1], cache, i)
                steps.append(lg[:, 0])
        per_t = (torch.stack(steps, 1) - full).abs().amax(dim=(0, 2))
        err = float(per_t.max())
        scale = float(full.abs().max())
        print(f"small reference ({cfg.name}, float32, kernels on, {n} "
              f"tokens): decode vs {against} max err {err:.3g} (logit scale "
              f"{scale:.3g}, tol {SMALL_TOL} abs + rel)")
        check(err <= SMALL_TOL * (1 + scale),
              f"{arch}: decode disagrees with forward, per position "
              f"{per_t.tolist()}")
        out[arch] = {"tokens": n, "max_len": n, "max_abs_err": err,
                     "tol": SMALL_TOL}
    return out


def _tree_differs(got, want, path: str = "plan"):
    """First difference of two JSON-like trees: structure and non-floats
    exact, floats within ``PLAN_RTOL``; None when they agree."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return f"{path}: keys differ"
        for k in want:
            d = _tree_differs(got[k], want[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return f"{path}: lengths differ"
        for i, (g, w) in enumerate(zip(got, want)):
            d = _tree_differs(g, w, f"{path}[{i}]")
            if d:
                return d
        return None
    if isinstance(want, float):
        if abs(got - want) > PLAN_RTOL * max(abs(got), abs(want)):
            return f"{path}: {got} != {want}"
        return None
    return None if got == want else f"{path}: {got!r} != {want!r}"


@contextlib.contextmanager
def _pricing_calls():
    """Count the torch engine's pricing calls and the rows of them that
    reach the kernel (a depth-1 candidate is priced on the host and never
    does); the ``price_rows`` launch count is zeroed on entry."""
    from repro_torch.core import pipeline_model_torch as pmt
    from repro_torch.kernels import price_rows as kpr
    real = pmt.price_rows
    seen = {"calls": 0, "calls_with_device_rows": 0, "device_rows": 0}

    def counting(rows, device=None):
        n = sum(r.host_cost is None for r in rows)
        seen["calls"] += 1
        seen["calls_with_device_rows"] += n > 0
        seen["device_rows"] += n
        return real(rows, device=device)

    kpr.price_rows.launches = 0
    pmt.price_rows = counting
    try:
        yield seen
    finally:
        pmt.price_rows = real
        seen["launches"] = kpr.price_rows.launches


def _planner_invocations() -> int:
    from repro_torch.core import get_planner
    info = get_planner().cache_info()
    return info.hits + info.misses


def _scratch_dir():
    import tempfile
    base = ROOT / "chip_scratch"
    base.mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=base)


def phase_plan_lm():
    """Path B: the 29 LM-zoo graphs planned from cold caches by the torch
    engine on the card (the CUDA ``price_rows``) and by the numpy engine;
    every plan against ``tests/golden/lm_plans.json`` and the other
    engine's, every torch plan through ``verify_plan`` with no finding,
    then ``repro_torch.launch.lint --strict`` over a store of them."""
    import torch
    from repro_torch.configs.lm_graphs import lm_plan_requests
    from repro_torch.core import (PAPER_HW, PlanStore, Topology,
                                  get_planner, verify_plan)
    from repro_torch.launch import lint
    golden = json.loads(LM_GOLDEN.read_text())
    runs = {}
    for engine in ("torch", "numpy"):
        requests = lm_plan_requests(hw=PAPER_HW, topology=Topology.AMP,
                                    engine=engine,
                                    device="cuda" if engine == "torch"
                                    else None)
        check(len(requests) == 29 and sorted(r.graph.name for r in requests)
              == sorted(golden), "lm_plan_requests: not the 29 golden graphs")
        _cold_planner_caches()
        with _pricing_calls() as seen:
            t0 = time.perf_counter()
            plans = {r.graph.name: get_planner().plan(r) for r in requests}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[engine] = {"requests": requests, "plans": plans,
                        "wall_s": wall, **seen}
        print(f"plan_lm {engine}: 29 graphs in {wall:.3f} s, "
              f"{seen['calls']} pricing calls, "
              f"{seen['calls_with_device_rows']} with device rows "
              f"({seen['device_rows']} rows), {seen['launches']} price_rows "
              "launches")
    t, n = runs["torch"], runs["numpy"]
    check(t["launches"] > 0
          and t["launches"] == t["calls_with_device_rows"],
          f"plan_lm: price_rows launched {t['launches']} times for "
          f"{t['calls_with_device_rows']} calls with device rows")
    check(n["launches"] == 0, "plan_lm: the numpy engine launched a kernel")
    findings = 0
    for name in sorted(golden):
        snap = _snapshot_plan(t["plans"][name])
        for other, want in (("numpy engine",
                             _snapshot_plan(n["plans"][name])),
                            ("golden file", golden[name])):
            diff = _plans_differ(snap, want)
            check(diff is None, f"LM plan of {name}, torch engine on cuda "
                                f"vs {other}: {diff}")
        report = verify_plan(t["plans"][name], PAPER_HW, Topology.AMP)
        check(report.ok and not report.findings, report.summary())
        findings += len(report.findings)
    with _scratch_dir() as tmp:
        store = PlanStore(tmp)
        for req in t["requests"]:
            store.save(req, t["plans"][req.graph.name])
        check(len(store) == 29, f"LM store holds {len(store)} plans")
        t0 = time.perf_counter()
        rc = lint.main([tmp, "--strict", "--quiet"])
        lint_s = time.perf_counter() - t0
    check(rc == 0, f"lint --strict over the LM store exited {rc}")
    out = {"graphs": 29, "findings": findings, "lint_rc": rc,
           "lint_s": lint_s,
           **{f"{e}_{k}": runs[e][k] for e in runs
              for k in ("wall_s", "calls", "calls_with_device_rows",
                        "device_rows", "launches")}}
    print("plan_lm " + json.dumps(out))
    return out


#: the planned-serving and tenant paths' arch, and the tenants of the
#: multi-tenant path (``--tenants``)
PLANNED_ARCH = "qwen2.5-3b"
TENANTS = "qwen2.5-3b:2:1,rwkv6-1.6b:1"


def _free_card():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_planned():
    """Path A, one engine: ``repro_torch.launch.serve --use-kernels`` at
    full width without a plan, then twice with ``--plan-store`` from cold
    planner caches: the first run plans (``plan_source`` planner, the
    planner invoked), the second reads the store (``store``, no planner
    invocation, no pricing call, no launch); the three runs' tokens must
    be the same bits, and each run's engine replay its CUDA graph once a
    tick, ``fused_mlp`` captured once a layer (``_wrapper_launches``)."""
    from repro_torch.launch import serve as serve_cli
    argv = ["--arch", PLANNED_ARCH, "--use-kernels"]
    runs = {}
    with _scratch_dir() as tmp:
        for label, extra in (("unplanned", []),
                             ("cold", ["--plan-store", tmp]),
                             ("warm", ["--plan-store", tmp])):
            _cold_planner_caches()
            _zero_counts()
            with _pricing_calls() as seen:
                t0 = time.perf_counter()
                engine, done = serve_cli.main(argv + extra)
                secs = time.perf_counter() - t0
            launches = _counts()
            tokens = sum(len(r.output) for r in done)
            runs[label] = {
                "plan_source": engine.plan_source,
                "planner_invocations": _planner_invocations(),
                "seconds": secs, "ticks": engine.ticks, "tokens": tokens,
                "model_launches": launches, **seen,
                "outputs": {r.rid: r.output for r in done}}
            if engine.plan is not None:
                runs[label]["planned_cycles_per_token"] = \
                    engine.stats()["planned_cycles_per_token"]
            _check_engine_launches(f"serve_planned {label}", [engine],
                                   launches)
            check(len(done) == 6 and tokens == 72,
                  f"serve_planned {label}: {len(done)} requests, {tokens} "
                  "tokens")
            del engine, done
            _free_card()
    cold, warm = runs["cold"], runs["warm"]
    check(runs["unplanned"]["plan_source"] is None
          and runs["unplanned"]["calls"] == 0, "the unplanned run planned")
    check(cold["plan_source"] == "planner"
          and cold["planner_invocations"] == 1 and cold["calls"] > 0,
          f"serve_planned cold: {cold['plan_source']}, "
          f"{cold['planner_invocations']} planner invocations, "
          f"{cold['calls']} pricing calls")
    check(cold["launches"] == cold["calls_with_device_rows"],
          f"serve_planned cold: {cold['launches']} price_rows launches for "
          f"{cold['calls_with_device_rows']} calls with device rows")
    check(warm["plan_source"] == "store" and warm["planner_invocations"] == 0
          and warm["calls"] == 0 and warm["launches"] == 0,
          f"serve_planned warm: {warm['plan_source']}, "
          f"{warm['planner_invocations']} planner invocations, "
          f"{warm['calls']} pricing calls, {warm['launches']} launches")
    check(cold["planned_cycles_per_token"]
          == warm["planned_cycles_per_token"], "warm plan differs")
    for label in ("cold", "warm"):
        check(runs[label]["outputs"] == runs["unplanned"]["outputs"],
              f"serve_planned {label}: tokens differ from the unplanned run")
    out = {label: {k: v for k, v in r.items() if k != "outputs"}
           for label, r in runs.items()}
    print("serve_planned " + json.dumps(out))
    return out


def phase_tenants():
    """Path A, tenants: ``repro_torch.launch.serve --use-kernels --tenants
    qwen2.5-3b:2:1,rwkv6-1.6b:1 --plan-store`` at full width.  Its
    multi-tenant plan (torch engine on the card) must equal the numpy
    engine's (from cold caches) and reload warm from the store with no
    planner call; then the scheduler runs again in each of the three
    modes on fresh engines of the same weights, timed.  Every request's
    tokens, in the launcher's run and in every mode, must be the bits of
    the same request served alone on an engine of its tenant; in every run
    each engine must replay its own CUDA graph once a tick, with
    ``fused_mlp`` captured once a layer of the qwen2.5-3b engine and
    ``wkv6`` once a layer of the rwkv6-1.6b one (``_wrapper_launches``)."""
    import torch
    from repro_torch.core import (MultiTenantRequest, Planner, PlanStore,
                                  mtplan_to_dict, resolve_multi_tenant)
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime.serve_loop import (AdmissionScheduler, Lane,
                                                Request, ServeEngine)
    out = {"tenants": TENANTS}
    with _scratch_dir() as tmp:
        _cold_planner_caches()
        _zero_counts()
        with _pricing_calls() as seen:
            t0 = time.perf_counter()
            plan, sched = serve_cli.main(["--use-kernels", "--tenants",
                                          TENANTS, "--plan-store", tmp])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = _counts()
        check(plan.source == "planner", f"tenant plan from {plan.source}")
        out["plan"] = {"mode": plan.mode, "source": plan.source,
                       "planner_invocations": _planner_invocations(),
                       "speedup_vs_serialized": plan.speedup_vs_serialized,
                       "candidates": [c[0] for c in plan.candidates],
                       **seen}
        engines = {name: lane.engine for name, lane in sched.lanes.items()}
        cfgs = [e.cfg for e in engines.values()]
        tenants = serve_cli.parse_tenants(TENANTS)
        cuda = next(iter(engines.values())).device
        request = serve_cli.tenant_request(tenants, cfgs, cuda)
        on_numpy = MultiTenantRequest(tuple(
            dataclasses.replace(t, request=dataclasses.replace(
                t.request, engine="numpy")) for t in request.tenants))
        _cold_planner_caches()
        want = mtplan_to_dict(resolve_multi_tenant(on_numpy,
                                                   planner=Planner()))
        diff = _tree_differs(mtplan_to_dict(plan), want)
        check(diff is None, f"tenant plan, torch engine on cuda vs numpy "
                            f"engine: {diff}")
        _cold_planner_caches()
        with _pricing_calls() as warm_seen:
            warm = resolve_multi_tenant(request, store=PlanStore(tmp))
        check(warm.source == "store" and _planner_invocations() == 0
              and warm_seen["calls"] == 0 and warm_seen["launches"] == 0,
              f"tenant plan warm: {warm.source}, {warm_seen}")
        check(_tree_differs(mtplan_to_dict(warm), mtplan_to_dict(plan))
              is None, "tenant plan reloaded from the store differs")
        out["warm"] = {"source": warm.source, "planner_invocations": 0,
                       **warm_seen}

    def record(label, s, launches):
        """Check one scheduler run's launches and completions; return its
        tokens by request id and its record."""
        tokens = sum(len(r.output) for v in s.done.values() for r in v)
        engine_ticks = {n: l.engine.ticks for n, l in s.lanes.items()}
        _check_engine_launches(f"tenants {label}",
                               [l.engine for l in s.lanes.values()],
                               launches)
        check(s.stats()["completed"] == 6 * len(s.lanes) and not s.truncated,
              f"tenants {label}: {s.stats()}")
        return ({r.rid: r.output for v in s.done.values() for r in v},
                {"mode": s.mode, "scheduler_ticks": s.ticks,
                 "engine_ticks": engine_ticks, "tokens": tokens,
                 "fused_mlp_launches": launches["fused_mlp"],
                 "wkv6_launches": launches["wkv6"]})

    outputs, out["launcher"] = record("launcher", sched, launches)
    out["launcher"]["seconds_with_init_and_plan"] = secs
    requests = {name: sorted((r.rid, list(r.prompt), r.max_new_tokens)
                             for r in sched.done[name]) for name in engines}

    def fresh(engine):
        return ServeEngine(engine.params, engine.cfg, batch_slots=engine.B,
                           max_len=engine.max_len, device=engine.device)

    runs = {"launcher": outputs}
    out["modes"] = {}
    for mode in AdmissionScheduler.MODES:
        s = AdmissionScheduler([Lane(l.name, fresh(l.engine), l.share,
                                     l.priority)
                                for l in sched.lanes.values()], mode=mode)
        for name, reqs in requests.items():
            for rid, prompt, n in reqs:
                s.submit(name, Request(rid=rid, prompt=prompt,
                                       max_new_tokens=n))
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        s.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[mode], rec = record(mode, s, _counts())
        rec.update(seconds=dt, tokens_per_s=rec["tokens"] / dt,
                   plan_mode=mode == plan.mode)
        out["modes"][mode] = rec
        tag = " (the plan's mode)" if mode == plan.mode else ""
        print(f"tenants {mode}{tag}: {rec['tokens']} tokens in {dt:.3f} s "
              f"({rec['tokens_per_s']:.1f} tok/s), {s.ticks} scheduler "
              f"ticks, engine ticks {rec['engine_ticks']}, fused_mlp "
              f"{rec['fused_mlp_launches']}, wkv6 {rec['wkv6_launches']} "
              "launches")
        del s
    solo = {}
    for name, reqs in requests.items():
        for rid, prompt, n in reqs:
            e = fresh(engines[name])
            e.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
            solo[rid] = e.run()[0].output
    for label, got in runs.items():
        check(got == solo, f"tenants {label}: tokens differ from the same "
                           "requests served alone")
    out["solo_requests"] = len(solo)
    print("tenants " + json.dumps(out))
    del sched, engines
    _free_card()
    return out


#: the train phase: qwen2.5-3b at full width and depth through the port's
#: launcher at ``train_4k``'s sequence length (4 microbatches of 2 x 4096
#: from ``pick_microbatches``), then at full width and 2 layers the
#: checkpoint, fault and resume runs
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "6", "--batch", "8",
              "--seq", "4096", "--log-every", "1"]
TRAIN_CKPT_ARGV = ["--arch", TRAIN_ARCH, "--layers", "2", "--steps", "6",
                   "--ckpt-every", "3", "--batch", "8", "--seq", "1024",
                   "--log-every", "1"]
#: the first step's loss against ``loss_fn`` of the same batch under
#: ``no_grad`` (remat changes no arithmetic)
TRAIN_LOSS_RTOL = 1e-3
#: the ops whose kernels are matrix products (cuBLAS): the projections,
#: the MLP, the LM head and attention's two einsums
TRAIN_MATMUL_OPS = ("aten::mm", "aten::bmm", "aten::addmm",
                    "aten::baddbmm", "aten::matmul")


def _planner_kernels() -> dict:
    from repro_torch.kernels.maxplus_scan import maxplus_chunked
    from repro_torch.kernels.price_rows import price_rows
    return {"maxplus_chunked": maxplus_chunked, "price_rows": price_rows}


def _all_launches() -> dict:
    """Every kernel's launch count: the model kernels and the planner's."""
    return {**_counts(), **{name: fn.launches
                            for name, fn in _planner_kernels().items()}}


def _zero_all_counts() -> None:
    """Set every kernel's launch count, the planner's too, to 0."""
    _zero_counts()
    for fn in _planner_kernels().values():
        fn.launches = 0


def _train_profile(prof, top: int = 12) -> dict:
    """A profiled train step's device time: the total; the optimizer's
    (kernels launched inside ``adamw.apply_updates``), the matrix
    products' (``TRAIN_MATMUL_OPS`` elsewhere) and the rest; and the
    ``top`` launching ops.  The profiler's "Command Buffer Full" records
    (the host waiting on a full launch queue) are not device work."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    by_cat, by_op = {}, {}
    for e in prof.events():
        if e.device_type != cpu or not e.kernels:
            continue
        us = sum(k.duration for k in e.kernels
                 if k.name != "Command Buffer Full")
        if not us:
            continue
        by_op[e.name] = by_op.get(e.name, 0.0) + us
        p = e
        while p is not None and p.name != "adamw.apply_updates":
            p = p.cpu_parent
        cat = ("optimizer" if p is not None else
               "matmul" if e.name in TRAIN_MATMUL_OPS else "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    return {"device_ms": sum(by_cat.values()) / 1e3,
            "by_category_ms": {k: v / 1e3 for k, v in by_cat.items()},
            "top_ops_ms": {k: v / 1e3 for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]}}


def _train_parts(cfg, micro_batch: int, seq: int, microbatches: int
                 ) -> dict:
    """Device ms a step of the two plain pieces that bound the step,
    timed alone by CUDA events at the step's shapes: attention (``_sdpa``
    with its causal mask: per layer and microbatch a forward without
    grad, then the recomputed forward and its backward) and the loss
    (``_mask_pad_vocab`` and ``cross_entropy_loss`` of one microbatch's
    logits, forward and backward); each scaled to the step."""
    import torch

    from repro_torch.models.common import cross_entropy_loss
    from repro_torch.models.layers import _sdpa
    from repro_torch.models.transformer import _mask_pad_vocab
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, Hkv, hd = micro_batch, seq, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=cfg.dtype)

    q, k, v = rnd(B, S, H, hd), rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd)
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None])[None].expand(B, S, S)

    def attention():
        with torch.no_grad():
            _sdpa(q, k, v, mask, cfg)
        qg = q.detach().requires_grad_()
        out = _sdpa(qg, k.detach().requires_grad_(),
                    v.detach().requires_grad_(), mask, cfg)
        out.backward(torch.ones_like(out))

    logits = rnd(B, S, cfg.padded_vocab)
    labels = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                           generator=g)

    def loss():
        lg = logits.detach().requires_grad_()
        cross_entropy_loss(_mask_pad_vocab(lg, cfg), labels).backward()

    sync = torch.cuda.synchronize
    att = time_ms(attention, sync, target_ms=50.0)
    ce = time_ms(loss, sync, target_ms=50.0)
    del q, k, v, logits
    return {"attention_ms_per_layer_microbatch": att,
            "attention_ms_per_step": att * cfg.n_layers * microbatches,
            "loss_ms_per_microbatch": ce,
            "loss_ms_per_step": ce * microbatches}


def _trees_differ(got, want):
    """None if two trees hold the same keys, dtypes and bits, else the
    first difference."""
    import torch

    from repro_torch.tree import flatten_with_path
    g, w = dict(flatten_with_path(got)), dict(flatten_with_path(want))
    if g.keys() != w.keys():
        return f"keys {sorted(g.keys() ^ w.keys())[:4]}"
    for k in w:
        if g[k].dtype != w[k].dtype:
            return f"{'/'.join(k)}: dtype {g[k].dtype} vs {w[k].dtype}"
        if not torch.equal(g[k], w[k]):
            diff = (g[k].float() - w[k].float()).abs().max().item()
            return f"{'/'.join(k)}: max diff {diff:.3g}"
    return None


def train_full():
    """qwen2.5-3b at 36 x 2048 x 11008 through ``repro_torch.launch.train
    --steps 6 --batch 8 --seq 4096``: per step the wall time, tokens/s,
    loss, gradient norm and MFU (6 N T over the step's seconds at the bf16
    peak); resident and peak memory; the first step's loss against the
    plain ``loss_fn`` of the same batch; every loss and norm finite, the
    loss falling, no parameter NaN; no hand-written kernel launched; then
    one more step under the profiler, and attention and the loss timed
    alone at the step's shapes (``_train_parts``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import TokenDataset, to_device
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_model, loss_fn
    from repro_torch.runtime.steps import make_train_step
    cuda = torch.device("cuda")
    cfg, opt, loop, data = train_cli.setup(
        train_cli.parser().parse_args(TRAIN_ARGV))
    M = loop.microbatches
    ds = TokenDataset(data)
    _free_card()
    # the plain forward's loss of the first batch, on the weights the
    # launcher draws (init_model from the loop's seed)
    params = init_model(cfg, seed=loop.seed, device=cuda)
    n_params = sum(t.numel() for t in _leaves(params))
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    batch = to_device(ds.global_batch_at(0), cuda)
    with torch.no_grad():
        plain = sum(float(loss_fn(params, cfg, {k: v[i::M] for k, v in
                                                batch.items()}))
                    for i in range(M)) / M
    del params, batch
    _free_card()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _all_launches()
    t0 = time.perf_counter()
    res = train_cli.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _all_launches().items()}
    peak = torch.cuda.max_memory_allocated() - held
    resident = torch.cuda.memory_allocated() - held
    tokens = data.global_batch * data.seq_len
    steps = [{"step": h["step"], "wall_s": h["wall_s"],
              "tokens_per_s": tokens / h["wall_s"], "loss": h["loss"],
              "grad_norm": h["grad_norm"],
              "mfu": 6 * n_params * tokens
              / (h["wall_s"] * PEAK_OPS_PER_S["bfloat16"])}
             for h in res["history"]]
    for s in steps:
        print(f"train full step {int(s['step'])}: {s['wall_s']:.3f} s, "
              f"{s['tokens_per_s']:.0f} tokens/s, loss {s['loss']:.4f}, "
              f"grad_norm {s['grad_norm']:.4f}, MFU {s['mfu']:.4f}")
    check(len(steps) == 6, f"train full: {len(steps)} logged steps")
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              for s in steps), "train full: a loss or norm is not finite")
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"train full: loss {steps[0]['loss']:.4f} -> "
          f"{steps[-1]['loss']:.4f} did not fall")
    check(all(bool(torch.isfinite(p).all()) for p in
              _leaves(res["params"])), "train full: a parameter is NaN")
    rel = abs(steps[0]["loss"] - plain) / abs(plain)
    check(rel <= TRAIN_LOSS_RTOL,
          f"train full: step 1 loss {steps[0]['loss']:.6f} vs plain "
          f"loss_fn {plain:.6f} (rel {rel:.3g})")
    check(not any(launches.values()),
          f"train full: hand-written kernels launched {launches}")
    # one more step under the profiler (batch 6, from the run's state)
    step_fn = make_train_step(cfg, opt, M)
    b6 = to_device(ds.global_batch_at(6), cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step_fn(res["params"], res["opt_state"], b6)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    breakdown = _train_profile(prof)
    del prof
    parts = _train_parts(cfg, data.global_batch // M, data.seq_len, M)
    steady = sorted(s["wall_s"] for s in steps[1:])[len(steps[1:]) // 2]
    out = {"arch": TRAIN_ARCH, "argv": TRAIN_ARGV,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "n_params": n_params,
           "microbatches": M, "tokens_per_step": tokens,
           "weights_gb": weights / 1e9, "steps": steps,
           "median_step_s_2_to_6": steady,
           "tokens_per_s_steady": tokens / steady,
           "mfu_steady": 6 * n_params * tokens
           / (steady * PEAK_OPS_PER_S["bfloat16"]),
           "launcher_wall_s": wall, "loop_seconds": res["seconds"],
           "plain_loss_step1": plain, "loss_rel_vs_plain": rel,
           "resident_gb": resident / 1e9, "peak_gb": peak / 1e9,
           "kernel_launches": launches,
           "profiled_step_wall_s": prof_wall, "profile": breakdown,
           "parts": parts}
    print("train full " + json.dumps({k: v for k, v in out.items()
                                      if k != "steps"}))
    del res, step_fn, b6
    _free_card()
    return out


def train_resume():
    """qwen2.5-3b at full width and 2 layers, ``--steps 6 --ckpt-every 3
    --batch 8 --seq 1024``, three ways: (a) straight through the
    launcher; (b) with ``FaultInjector(fail_at=4)``; (c) 3 steps, then a
    fresh process of the launcher resuming to 6.  (b) recovers once, and
    (b) and (c) end with (a)'s parameters and optimizer state, bit for
    bit; (a)'s last checkpoint restores through ``restore`` into the leaf
    dtypes.  Records each save's host copy and write seconds."""
    import os
    import shutil

    from repro_torch.checkpoint.store import restore
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime.train_loop import FaultInjector, train
    out = {"argv": TRAIN_CKPT_ARGV}

    def setup(ckpt_dir):
        return train_cli.setup(train_cli.parser().parse_args(
            TRAIN_CKPT_ARGV + ["--ckpt-dir", ckpt_dir]))

    _free_card()
    with _scratch_dir() as tmp:
        out["disk_free_gb"] = shutil.disk_usage(tmp).free / 1e9
        dirs = {k: os.path.join(tmp, k) for k in "abc"}
        t0 = time.perf_counter()
        a = train_cli.main(TRAIN_CKPT_ARGV + ["--ckpt-dir", dirs["a"]])
        out["a"] = {"seconds": time.perf_counter() - t0,
                    "saves": a["saves"],
                    "losses": [h["loss"] for h in a["history"]]}
        final = {"params": a["params"], "opt": a["opt_state"]}
        n_params = sum(t.numel() for t in _leaves(a["params"]))
        out["n_params"] = n_params
        t0 = time.perf_counter()
        diff = _trees_differ(restore(dirs["a"], 6, final), final)
        out["restore_s"] = time.perf_counter() - t0
        check(diff is None, f"train resume: (a)'s checkpoint restores "
                            f"differently: {diff}")
        shutil.rmtree(dirs["a"])
        cfg, opt, loop, data = setup(dirs["b"])
        t0 = time.perf_counter()
        b = train(cfg, opt, loop, data, fault=FaultInjector(fail_at=4),
                  device="cuda")
        out["b"] = {"seconds": time.perf_counter() - t0,
                    "failures": b["failures"], "steps_run": b["steps_run"],
                    "saves": b["saves"]}
        check(b["failures"] == 1, f"train resume (b): {b['failures']} "
                                  "failures")
        diff = _trees_differ({"params": b["params"],
                              "opt": b["opt_state"]}, final)
        check(diff is None, f"train resume (b) differs from (a): {diff}")
        del b
        shutil.rmtree(dirs["b"])
        cfg, opt, loop, data = setup(dirs["c"])
        c = train(cfg, opt, dataclasses.replace(loop, steps=3), data,
                  device="cuda")
        out["c"] = {"saves": c["saves"]}
        del c
        _free_card()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *TRAIN_CKPT_ARGV, "--ckpt-dir", dirs["c"]],
            env=env, capture_output=True, text=True, timeout=600)
        out["c"]["resume_process_s"] = time.perf_counter() - t0
        out["c"]["resume_stdout"] = proc.stdout.splitlines()[-8:]
        check(proc.returncode == 0 and "resumed from step 3" in proc.stdout,
              f"train resume (c): rc {proc.returncode}: "
              f"{proc.stdout[-800:]} {proc.stderr[-1500:]}")
        diff = _trees_differ(restore(dirs["c"], 6, final), final)
        check(diff is None, f"train resume (c) differs from (a): {diff}")
    out["save_gb"] = 12 * n_params / 1e9      # float32 params, mu, nu
    print("train resume " + json.dumps(out))
    del a, final
    _free_card()
    return out


def phase_train():
    """Training: ``train_full``, then ``train_resume``."""
    return {"full": train_full(), "resume": train_resume()}


#: the mesh phases' runs: the train phase's, on a (1, 1) mesh of one
#: NCCL rank, for 3 steps (their learning rates are the 6-step run's:
#: warmup over 2 steps, the cosine at its start on step 2)
MESH_TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "3", "--batch", "8",
                   "--seq", "4096", "--log-every", "1"]
#: mesh_prefill's prompt, and the pipeline check's microbatches (1 x S)
MESH_PREFILL_S = 4096
PIPELINE_S = 1024
#: the dry-run cells run on the host (a fake group of 256 or 512 ranks)
DRYRUN_CELLS = [("qwen2.5-3b", "train_4k", False),
                ("moonshot-v1-16b-a3b", "decode_32k", True)]
_DRYRUN = """
import json, sys
from repro_torch.launch.dryrun import run_cell
cells = json.loads(sys.argv[1])
print(json.dumps([run_cell(a, s, mp, verbose=False) for a, s, mp in cells]))
"""


def dryrun_start():
    """The dry-run of ``DRYRUN_CELLS`` in a process of its own (a fake
    process group is global to its process), started at once so that its
    host time overlaps the card's phases; ``dryrun_finish`` reads it."""
    import os
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))
    return subprocess.Popen(
        [sys.executable, "-c", _DRYRUN, json.dumps(DRYRUN_CELLS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), \
        time.perf_counter()


def dryrun_finish(started):
    """The dry-run's records: per-device GB against the card's memory,
    FLOPs, collectives and seconds; every cell must fit."""
    proc, t0 = started
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"dryrun: rc {proc.returncode}: "
                                f"{err[-2000:]}")
    rows = json.loads(out.strip().splitlines()[-1])
    res = {"wall_s": time.perf_counter() - t0, "cells": []}
    for r in rows:
        cell = {"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                "peak_gb": r["memory"]["peak_size_in_bytes"] / 1e9,
                "argument_gb": r["memory"]["argument_size_in_bytes"] / 1e9,
                "device_gb": r["device_memory_bytes"] / 1e9,
                "fits": r["fits"], "flops": r["flops"],
                "collective_bytes": r["collectives"]["total_bytes"],
                "collective_counts": r["collectives"]["count"],
                "seconds": r["seconds"]}
        res["cells"].append(cell)
        print("dryrun " + json.dumps(cell))
        check(r["fits"], f"dryrun {r['arch']} x {r['shape']} x {r['mesh']}: "
                         f"{cell['peak_gb']:.2f} GB a device does not fit")
    return res


def mesh_group():
    """This process as one NCCL rank (``launch.mesh.process_group``); the
    mesh phases run on its (1, 1) host mesh."""
    import logging

    from repro_torch.launch.mesh import process_group
    # DTensor warns at every redistribution over two mesh dims (even of
    # size 1); the output's tail must keep the phases' lines
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    process_group("cuda")


def _plain(tree):
    """A tree of DTensors as full plain tensors."""
    from repro_torch.distributed.hints import to_plain
    from repro_torch.tree import tree_map
    return tree_map(to_plain, tree)


def mesh_train(plain_steps):
    """qwen2.5-3b at 36 x 2048 x 11008 through ``repro_torch.launch.train``
    in a world of one rank, on a NCCL group's (1, 1) mesh, 3 steps of 8 x 4096
    from the train phase's seed and data: each step's loss and gradient
    norm against that phase's (bit-equal, or the difference recorded),
    s/step and peak memory, no hand-written kernel launched, and the
    collectives one more step issues (``CommDebugMode``)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.pipeline import TokenDataset, shard_batch
    from repro_torch.distributed.hints import use_mesh
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.steps import make_train_step
    _free_card()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _all_launches()
    t0 = time.perf_counter()
    res = train_cli.main(MESH_TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _all_launches().items()}
    peak = torch.cuda.max_memory_allocated() - held
    steps = [{"step": h["step"], "wall_s": h["wall_s"], "loss": h["loss"],
              "grad_norm": h["grad_norm"]} for h in res["history"]]
    diffs = []
    for got, want in zip(steps, plain_steps[:3]):
        diffs.append({k: got[k] - want[k] for k in ("loss", "grad_norm")})
        print(f"mesh train step {int(got['step'])}: {got['wall_s']:.3f} s, "
              f"loss {got['loss']:.6f} (plain {want['loss']:.6f}), "
              f"grad_norm {got['grad_norm']:.6f} "
              f"(plain {want['grad_norm']:.6f})")
        for k in ("loss", "grad_norm"):
            check(abs(got[k] - want[k]) <= TRAIN_LOSS_RTOL * abs(want[k]),
                  f"mesh train: step {got['step']} {k} {got[k]} vs the "
                  f"plain run's {want[k]}")
    check(len(steps) == 3, f"mesh train: {len(steps)} logged steps")
    check(not any(launches.values()),
          f"mesh train: hand-written kernels launched {launches}")
    cfg, opt, loop, data = train_cli.setup(
        train_cli.parser().parse_args(MESH_TRAIN_ARGV))
    mesh = make_host_mesh()
    step_fn = make_train_step(cfg, opt, loop.microbatches)
    batch = shard_batch(TokenDataset(data), 3, mesh)
    comm = CommDebugMode()
    with use_mesh(mesh), comm:
        step_fn(res["params"], res["opt_state"], batch)
    torch.cuda.synchronize()
    steady = sorted(s["wall_s"] for s in steps[1:])
    out = {"argv": MESH_TRAIN_ARGV, "mesh": [1, 1], "steps": steps,
           "diff_vs_plain": diffs,
           "bit_equal": all(d["loss"] == 0 and d["grad_norm"] == 0
                            for d in diffs),
           "median_step_s_2_to_3": steady[len(steady) // 2],
           "launcher_wall_s": wall, "peak_gb": peak / 1e9,
           "kernel_launches": launches,
           "step_collectives": {str(k).split(".")[-1]: int(v) for k, v in
                                comm.get_comm_counts().items()}}
    print("mesh train " + json.dumps({k: v for k, v in out.items()
                                      if k != "steps"}))
    del res, step_fn, batch
    _free_card()
    return out


def mesh_resume():
    """At full width and 2 layers on the (1, 1) mesh, ``--steps 6
    --ckpt-every 3``: (a) straight through the launcher; (b) a fault at
    step 4, the mesh re-formed by ``mesh_fn`` and the step-3 checkpoint
    restored onto it; (c) 3 steps, then a fresh process resuming to 6;
    (b) and (c) end with (a)'s parameters and moments, bit for bit."""
    import os
    import shutil

    from repro_torch.checkpoint.store import restore
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.train_loop import FaultInjector, train
    out = {"argv": TRAIN_CKPT_ARGV}

    def setup(ckpt_dir):
        return train_cli.setup(train_cli.parser().parse_args(
            TRAIN_CKPT_ARGV + ["--ckpt-dir", ckpt_dir]))

    _free_card()
    with _scratch_dir() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in "abc"}
        t0 = time.perf_counter()
        a = train_cli.main(TRAIN_CKPT_ARGV + ["--ckpt-dir", dirs["a"]])
        out["a"] = {"seconds": time.perf_counter() - t0,
                    "losses": [h["loss"] for h in a["history"]]}
        final = _plain({"params": a["params"], "opt": a["opt_state"]})
        diff = _trees_differ(_plain(restore(
            dirs["a"], 6, {"params": a["params"], "opt": a["opt_state"]})),
            final)
        check(diff is None, f"mesh resume: (a)'s checkpoint restores "
                            f"differently: {diff}")
        del a
        shutil.rmtree(dirs["a"])
        cfg, opt, loop, data = setup(dirs["b"])
        meshes = []
        t0 = time.perf_counter()
        b = train(cfg, opt, loop, data, fault=FaultInjector(fail_at=4),
                  mesh_fn=lambda: meshes.append(1) or make_host_mesh())
        out["b"] = {"seconds": time.perf_counter() - t0,
                    "failures": b["failures"], "meshes_formed": len(meshes)}
        check(b["failures"] == 1 and len(meshes) == 2,
              f"mesh resume (b): {b['failures']} failures, "
              f"{len(meshes)} meshes")
        diff = _trees_differ(_plain({"params": b["params"],
                                     "opt": b["opt_state"]}), final)
        check(diff is None, f"mesh resume (b) differs from (a): {diff}")
        del b
        cfg, opt, loop, data = setup(dirs["c"])
        c = train(cfg, opt, dataclasses.replace(loop, steps=3), data,
                  mesh_fn=make_host_mesh)
        del c
        _free_card()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *TRAIN_CKPT_ARGV, "--ckpt-dir", dirs["c"]],
            env=env, capture_output=True, text=True, timeout=600)
        out["c"] = {"resume_process_s": time.perf_counter() - t0,
                    "resume_stdout": proc.stdout.splitlines()[-4:]}
        check(proc.returncode == 0 and "resumed from step 3" in proc.stdout,
              f"mesh resume (c): rc {proc.returncode}: "
              f"{proc.stdout[-800:]} {proc.stderr[-1500:]}")
        diff = _trees_differ(_plain(restore(dirs["c"], 6, final)), final)
        check(diff is None, f"mesh resume (c) differs from (a): {diff}")
    print("mesh resume " + json.dumps(out))
    del final
    _free_card()
    return out


def mesh_prefill(usage: dict):
    """``make_prefill_step`` of qwen2.5-3b with the kernels at full width
    on a (1, 4096) prompt, DTensor parameters on the (1, 1) mesh: the
    logits against the mesh-less kernel path's, the launches of this run
    alone (``fused_mlp`` and ``flash_attention`` once a layer, 36 each),
    each kernel against its plain version at these shapes; then
    ``pipeline_spmd_fn`` at one stage with one full-width decoder layer
    (the kernels on) as ``stage_fn`` over 4 microbatches, against the
    layer applied to each."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config
    from repro_torch.distributed.hints import to_plain, use_mesh
    from repro_torch.distributed.pipeline import StageOrg, pipeline_spmd_fn
    from repro_torch.distributed.sharding import init_sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_model
    from repro_torch.models.transformer import _layer, _uniform_layer
    from repro_torch.runtime.steps import make_prefill_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), use_kernels=True)
    mesh = make_host_mesh()
    cuda = torch.device("cuda")
    _free_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (1, MESH_PREFILL_S), generator=gen,
                         device=cuda)
    step = make_prefill_step(cfg)
    params = init_sharded(cfg, mesh, seed=0, device=cuda)
    dtoks = DTensor.from_local(toks, mesh, [Replicate(), Replicate()],
                               run_check=False)
    with use_mesh(mesh):
        step(params, {"tokens": dtoks})              # warm
    torch.cuda.synchronize()
    _zero_all_counts()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        logits = step(params, {"tokens": dtoks})
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches = _all_launches()
    logits = to_plain(logits)
    del params
    _free_card()
    plain_params = init_model(cfg, seed=0, device=cuda)
    step(plain_params, {"tokens": toks})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = step(plain_params, {"tokens": toks})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    L = cfg.n_layers
    check(launches["fused_mlp"] == L and launches["flash_attention"] == L
          and not launches["wkv6"] and not launches["rglru_chunked"]
          and not launches["maxplus_chunked"] and not launches["price_rows"]
          and not launches["decode_attention"],
          f"mesh prefill: launches {launches}, want {L} fused_mlp and {L} "
          "flash_attention")
    rel, agree = _rel_logit_diff(logits, want, cfg)
    out = {"S": MESH_PREFILL_S, "mesh": [1, 1], "launches": launches,
           "bit_equal": bool(torch.equal(logits, want)),
           "max_rel_logit_diff": rel, "argmax_agree": agree,
           "mesh_s": mesh_s, "meshless_s": plain_s}
    check(rel <= LOGIT_TOL, f"mesh prefill: logits differ from the "
                            f"mesh-less kernel path by {rel:.3g}")
    del logits, want
    out["fused_mlp_row"] = check_fused_mlp(
        "mesh-prefill", MESH_PREFILL_S, cfg.d_model, cfg.d_ff, "bfloat16")
    out["flash_row"] = check_flash(
        "mesh-prefill", 1, MESH_PREFILL_S, MESH_PREFILL_S, cfg.n_heads,
        cfg.n_kv_heads, cfg.hd, True, 0, "bfloat16", usage)
    # the stage pipeline at one stage: layer 0 as stage_fn, 4 microbatches
    layer = _layer(plain_params["layers"], 0)
    stacked = {k: v for k, v in _stack1(layer).items()}
    positions = torch.arange(PIPELINE_S, device=cuda)

    def stage_fn(p, x):
        return _uniform_layer(cfg, x, p, None, positions)[0]

    xs = (torch.randn((4, 1, PIPELINE_S, cfg.d_model), generator=gen,
                      device=cuda) * 0.5).to(cfg.dtype)
    run = pipeline_spmd_fn(stage_fn, StageOrg.STRIPED, 1, mesh, 4)
    with torch.no_grad():
        _zero_all_counts()
        ys = run(stacked, xs)
        pipe_launches = _all_launches()
        each = torch.stack([stage_fn(layer, xs[k]) for k in range(4)])
    check(torch.equal(ys, each),
          "mesh prefill: pipeline_spmd_fn differs from the layer applied "
          "to each microbatch")
    check(pipe_launches["fused_mlp"] == 4
          and pipe_launches["flash_attention"] == 4,
          f"mesh prefill: pipeline launches {pipe_launches}")
    out["pipeline"] = {"stages": 1, "microbatches": 4, "S": PIPELINE_S,
                       "launches": pipe_launches, "bit_equal": True}
    print("mesh prefill " + json.dumps(
        {k: v for k, v in out.items() if not k.endswith("_row")}))
    del plain_params, layer, stacked, xs, ys, each
    _free_card()
    return out


def _stack1(tree):
    """A tree of tensors with a leading stage axis of 1."""
    if isinstance(tree, dict):
        return {k: _stack1(v) for k, v in tree.items()}
    return tree[None]


def phase_mesh(plain_steps, usage):
    """The distributed layer on the card: ``mesh_train``, ``mesh_resume``
    and ``mesh_prefill`` on one NCCL rank."""
    import os

    import torch.distributed as dist
    mesh_group()
    # a world of one rank: the launcher, and the resuming process it
    # starts, train on the mesh
    os.environ["WORLD_SIZE"] = "1"
    try:
        out = {"train": mesh_train(plain_steps), "resume": mesh_resume(),
               "prefill": mesh_prefill(usage)}
    finally:
        del os.environ["WORLD_SIZE"]
    dist.destroy_process_group()
    return out


def _expandable_segments() -> None:
    """Let the CUDA caching allocator grow its segments in place, as
    ``repro_torch.launch.train`` does for a process of its own: set
    before the first CUDA use, since the train phase runs in this
    process after every other one."""
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> dict:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    _expandable_segments()
    import torch

    t_start = time.perf_counter()
    smi = phase_device()
    dryrun = dryrun_start()
    try:
        record = _run_phases(smi, dryrun, t_start)
    finally:
        if dryrun[0].poll() is None:
            dryrun[0].kill()
            dryrun[0].wait()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return record


def _run_phases(smi, dryrun, t_start):
    """Every phase after ``phase_device``; prints the kernel table and
    writes the record, with each phase's seconds on the host clock."""
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    usage = timed("build", phase_build)
    rows, mp_rows, mp_exact, floor_ms = timed("kernels", phase_kernels)
    wkv_rows, rg_rows = timed("recurrence_kernels",
                              phase_recurrence_kernels, floor_ms)
    flash_rows = timed("flash", phase_flash, usage)
    decode_rows = timed("decode_attention", phase_decode_attention, usage)
    serves, forwards, inits = timed("models", phase_models)
    serve = serves["qwen2.5-3b"]
    plan, plans, calls = timed("planner", phase_planner)
    pr_rows, pr_calls = timed("price_rows", phase_price_rows, calls,
                              floor_ms)
    sim = timed("simulate", phase_simulate, plans)
    small = timed("small_reference", phase_small_reference)
    plan_lm = timed("plan_lm", phase_plan_lm)
    planned = timed("serve_planned", phase_serve_planned)
    tenants = timed("tenants", phase_tenants)
    train = timed("train", phase_train)
    mesh = timed("mesh", phase_mesh, train["full"]["steps"], usage)
    dry = timed("dryrun_wait", dryrun_finish, dryrun)

    main_row = next(r for r in rows
                    if r["shape"] == "decode" and r["dtype"] == "bfloat16")
    prefill_row = next(r for r in rows if r["shape"] == "prefill-gemma"
                       and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "fused_mlp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:48",
        "launches": serve["launches"]["fused_mlp"],
        "replayed_launches": serve["replayed_launches"]["fused_mlp"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "prefill_shape": [prefill_row["T"], prefill_row["D"],
                          prefill_row["F"]],
        "prefill_ms": prefill_row["ms"],
        "prefill_device_ms": prefill_row["device_ms"],
        "prefill_library_ms": prefill_row["library_ms"],
        "prefill_bound_ms": prefill_row["bound_ms"],
        "prefill_bound_by": prefill_row["bound_by"]}]
    # fused_mlp at D = 5120 (phi3-medium-14b, qwen1.5-32b): each shape's
    # bf16 row, and the launches of those archs' serve runs and forwards
    kernels[0]["d5120"] = {
        r["shape"]: {k: r[k] for k in (
            "T", "D", "F", "regime", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows if r.get("D") == 5120 and r["dtype"] == "bfloat16"}
    # fused_mlp past D = 5120 (16-CTA clusters of the wgmma regime): no
    # arch of the zoo is that wide, so these rows have no model launches
    kernels[0]["d_over_5120"] = {
        r["shape"]: {k: r[k] for k in (
            "T", "D", "F", "regime", "ctas", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows if r.get("D", 0) > 5120 and r["dtype"] == "bfloat16"}
    kernels[0]["d5120_launches"] = {
        arch: {"serve": serves[arch]["launches"]["fused_mlp"],
               "forward": forwards[arch]["launches"]["fused_mlp"]}
        for arch in SLICE_ARCHS[:2]}
    # fused_mlp at qwen2-vl-2b's width (D = 1536, F = 8960): its decode and
    # prefill rows, and the launches of its serve run and forward
    kernels[0]["vlm"] = {
        r["shape"]: {k: r[k] for k in (
            "T", "D", "F", "regime", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows if r["shape"] in ("decode-vlm", "prefill-vlm")
        and r["dtype"] == "bfloat16"}
    kernels[0]["vlm_launches"] = {
        "serve": serves["qwen2-vl-2b"]["launches"]["fused_mlp"],
        "forward": forwards["qwen2-vl-2b"]["launches"]["fused_mlp"]}
    # planned serving: the cold --plan-store run, and the tenant scheduler
    # in each mode
    kernels[0]["planned_serve_launches"] = (
        planned["cold"]["model_launches"]["fused_mlp"])
    kernels[0]["tenant_launches"] = {
        mode: r["fused_mlp_launches"] for mode, r in tenants["modes"].items()}
    # the planner's kernels: no single PyTorch call computes either
    # function (a max-plus scan; the Fig. 3 recurrence), so library_ms is
    # null; their main rows are the simulator's one-row T = 512 scan and
    # the planning run's largest call
    mp = next(r for r in mp_rows if r["shape"] == "path")
    pr = next(r for r in pr_rows if r["shape"] == "largest call")
    for name, src, ref, launches, r in (
            ("maxplus_chunked", "maxplus_scan.cu",
             "src/repro/kernels/maxplus_scan.py:129", sim["launches"], mp),
            ("price_rows", "price_rows.cu",
             "src/repro/core/pipeline_model_jax.py:278", plan["launches"],
             pr)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": ref, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    # price_rows: the call holding the widest rows, the plan run's device
    # time by the profiler, and the planner's round trip a call
    wide = next(r for r in pr_rows
                if r["shape"] == f"call with E={plan['edges_max']}")
    kernels[-1].update({
        "regime": pr["regime"],
        "calls": plan["calls"], "groups": plan["groups"],
        "plan_device_ms": plan["plan_device_ms"],
        "widest_E": plan["edges_max"], "widest_B": wide["B"],
        "widest_device_ms": wide["device_ms"], "widest_ms": wide["ms"],
        "widest_bound_ms": wide["bound_ms"],
        # the LM-zoo plan pass (29 graphs, cold caches) on the card
        "lm_plan_launches": plan_lm["torch_launches"],
        "lm_plan_calls_with_device_rows": plan_lm[
            "torch_calls_with_device_rows"],
        "lm_plan_wall_s": plan_lm["torch_wall_s"]})
    # the recurrences: no single PyTorch call computes either (a matrix-
    # state linear recurrence; a diagonal one), so library_ms is null;
    # their main rows are the serve paths' decode shapes, their launches
    # those of the serve runs
    for name, src, ref, arch, rs in (
            ("wkv6", "rwkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:80",
             "rwkv6-1.6b", wkv_rows),
            ("rglru_chunked", "rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:55", "recurrentgemma-2b",
             rg_rows)):
        r = next(r for r in rs if r["shape"] == "decode")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": ref, "launches": serves[arch]["launches"][name],
            "replayed_launches": serves[arch]["replayed_launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    # wkv6's prefill: the chunked regime at rwkv6-1.6b's (2, 512) forward
    # (its launches from that forward) and at one 4096-token prompt, each
    # beside the step kernel's device time on the same inputs
    wk = next(kk for kk in kernels if kk["name"] == "wkv6")
    for label, key in (("prefill", "prefill"), ("prefill-long", "long")):
        r = next(r for r in wkv_rows if r["shape"] == label)
        wk.update({
            f"{key}_shape": [r["BH"], r["T"], r["N"]],
            f"{key}_regime": r["regime"], f"{key}_ms": r["ms"],
            f"{key}_device_ms": r["device_ms"],
            f"{key}_step_device_ms": r["step_device_ms"],
            f"{key}_plain_ms": r["plain_ms"],
            f"{key}_bound_ms": r["bound_ms"],
            f"{key}_max_abs_err": r["max_abs_err"]})
    wk["prefill_launches"] = (
        forwards["rwkv6-1.6b"]["launches"]["wkv6"])
    wk["tenant_launches"] = {
        mode: r["wkv6_launches"] for mode, r in tenants["modes"].items()}
    # rglru_chunked's prefill: the split regime at recurrentgemma-2b's
    # (2, 512) forward (its launches from that forward), beside the step
    # kernel's device time on the same inputs
    rg = next(kk for kk in kernels if kk["name"] == "rglru_chunked")
    r = next(r for r in rg_rows if r["shape"] == "prefill")
    rg.update({
        "prefill_shape": [r["B"], r["T"], r["W"]],
        "prefill_regime": r["regime"], "prefill_ms": r["ms"],
        "prefill_device_ms": r["device_ms"],
        "prefill_step_device_ms": r["step_device_ms"],
        "prefill_plain_ms": r["plain_ms"],
        "prefill_bound_ms": r["bound_ms"],
        "prefill_max_abs_err": r["max_abs_err"],
        "prefill_launches": (
            forwards["recurrentgemma-2b"]["launches"]["rglru_chunked"])})
    # flash attention: the main row is gemma3-4b's local layer (28 of its
    # 34) at the forward's (1, 8192), bf16, its global layer (6 of 34)
    # beside it; launches from that forward
    fl, gl = (next(r for r in flash_rows
                   if r["shape"] == shape and r["dtype"] == "bfloat16")
              for shape in ("local-8192", "global-8192"))
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:69",
        "launches": forwards["gemma3-4b"]["launches"]["flash_attention"],
        "max_abs_err": fl["max_abs_err"], "ms": fl["ms"],
        "device_ms": fl["device_ms"],
        "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
        "bound_by": fl["bound_by"], "library_ms": fl["library_ms"],
        "global_ms": gl["ms"], "global_device_ms": gl["device_ms"],
        "global_plain_ms": gl["plain_ms"], "global_bound_ms": gl["bound_ms"],
        "global_library_ms": gl["library_ms"], "regime": fl["regime"],
        # the (1, 512) forwards of the slice's archs: each shape's bf16
        # row and that forward's launches
        "slice_rows": {r["shape"]: {k: r[k] for k in (
            "H", "Hkv", "hd", "regime", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for r in flash_rows if r["shape"].endswith("-1x512")
            and r["dtype"] == "bfloat16"},
        "slice_launches": {arch: forwards[arch]["launches"]["flash_attention"]
                           for arch in SLICE_ARCHS},
        # qwen2-vl-2b's and whisper-medium's shapes: each bf16 row, and the
        # launches of the vlm forward, the whisper forward and one whisper
        # decode step
        "zoo_rows": {r["shape"]: {k: r[k] for k in (
            "B", "S", "T", "H", "Hkv", "hd", "causal", "regime",
            "max_abs_err", "ulp_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
            for r in flash_rows if r["shape"].startswith(("vlm-", "whisper-"))
            and r["dtype"] == "bfloat16"},
        "zoo_launches": {
            "qwen2-vl-2b forward": (
                forwards["qwen2-vl-2b"]["launches"]["flash_attention"]),
            "whisper-medium forward": (
                forwards["whisper-medium"]["launches"]["flash_attention"]),
            "whisper-medium decode step": (
                forwards["whisper-medium"]["decode_step_launches"]
                ["flash_attention"])}})
    # decode attention replaces no TPU kernel; its main rows are the two
    # benchmark cells' shapes at a mean fill, its launches one a layer of
    # a decode step (qwen2.5-3b's serve run: wrappers and replays)
    dr = {r["shape"]: r for r in decode_rows if r["dtype"] == "bfloat16"}
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": None,
        "launches": serve["launches"]["decode_attention"],
        "replayed_launches": serve["replayed_launches"]["decode_attention"],
        "max_abs_err": dr["chat-338"]["max_abs_err"],
        "ms": dr["chat-338"]["ms"], "device_ms": dr["chat-338"]["device_ms"],
        "plain_ms": dr["chat-338"]["plain_ms"],
        "bound_ms": dr["chat-338"]["bound_ms"],
        "bound_by": dr["chat-338"]["bound_by"],
        "library_ms": dr["chat-338"]["library_ms"],
        "rows": {label: {f: r[f] for f in (
            "mean_fill", "chunk", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "library_ms")}
            for label, r in dr.items()}})
    # the training path runs no hand-written kernel (the reference's
    # jax.grad cannot pass through pallas_call; the port trains on the
    # plain path as the reference does)
    for k in kernels:
        k["train_launches"] = train["full"]["kernel_launches"][k["name"]]
    # the mesh path (mesh_prefill): each kernel's launches in that run
    # alone, and its row at that run's shapes
    for k in kernels:
        k["mesh_prefill_launches"] = mesh["prefill"]["launches"][k["name"]]
    for name, key in (("fused_mlp", "fused_mlp_row"),
                      ("flash_attention", "flash_row")):
        k = next(kk for kk in kernels if kk["name"] == name)
        r = mesh["prefill"][key]
        k["mesh_prefill"] = {f: r[f] for f in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
    record = {"card": smi, "kernels": kernels, "fused_mlp_rows": rows,
              "maxplus_rows": mp_rows, "maxplus_exact": mp_exact,
              "price_rows_rows": pr_rows, "price_rows_calls": pr_calls,
              "wkv6_rows": wkv_rows,
              "rglru_rows": rg_rows, "flash_rows": flash_rows,
              "decode_attention_rows": decode_rows,
              "launch_floor_ms": floor_ms,
              "serve": serve, "serves": serves, "forwards": forwards,
              "inits": inits,
              "plan": plan, "simulate": sim, "small_reference": small,
              "phase_seconds": phase_s,
              "plan_lm": plan_lm, "serve_planned": planned,
              "tenants": tenants, "train": train, "mesh": mesh,
              "dryrun": dry, "seconds": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"total {record['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    return record


if __name__ == "__main__":
    main()
