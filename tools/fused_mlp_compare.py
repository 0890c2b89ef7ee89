#!/usr/bin/env python3
"""Time ``fused_mlp`` of several source trees on one card, in turns.

    python3 tools/fused_mlp_compare.py --trees OLD NEW NEW OLD \\
        [--shapes T,D,F ...] [--out FILE]
    python3 tools/fused_mlp_compare.py --trees . .:wgmma .:wgmma .

Each tree (the root of a checkout of this repo) runs in a subprocess of
its own, with its own ``src/`` first on the path, so that two versions of
``repro_torch`` never share a process: the subprocess builds that tree's
``fused_mlp`` library, and for each bf16 shape checks the kernel against
its plain version (``KERNEL_TOL``) and a second call for the same bits,
then times it: device ms per call by ``torch.profiler`` (every CUDA
function named ``fused_mlp_kernel*``), ms per call by CUDA events, and
the three cuBLAS products of the same function (``library_ms``).  Give
the trees as OLD NEW NEW OLD to see the spread between turns.  A tree
written ``PATH:REGIME`` runs every bf16 prefill (``T >= PREFILL_MIN_T``)
of that tree in the named regime of its ``choose_regime`` (a ``wgmma``
D-slice is ``wgmma_dc(D)``, a ``cluster`` tile the smallest that holds
``cluster_dc(D)``), to time one regime at another's shapes.  One JSON
object per (tree, shape) goes to standard output and, with ``--out``, to
a file; each row carries a digest of the kernel's output bits, and a
last line says for each shape whether every tree gave the same bits.  A
subprocess that fails or runs past ``--timeout`` seconds fails the
run.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

#: bf16 shapes: the prefill rows of chip_smoke.py's FUSED_MLP_SHAPES at
#: D <= 2560 and D = 5120, one and two row tiles at D = 2048 (the
#: boundary of the one-tile regime), and decode at D = 2048, 4096 and 5120
SHAPES = [(256, 2048, 11008), (5, 2048, 11008), (8192, 2560, 10240),
          (2048, 1536, 8960), (512, 5120, 17920), (512, 5120, 27392),
          (64, 2048, 11008), (128, 2048, 11008),
          (4, 2048, 11008), (4, 4096, 17920), (4, 5120, 17920),
          (4, 4096, 27392), (4, 5120, 27392)]
KERNEL_TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12


def _events_ms(fn, iters: int) -> float:
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, calls: int = 5) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "fused_mlp_kernel" in e.name]
    return sum(us) / calls / 1e3 if us else float("nan")


def _force_regime(fm, regime: str) -> None:
    """Send every bf16 prefill of ``fm`` (the tree's ``fused_mlp``
    module) to ``regime``."""
    own = fm.choose_regime

    def choose(T, D, bf16):
        if not (bf16 and T >= fm.PREFILL_MIN_T):
            return own(T, D, bf16)
        if regime == "wgmma":
            return "wgmma", fm.wgmma_dc(D)
        return regime, min(t for t in fm.CLUSTER_DC_TILES
                           if t >= fm.cluster_dc(D))

    fm.choose_regime = choose
    fm._plan.cache_clear()


def worker(tree: Path, shapes, regime) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import fused_mlp as fm
    assert Path(fm.__file__).resolve().is_relative_to(tree.resolve()), \
        fm.__file__
    if not torch.cuda.is_available():
        raise SystemExit("no card")
    if regime:
        _force_regime(fm, regime)
    torch.backends.cuda.matmul.allow_tf32 = False
    for T, D, F in shapes:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(T * 7 + D + F)

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale
                    ).to(torch.bfloat16)

        x = rnd(T, D)
        wg, wu = rnd(D, F, scale=D ** -0.5), rnd(D, F, scale=D ** -0.5)
        wd = rnd(F, D, scale=F ** -0.5)
        out = fm.fused_mlp(x, wg, wu, wd)
        again = fm.fused_mlp(x, wg, wu, wd)
        exp = fm.fused_mlp_ref(x, wg, wu, wd)
        torch.cuda.synchronize()
        diff = (out.float() - exp.float()).abs()
        ok = bool((diff <= KERNEL_TOL + KERNEL_TOL * exp.float().abs()).all())
        call = lambda: fm.fused_mlp(x, wg, wu, wd)       # noqa: E731
        lib = lambda: (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd  # noqa
        once = _events_ms(call, 1)
        iters = max(5, min(200, math.ceil(100.0 / max(once, 1e-3))))
        t_bytes = (2 * T * D + 3 * D * F) * 2 / HBM_BYTES_PER_S * 1e3
        t_ops = 6 * T * D * F / PEAK_BF16_OPS_PER_S * 1e3
        row = {"tree": str(tree) + (f":{regime}" if regime else ""),
               "T": T, "D": D, "F": F,
               "regime": fm.choose_regime(T, D, True)[0],
               "max_abs_err": float(diff.max()), "ok": ok,
               "repeatable": bool(torch.equal(out, again)),
               "digest": hashlib.sha256(
                   out.view(torch.int16).cpu().numpy().tobytes()
               ).hexdigest()[:16],
               "device_ms": _device_ms(call), "ms": _events_ms(call, iters),
               "library_ms": _events_ms(lib, iters),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(json.dumps(row), flush=True)
        del x, wg, wu, wd, out, again, exp, diff
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="PATH or PATH:REGIME")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="T,D,F triples (default: SHAPES)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--regime", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shapes]
              if args.shapes else SHAPES)
    if args.worker is not None:
        worker(args.worker, shapes, args.regime)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rows, failed = [], []
    for spec in args.trees:
        tree, _, regime = str(spec).partition(":")
        tree = Path(tree)
        cmd = [sys.executable, __file__, "--worker", str(tree.resolve()),
               "--shapes", *(",".join(map(str, s)) for s in shapes)]
        if regime:
            cmd += ["--regime", regime]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout)
        except subprocess.TimeoutExpired:
            failed.append(f"{spec}: timed out after {args.timeout} s")
            continue
        sys.stderr.write(proc.stderr[-4000:])
        for line in proc.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rows.append(json.loads(line))
        if proc.returncode != 0:
            failed.append(f"{spec}: exit {proc.returncode}")
    failed += [f"{r['tree']} {r['T']},{r['D']},{r['F']}: not within "
               f"{KERNEL_TOL} or not repeatable"
               for r in rows if not (r["ok"] and r["repeatable"])]
    digests = {}
    for r in rows:
        digests.setdefault((r["T"], r["D"], r["F"]), set()).add(r["digest"])
    same = {",".join(map(str, k)): len(v) == 1 for k, v in digests.items()}
    print(json.dumps({"same_bits_across_trees": same}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows,
                                        "same_bits": same,
                                        "failed": failed}, indent=1))
    for f in failed:
        print(f"FAIL {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
