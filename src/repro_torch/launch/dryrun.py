"""Dry-run on the production meshes: one step of every (arch x shape x
mesh) cell as one rank of 256 or 512 sees it, with no devices.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell on 512 forced host devices and reads XLA's analyses; the port
forms a ``"fake"`` process group of the mesh's size (its collectives
return at once), builds the cell's step at full published size with the
reference's shardings, each rank's shards on the ``meta`` device
(shapes, no storage, no arithmetic), runs it once as rank 0, and records
per device:

  * ``memory``: ``argument_size_in_bytes`` (exact: the shards of the
    step's arguments, and the 4 bytes of a decode step's index),
    ``output_size_in_bytes`` (of its outputs' shards) and
    ``peak_size_in_bytes`` (the most bytes of local storage alive at
    once: the arguments and what the step's ops make, each from its op
    until it is freed); ``fits`` compares the peak with
    the memory of one H100 (``core.hwconfig.H100_HBM_BYTES``);
  * ``flops``: each op's count from ``torch.utils.flop_counter``'s
    formulas, an op on DTensors divided by the ranks its output (or its
    Partial sum) is split over, an op on a rank's local tensors counted
    as it is;
  * ``collectives``: count and output bytes by kind of every collective
    the step issues (``CommDebugMode`` counts them as well).

The XLA-only keys (temp and generated-code sizes, bytes accessed) are
dropped rather than filled.  Train cells take AdamW and
``pick_microbatches`` microbatches; decode cells one token against a
``seq_len`` cache (``--kv-quant``: int8 KV for the dense, moe and vlm
archs).  Results go to ``--out`` (default ``dryrun_results/`` at the
repository's root, which git ignores), one JSON a cell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k [--multipod] [--both-meshes] [--all] [--list]

Importing this module starts no process group: ``run_cell`` forms the
fake group, so a process that runs a cell should run nothing else
distributed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import (ARCHS, SHAPES, cell_supported,
                                 decode_input_specs, get_config,
                                 input_specs)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_results"

#: collective kinds, as the reference names them
_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


def fake_group(world: int) -> None:
    """Make the default process group a ``"fake"`` one of ``world``
    ranks, this process rank 0 (re-forming a fake group of another
    size; refusing a real one)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run runs in a process of its own: "
                               "a real process group is formed")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


class _Counter:
    """A dispatch mode counting per-device FLOPs, collective bytes and
    the bytes of local storage alive at once (each storage counted from
    the op that made it until it is freed)."""

    def __init__(self, external):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        from repro_torch.tree import leaves
        counter = self
        self.flops = 0.0
        self.coll_bytes: Dict[str, int] = defaultdict(int)
        self.coll_count: Dict[str, int] = defaultdict(int)
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in leaves(external):
            self.hold(t)

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                for o in (out if isinstance(out, (list, tuple)) else [out]):
                    counter.hold(o)
                name = func.overloadpacket.__name__
                if name in _KINDS and str(func).startswith("_c10d"):
                    kind = _KINDS[name]
                    counter.coll_count[kind] += 1
                    counter.coll_bytes[kind] += _nbytes(out)
                elif func.overloadpacket in flop_registry:
                    f = flop_registry[func.overloadpacket](
                        *args, **kwargs, out_val=out)
                    counter.flops += f / _split(out)
                return out

        self.mode = Mode()

    def hold(self, t) -> None:
        """Count ``t``'s local storage as alive until it is freed."""
        import weakref

        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t.to_local()
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)

        def free(n=n, counter=weakref.ref(self)):
            c = counter()
            if c is not None:
                c.live -= n
        weakref.finalize(st, free)


def _nbytes(out) -> int:
    ts = out if isinstance(out, (list, tuple)) else [out]
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _split(out) -> int:
    """Ranks a DTensor op's work is split over: the mesh dims its output
    is sharded or partial over (1 for a rank's local op)."""
    from torch.distributed.tensor import DTensor
    t = out[0] if isinstance(out, (list, tuple)) else out
    if not isinstance(t, DTensor):
        return 1
    return math.prod(t.device_mesh.size(i)
                     for i, p in enumerate(t.placements)
                     if not p.is_replicate())


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import leaves
    total = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _distribute_meta(tree, shardings) -> Any:
    """DTensors of ``shardings`` holding ``meta`` shards (shapes, no
    storage) of ``tree``'s leaves."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import contiguous_stride
    from repro_torch.tree import tree_map

    def leaf(t, sh):
        local = torch.empty(sh.shard_shape(tuple(t.shape)), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, sh.mesh, sh.placements(),
                                  run_check=False, shape=t.shape,
                                  stride=contiguous_stride(t))
    return tree_map(leaf, tree, shardings)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, kv_quant: bool = False) -> dict:
    """One cell's record (see the module docstring)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.hwconfig import H100_HBM_BYTES
    from repro_torch.distributed.hints import use_mesh
    from repro_torch.distributed.sharding import (
        abstract_params, batch_shardings, cache_shardings, params_shardings)
    from repro_torch.launch.mesh import (data_size, make_production_mesh,
                                         production_shape)
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.runtime.steps import (make_prefill_step,
                                           make_serve_step, make_train_step,
                                           pick_microbatches)
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if kv_quant and shape.kind == "decode" \
            and cfg.arch_kind in ("dense", "moe", "vlm"):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    dims, _ = production_shape(multi_pod)
    n_chips = math.prod(dims)
    t0 = time.time()
    fake_group(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod)
    dp = data_size(mesh)
    meta = abstract_params(cfg)
    mb = 1
    params = _distribute_meta(meta, params_shardings(cfg, meta, mesh))
    index_bytes = 0
    if shape.kind == "train":
        mb = pick_microbatches(cfg, shape.global_batch, dp)
        step = make_train_step(cfg, AdamWConfig(), microbatches=mb)
        specs = input_specs(cfg, shape)
        args = (params, init_state(params),
                _distribute_meta(specs, batch_shardings(cfg, specs, mesh)))
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
        specs = input_specs(cfg, shape)
        specs.pop("labels")
        args = (params,
                _distribute_meta(specs, batch_shardings(cfg, specs, mesh)))
    else:
        step = make_serve_step(cfg)
        dspecs = decode_input_specs(cfg, shape)
        tokens = {"t": dspecs["tokens"]}
        args = (params,
                _distribute_meta(tokens, batch_shardings(cfg, tokens,
                                                         mesh))["t"],
                _distribute_meta(dspecs["cache"], cache_shardings(
                    cfg, dspecs["cache"], mesh)),
                shape.seq_len - 1)
        index_bytes = 4              # the reference's int32 cache index
    arg_bytes = _local_bytes(list(args)) + index_bytes
    counter = _Counter(list(args))
    comm = CommDebugMode()
    with use_mesh(mesh), comm, counter.mode:
        out = step(*args)
    peak_bytes = counter.peak
    out_bytes = _local_bytes(out)
    counts = {str(k).split(".")[-1]: int(v)
              for k, v in comm.get_comm_counts().items()}
    kinds = sorted(set(_KINDS.values()))
    coll = {"bytes": {k: int(counter.coll_bytes.get(k, 0)) for k in kinds},
            "count": {k: int(counter.coll_count.get(k, 0)) for k in kinds},
            "comm_debug_counts": counts}
    coll["total_bytes"] = sum(coll["bytes"].values())
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips, "kind": shape.kind, "microbatches": mb,
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "output_size_in_bytes": int(out_bytes),
                   "peak_size_in_bytes": int(peak_bytes)},
        "device_memory_bytes": H100_HBM_BYTES,
        "fits": bool(peak_bytes <= H100_HBM_BYTES),
        "flops": float(counter.flops),
        "collectives": coll,
        "n_params": int(sum(t.numel() for t in leaves(meta))),
        "kv_quant": bool(cfg.kv_quant),
        "seconds": round(time.time() - t0, 1),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {result['mesh']}: "
              f"{'OK ' if result['fits'] else 'OVER'} "
              f"peak={peak_bytes / 2**30:.2f}GiB/dev  "
              f"args={arg_bytes / 2**30:.2f}GiB/dev  "
              f"flops={result['flops']:.3e}  "
              f"coll={coll['total_bytes']:.3e}B  ({result['seconds']}s)")
    return result


def _tag(multi_pod: bool) -> str:
    return "2-16-16" if multi_pod else "16-16"


def save_result(res: dict, out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / (f"dryrun_{res['mesh'].replace('x', '-')}_"
                      f"{res['arch']}_{res['shape']}.json")
    path.write_text(json.dumps(res, indent=1))
    return path


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for decode cells")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the per-cell JSON records")
    args = ap.parse_args(argv)

    cells = []
    for arch in (sorted(ARCHS) if args.arch is None else [args.arch]):
        for shape in (sorted(SHAPES) if args.shape is None
                      else [args.shape]):
            meshes = [False, True] if args.both_meshes else [args.multipod]
            for mp in meshes:
                cells.append((arch, shape, mp))
    if not (args.all or (args.arch and args.shape)):
        ap.error("pass --all or both --arch and --shape")

    if args.list:
        for c in cells:
            print("RUN " if cell_supported(c[0], c[1]) else "SKIP", *c)
        return 0

    out_dir = Path(args.out)
    failures = []
    t0 = time.time()
    for arch, shape, mp in cells:
        out = out_dir / f"dryrun_{_tag(mp)}_{arch}_{shape}.json"
        if args.skip_existing and out.exists():
            print(f"[dryrun] {arch} x {shape} x {_tag(mp)}: cached")
            continue
        if not cell_supported(arch, shape):
            save_result({"arch": arch, "shape": shape,
                         "mesh": "2x16x16" if mp else "16x16",
                         "skipped": True,
                         "reason": "long_500k requires sub-quadratic "
                                   "attention"}, out_dir)
            print(f"[dryrun] {arch} x {shape}: SKIP (documented)")
            continue
        try:
            save_result(run_cell(arch, shape, mp, kv_quant=args.kv_quant),
                        out_dir)
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            failures.append((arch, shape, mp, repr(e)[:400]))
            print(f"[dryrun] {arch} x {shape} x {_tag(mp)}: FAIL {e!r}"[:500])
    print(f"{len(cells)} cells in {time.time() - t0:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
