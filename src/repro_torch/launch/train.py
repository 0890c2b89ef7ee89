"""Training launcher of the port.

    # the smoke config on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --device cpu --steps 20

    # the published config on the card (train_4k's sequence length):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 6 --batch 8 --seq 4096

    # on a mesh of N cards (or N CPU processes with --device cpu):
    PYTHONPATH=src torchrun --nproc-per-node N \
        -m repro_torch.launch.train --arch qwen2.5-3b --steps 6 \
        --batch 8 --seq 4096

Trains ``--arch`` from random weights (seed 0) on synthetic tokens with
``runtime.train_loop.train``, on the card unless ``--device`` names
another.  When ``WORLD_SIZE`` is set (``torchrun`` sets it; a single
process may set ``WORLD_SIZE=1``), or with ``--multipod``, it trains on
a mesh (``launch.mesh``; NCCL on ``cuda``, gloo on ``cpu``): the
production mesh when the world has its size (256 ranks, or 512 with
``--multipod``), else the host mesh (world, 1), (1, 1) on one card;
``--multipod`` on a world of another size raises before joining a
group.  Microbatches: ``pick_microbatches(cfg, batch, data shards)``
at full width, ``min(2, batch)`` with ``--smoke``, as the reference's
launcher.  Prints (rank 0) the reference's ``step ... loss ... gnorm
...`` lines every ``--log-every`` steps, its ``finished`` line, then the
tokens per second of the loop.  The vlm and encoder-decoder archs do
not train (see ``runtime.train_loop``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import (data_size, make_host_mesh,
                                     make_production_mesh, process_group,
                                     production_shape)
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.steps import pick_microbatches
from repro_torch.runtime.train_loop import TrainLoopConfig, train


def opt_config(steps: int, lr: float) -> AdamWConfig:
    """The launcher's optimizer: warmup over max(2, steps // 20) steps,
    the cosine over the run."""
    return AdamWConfig(lr=lr, warmup_steps=max(2, steps // 20),
                       total_steps=steps)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train one arch of the port on synthetic tokens.")
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--shape", choices=[s for s in SHAPES
                                        if SHAPES[s].kind == "train"],
                    default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default 8 with --smoke, else the "
                         "shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 64 with --smoke, else "
                         "the shape's)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (the encoder's too), "
                         "keeping every width; chip_smoke.py trains "
                         "qwen2.5-3b at 2 layers for its checkpoint, fault "
                         "and resume runs")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the "
                         "CPU)")
    ap.add_argument("--multipod", action="store_true",
                    help="the 2 x 16 x 16 production mesh (512 ranks)")
    return ap


def mesh_for(multi_pod: bool):
    """The launcher's mesh over the default group: the production mesh
    with ``multi_pod`` or when the world has its 256 ranks (it raises on
    any other size), else the host mesh."""
    shape, _ = production_shape(multi_pod)
    if multi_pod or dist.get_world_size() == math.prod(shape):
        return make_production_mesh(multi_pod=multi_pod)
    return make_host_mesh()


def setup(args: argparse.Namespace, dp: int = 1
          ) -> Tuple[ModelConfig, AdamWConfig, TrainLoopConfig, DataConfig]:
    """The run ``args`` (from ``parser()``) describe on ``dp`` data
    shards: (model config, optimizer, loop, data)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        if args.layers < 1:
            raise ValueError("--layers takes N >= 1")
        cfg = dataclasses.replace(
            cfg, n_layers=args.layers,
            n_enc_layers=min(cfg.n_enc_layers, args.layers))
    shape = SHAPES[args.shape]
    batch = args.batch or (8 if args.smoke else shape.global_batch)
    seq = args.seq or (64 if args.smoke else shape.seq_len)
    data = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab)
    loop = TrainLoopConfig(
        steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=args.log_every,
        microbatches=(min(2, batch) if args.smoke
                      else pick_microbatches(cfg, batch, dp)))
    return cfg, opt_config(args.steps, args.lr), loop, data


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the launcher; returns ``train``'s output.  Unless the caller
    set ``PYTORCH_CUDA_ALLOC_CONF``, the CUDA caching allocator grows its
    segments in place (``expandable_segments``; it takes effect when this
    is the process's first CUDA use): a full-width step's transients (a
    microbatch's float32 logits are 5 GB at 2 x 4096) otherwise split
    the cache until a step fails with 14 GB reserved but free."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    args = parser().parse_args(argv)
    mesh, mesh_fn, dp, rank = None, None, 1, 0
    if args.multipod or "WORLD_SIZE" in os.environ:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if args.multipod and world != 512:
            raise ValueError(f"--multipod needs 512 ranks (a 2 x 16 x 16 "
                             f"mesh); the world has {world}")
        process_group(args.device)
        rank = dist.get_rank()
        mesh_fn = functools.partial(mesh_for, args.multipod)
        mesh = mesh_fn()
        dp = data_size(mesh)
    cfg, opt, loop, data = setup(args, dp)
    batch, seq = data.global_batch, data.seq_len
    say = print if rank == 0 else (lambda *a, **k: None)
    out = train(cfg, opt, loop, data,
                on_metrics=lambda s, m: say(
                    f"step {s:5d}  loss {m['loss']:.4f}  "
                    f"gnorm {m['grad_norm']:.3f}"),
                device=args.device, mesh_fn=mesh_fn, mesh=mesh)
    say(f"finished: {len(out['history'])} logged steps, "
        f"{out['failures']} recovered failures")
    tokens = out["steps_run"] * batch * seq
    say(f"{tokens} tokens in {out['seconds']:.3f} s: "
        f"{tokens / out['seconds']:.1f} tokens/s "
        f"({loop.microbatches} microbatches of {batch // loop.microbatches}"
        f" x {seq})")
    return out


if __name__ == "__main__":
    main()
