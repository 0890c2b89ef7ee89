"""Fault-tolerant training loop, on one device or on a mesh.

Port of ``repro.runtime.train_loop``:
  * step-atomic async checkpoints every ``ckpt_every`` steps;
  * resume from the latest checkpoint in ``ckpt_dir`` at start;
  * on a step failure (device error, preemption, an injected fault) the
    loop waits for the checkpointer, rebuilds the parameters, optimizer
    state and step, restores the latest checkpoint (or restarts at step
    0) and continues; deterministic data means the restart replays the
    exact global batches.  It gives up after ``max_failures``.
With ``mesh_fn`` the loop trains on the mesh it returns: parameters
(``init_sharded``) and AdamW moments as DTensors of the reference's
shardings, each rank's rows of every batch (``shard_batch``), the step
inside ``use_mesh``.  On a failure it calls ``mesh_fn`` again (elastic
re-mesh: the survivors' mesh), rebuilds on it and restores the latest
checkpoint onto it, which reshards every leaf.  Without ``mesh_fn`` it
runs on one device, as before the distributed layer.

The data pipeline yields tokens and labels only, as the reference's
loop feeds: the vlm and encoder-decoder archs, whose losses also take
patch embeddings or frames, do not train here (the reference's loop
fails on them at its first step).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, \
    restore
from repro_torch.data.pipeline import (DataConfig, TokenDataset,
                                       shard_batch, to_device)
from repro_torch.distributed.hints import use_mesh
from repro_torch.distributed.sharding import (distribute, init_sharded,
                                              params_shardings)
from repro_torch.models.common import DeviceLike, ModelConfig, \
    resolve_device
from repro_torch.models.transformer import init_model
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime.steps import make_train_step
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0
    max_failures: int = 3


class FaultInjector:
    """Test hook: raise at a chosen step to simulate a node failure."""

    def __init__(self, fail_at: Optional[int] = None):
        self.fail_at = fail_at
        self.fired = False

    def check(self, step: int) -> None:
        if self.fail_at is not None and step == self.fail_at and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected node failure at step {step}")


def _build(cfg: ModelConfig, opt_cfg: AdamWConfig, loop: TrainLoopConfig,
           device, params: Any = None, mesh=None):
    """Fresh parameters (``init_model`` from ``loop.seed``, or a copy of
    ``params`` on ``device``; on ``mesh``, their shards), optimizer state
    and train step."""
    if mesh is not None and params is None:
        params = init_sharded(cfg, mesh, seed=loop.seed, device=device)
    elif mesh is not None:
        params = distribute(params, params_shardings(cfg, params, mesh),
                            device)
    elif params is None:
        params = init_model(cfg, seed=loop.seed, device=device)
    else:
        params = tree_map(lambda t: t.detach().to(device, copy=True), params)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=loop.microbatches)
    return params, init_state(params), step_fn


def train(cfg: ModelConfig, opt_cfg: AdamWConfig, loop: TrainLoopConfig,
          data_cfg: DataConfig, fault: Optional[FaultInjector] = None,
          on_metrics: Optional[Callable[[int, Dict], None]] = None,
          device: DeviceLike = None, params: Any = None,
          mesh_fn: Optional[Callable[[], Any]] = None,
          mesh: Any = None) -> Dict[str, Any]:
    """Run the loop on ``device`` (``cuda`` unless the caller names
    another), or on a mesh: ``mesh``, or else the one ``mesh_fn()``
    returns (its device type; a ``cuda`` mesh raises without a card),
    ``mesh_fn`` forming each later one.  ``params``: start from (a copy
    of, or the shards of) these instead of ``init_model``'s draws, for
    example the reference's parameters.

    Returns the final params and optimizer state, the metrics history
    (every ``log_every`` steps and the last: the step, its metrics and
    ``wall_s``, the host seconds since the previous entry or since the
    loop or a recovery began), the failures recovered, ``steps_run``
    (successful steps, replays included), ``seconds`` (the loop's host
    time from its first step, recoveries included) and the
    checkpointer's ``saves``."""
    if cfg.arch_kind in ("vlm", "encdec"):
        raise ValueError(f"{cfg.name}: the token pipeline feeds no "
                         "patch embeddings or frames, which its loss takes")
    if mesh is None and mesh_fn is not None:
        mesh = mesh_fn()
    dev = resolve_device(mesh.device_type if mesh is not None else device)
    ds = TokenDataset(data_cfg)
    ckpt = AsyncCheckpointer(loop.ckpt_dir) if loop.ckpt_dir else None
    history = []
    failures = 0
    steps_run = 0

    def restore_latest(params, opt_state):
        last = latest_step(loop.ckpt_dir) if loop.ckpt_dir else None
        if last is None:
            return params, opt_state, 0
        tree = restore(loop.ckpt_dir, last,
                       {"params": params, "opt": opt_state})
        print(f"[train] resumed from step {last}")
        return tree["params"], tree["opt"], last

    state, opt_state, step_fn = _build(cfg, opt_cfg, loop, dev, params, mesh)
    state, opt_state, step = restore_latest(state, opt_state)
    t_start = t_last = time.perf_counter()
    while step < loop.steps:
        failed = False
        try:
            batch = (shard_batch(ds, step, mesh, dev) if mesh is not None
                     else to_device(ds.global_batch_at(step), dev))
            if fault is not None:
                fault.check(step)
            with use_mesh(mesh):
                state, opt_state, metrics = step_fn(state, opt_state, batch)
            step += 1
            steps_run += 1
            if step % loop.log_every == 0 or step == loop.steps:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                history.append({"step": step, **m, "wall_s": now - t_last})
                t_last = now
                if on_metrics:
                    on_metrics(step, m)
            if ckpt and step % loop.ckpt_every == 0:
                ckpt.save_async(step, {"params": state, "opt": opt_state},
                                {"model": cfg.name})
        except Exception as e:  # noqa: BLE001 — node failure path
            failures += 1
            if failures > loop.max_failures:
                raise
            print(f"[train] step {step} failed ({e}); rebuilding and "
                  f"restoring (failure {failures}/{loop.max_failures})")
            failed = True
        if failed:
            # outside the handler: its traceback held the failed step's
            # frames, and with them its activations and gradients
            if ckpt:
                ckpt.wait()
            state = opt_state = step_fn = None     # drop the failed state
            if mesh_fn is not None:
                mesh = mesh_fn()     # elastic: the survivors' mesh
            state, opt_state, step_fn = _build(cfg, opt_cfg, loop, dev,
                                               params, mesh)
            state, opt_state, step = restore_latest(state, opt_state)
            t_last = time.perf_counter()

    if ckpt:
        ckpt.wait()
    return {"params": state, "opt_state": opt_state, "history": history,
            "failures": failures, "steps_run": steps_run,
            "seconds": time.perf_counter() - t_start,
            "saves": ckpt.saves if ckpt else []}
