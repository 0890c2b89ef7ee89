"""AdamW with global-norm clipping and float32 state, on trees of tensors.

Port of ``repro.optim.adamw``, as plain functions rather than
``torch.optim.AdamW`` (which decays every parameter, and in the
parameter's dtype before the step).  The reference's semantics hold:
float32 moments; clipping by the global norm of the gradients; warmup,
then a cosine down to ``min_lr_ratio``; ``mhat / (sqrt(vhat) + eps)``;
decoupled weight decay on every leaf with ``ndim >= 2`` as stored (so
the stacked per-layer norms (L, D) and QKV biases (L, n) decay, and the
hybrid family's per-layer (D,) norms do not); the new parameter computed
in float32 and cast back to the leaf's dtype.

``apply_updates`` works in place, leaf by leaf, in flat chunks of at most
``CHUNK`` elements: the float32 temporaries of an update are a few
chunks, not a few copies of the largest leaf (qwen2.5-3b's stacked
``w_gate`` is 3.25 GB in float32).

On a mesh the leaves are DTensors: the moments take their parameter's
placements (so sharded parameters give ZeRO-sharded states, as in the
reference), the update runs on each rank's local shard, and
``global_norm`` counts every element once over the mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial

from repro_torch.runtime.telemetry import span
from repro_torch.tree import leaves, tree_map

#: elements of one update chunk (64 MiB of float32)
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the parameters' device
    mu: Any                     # float32, the parameters' tree
    nu: Any


def init_state(params: Any) -> AdamWState:
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _schedule(cfg: AdamWConfig, step: Union[int, torch.Tensor]
              ) -> torch.Tensor:
    """The learning rate at ``step``, a 0-d float32 tensor (on ``step``'s
    device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0,
                                        cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _chunks(*tensors: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat views of at most ``CHUNK`` elements of same-shaped
    contiguous tensors."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("AdamW works on contiguous leaves")
    return zip(*(t.view(-1).split(CHUNK) for t in tensors))


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d).  A
    DTensor leaf adds its local shard's sum divided by the ranks that hold
    a copy of it (a power of two on the meshes here, so exactly), and one
    all-reduce over the mesh sums the ranks: each element counts once."""
    total = 0.0
    mesh = None
    for x in leaves(tree):
        copies = 1
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            for i, p in enumerate(x.placements):
                if p.is_partial():
                    raise ValueError("global_norm takes no Partial leaf")
                if p.is_replicate():
                    copies *= mesh.size(i)
        for (c,) in _chunks(_local(x)):
            s = torch.sum(torch.square(c.float()))
            total = total + (s / copies if copies > 1 else s)
    total = torch.as_tensor(total)
    if mesh is not None:
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: AdamWState) -> Tuple[Any, AdamWState]:
    """One AdamW step.  ``params``, ``state.mu`` and ``state.nu`` are
    updated in place and returned, with the new step count.  DTensor
    leaves update their local shards; a gradient must have its
    parameter's placements."""
    with span("adamw.apply_updates"), torch.no_grad():
        step = state.step + 1
        scale = torch.clamp(cfg.clip_norm / (global_norm(grads) + 1e-9),
                            max=1.0)
        lr = _schedule(cfg, step)
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(cfg.b1, stepf)
        b2c = 1.0 - torch.pow(cfg.b2, stepf)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.mu), leaves(state.nu)):
            decay = p.ndim >= 2       # decoupled weight decay on matrices
            if isinstance(p, DTensor) and (
                    list(g.placements) != list(p.placements)):
                raise ValueError("a gradient's placements differ from its "
                                 "parameter's")
            for pc, gc, mc, vc in _chunks(*map(_local, (p, g, m, v))):
                gc = gc.float() * scale
                mc.mul_(cfg.b1).add_(gc, alpha=1 - cfg.b1)
                vc.mul_(cfg.b2).addcmul_(gc, gc, value=1 - cfg.b2)
                delta = (mc / b1c).div_((vc / b2c).sqrt_().add_(cfg.eps))
                if decay:
                    delta.add_(pc.float(), alpha=cfg.weight_decay)
                pc.copy_(pc.float().sub_(delta.mul_(lr)))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
