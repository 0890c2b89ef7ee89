"""Step factories: the train step (gradient accumulation over
microbatches, remat, AdamW), the prefill step and the serve step
(single-token greedy decode), arch dispatch included.

Port of ``repro.runtime.steps``.  The reference jits these functions;
the port runs them eagerly.  The train step runs the plain path only:
the reference's ``jax.grad`` cannot pass through its Pallas kernels, and
the port's CUDA kernels have no backward (their wrappers raise under
grad mode), so ``make_train_step`` refuses ``use_kernels``.

On a mesh (inside ``distributed.hints.use_mesh``, parameters, optimizer
state and batch as DTensors) the same functions run SPMD: each gradient
is brought to its parameter's placements, and the metrics come back as
plain tensors, the same on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.hints import hint, to_plain
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (decode_step, forward, loss_fn,
                                            whisper_decode_step,
                                            whisper_forward,
                                            whisper_loss_fn)
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, apply_updates,
                                     global_norm)
from repro_torch.tree import leaves, tree_map, unflatten

Batch = Dict[str, torch.Tensor]

#: the reference's metric norm: the same sum as the optimizer's clipping
_global_norm = global_norm


def arch_loss_fn(cfg: ModelConfig) -> Callable:
    return whisper_loss_fn if cfg.arch_kind == "encdec" else loss_fn


def microbatch(batch: Batch, i: int, M: int) -> Batch:
    """Microbatch ``i`` of ``M`` of the reference's interleaved split:
    rows i, i + M, i + 2M, ...  A DTensor batch whose rows shard over the
    data axes splits on each rank's own rows when each rank holds a
    multiple of M of them (rank r's block of the global rows then holds
    exactly its share of every microbatch, in order), so the data
    sharding stays on the microbatch's rows and no rank gathers the
    batch; otherwise the slice goes through DTensor."""
    out = {}
    for k, v in batch.items():
        if (isinstance(v, DTensor)
                and v.to_local().shape[0] % M == 0
                and all(p.is_replicate() or p.is_shard(0)
                        for p in v.placements)):
            out[k] = DTensor.from_local(
                v.to_local()[i::M], v.device_mesh, v.placements,
                run_check=False)
        else:
            out[k] = v[i::M]
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1,
                    grad_dtype: torch.dtype = torch.float32) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and the optimizer state updated in place.

    With microbatches > 1 the batch's leading dim is split and the
    gradients accumulate in ``grad_dtype``, then are averaged; activation
    memory is one microbatch's.  The split is the reference's interleaved
    one, (B,) -> (B/M, M) -> swap, so microbatch i holds examples i,
    i + M, i + 2M, ...: the same examples as in JAX.  Each microbatch's
    gradients come back in the parameters' dtypes, as from
    ``jax.value_and_grad``.  ``metrics``: "loss" (the mean over
    microbatches), "step" (after the update) and "grad_norm" (before
    clipping)."""
    if cfg.use_kernels:
        raise ValueError(
            f"{cfg.name}: make_train_step runs the plain path; the CUDA "
            "kernels have no backward (the reference cannot differentiate "
            "its Pallas kernels either), so use_kernels must be False")
    base_loss = arch_loss_fn(cfg)
    M = max(1, microbatches)

    def loss_and_grads(params, batch: Batch
                       ) -> Tuple[torch.Tensor, list]:
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = base_loss(live, cfg, batch)
        grads = list(torch.autograd.grad(loss, leaves(live)))
        for j, p in enumerate(leaves(params)):
            if isinstance(p, DTensor):
                grads[j] = grads[j].redistribute(p.device_mesh, p.placements)
        return loss.detach(), grads

    def train_step(params, opt_state: AdamWState, batch: Batch):
        if M == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch {B} does not split into {M} "
                                 "microbatches")
            grads = [torch.zeros_like(p, dtype=grad_dtype)
                     for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            for i in range(M):
                l, g = loss_and_grads(params, microbatch(batch, i, M))
                for j, acc in enumerate(grads):
                    acc.add_(g[j])
                    g[j] = None       # free each microbatch gradient
                loss = loss + l
            for acc in grads:
                acc.div_(M)
            loss = loss / M
        grads = unflatten(params, grads)
        grad_norm = _global_norm(grads)
        params, opt_state = apply_updates(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": to_plain(loss),
                                   "step": opt_state.step,
                                   "grad_norm": grad_norm}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> logits: the inference-prefill cell."""
    @torch.no_grad()
    def prefill_step(params, batch: Batch) -> torch.Tensor:
        if cfg.arch_kind == "encdec":
            return whisper_forward(params, cfg, batch["frames"],
                                   batch["tokens"])
        logits, _ = forward(params, cfg, batch["tokens"],
                            patch_embeds=batch.get("patch_embeds"))
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B, 1), cache, index) -> (next_tokens (B, 1),
    cache): one new token against the cache (greedy argmax), the cache
    updated in place."""
    @torch.no_grad()
    def serve_step(params, tokens: torch.Tensor, cache: Any, index):
        if cfg.arch_kind == "encdec":
            logits, cache = whisper_decode_step(params, cfg, tokens, cache,
                                                index)
        else:
            logits, cache = decode_step(params, cfg, tokens, cache, index)
        # on a mesh the last position's logits gather their vocab shards
        # first: one row a sequence, and the argmax then needs no offsets
        last = hint(logits[:, -1, :], "batch", None)
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step


def pick_microbatches(cfg: ModelConfig, global_batch: int,
                      dp_size: int) -> int:
    """Accumulation steps so one microbatch is ~1 sample per data shard
    for the big dense models (activation memory bound), fewer for small."""
    per_shard = max(1, global_batch // max(1, dp_size))
    if (cfg.d_model >= 4096 or cfg.n_layers >= 40
            or cfg.arch_kind == "hybrid"):    # fp32 recurrence states
        return per_shard                      # 1 sample/shard/microbatch
    if cfg.d_model >= 2048:
        return max(1, per_shard // 2)
    return max(1, per_shard // 4)
