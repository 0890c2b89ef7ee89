"""LM assembly for the dense family: init, forward, KV cache, decode.

Port of the dense paths of ``repro.models.transformer``.  Per-layer
parameters are stacked on a leading axis as in the reference; the port
walks the layers in a Python loop (PyTorch runs eagerly, so there is no
``scan`` and no remat).

Entry points:
    init_model(cfg, seed, device)                    -> params
    forward(params, cfg, tokens)                     -> (logits, aux)
    init_cache(cfg, batch, max_len, device)          -> cache
    decode_step(params, cfg, tokens, cache, index)   -> (logits, cache)

``decode_step`` and ``zero_cache_slot`` update the cache tensors in place
and return the same dictionary.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .common import (DeviceLike, ModelConfig, Params, dense_init,
                     resolve_device, rms_norm)
from .layers import Index, attention, init_attention, init_swiglu, swiglu

BIG_WINDOW = 1 << 30   # "global" attention sentinel


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.arch_kind != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: arch_kind={cfg.arch_kind!r} is not ported to "
            "repro_torch yet (ROADMAP.md)")


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Neutralize the padded embedding rows (softmax- and argmax-safe)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window (``BIG_WINDOW`` for global layers)."""
    if cfg.local_window <= 0:
        return [BIG_WINDOW] * cfg.n_layers
    w = []
    for l in range(cfg.n_layers):
        is_global = cfg.global_every > 0 and (l + 1) % cfg.global_every == 0
        w.append(BIG_WINDOW if is_global else cfg.local_window)
    return w


def _layer(tree, l: int):
    """Layer ``l``'s parameters (views) from the stacked layer tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_decoder_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    zeros = dict(dtype=torch.float32, device=gen.device)
    return {"ln1": torch.zeros((cfg.d_model,), **zeros),
            "ln2": torch.zeros((cfg.d_model,), **zeros),
            "attn": init_attention(gen, cfg),
            "mlp": init_swiglu(gen, cfg)}


def init_model(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = None) -> Params:
    """Random parameters in the reference's layout, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``.  (The draws differ
    from ``jax.random``'s; tests carry JAX parameters across with
    ``convert.params_from_jax`` instead.)"""
    _require_dense(cfg)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    params: Params = {
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model), cfg.dtype,
                            scale=0.02),
        "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                            device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       cfg.dtype)
    params["layers"] = _stack(
        [_init_decoder_layer(gen, cfg) for _ in range(cfg.n_layers)])
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _uniform_layer(cfg: ModelConfig, x: torch.Tensor, layer_p: Params,
                   window: Optional[int], positions: torch.Tensor,
                   cache: Optional[Params] = None,
                   cache_index: Optional[Index] = None) -> torch.Tensor:
    """One pre-norm decoder layer; the cache (if any) updates in place."""
    h = rms_norm(x, layer_p["ln1"], cfg.norm_eps)
    if cache is not None and cfg.kv_quant:
        c_in = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
    elif cache is not None:
        c_in = (cache["k"], cache["v"])
    else:
        c_in = None
    x = x + attention(layer_p["attn"], h, cfg, positions, window=window,
                      cache=c_in, cache_index=cache_index)
    h2 = rms_norm(x, layer_p["ln2"], cfg.norm_eps)
    return x + swiglu(layer_p["mlp"], h2, cfg)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["unembed"]
    return _mask_pad_vocab(logits, cfg)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss); the dense
    family has no auxiliary loss, so aux is 0."""
    _require_dense(cfg)
    x = params["embed"][tokens]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    for l, win in enumerate(layer_windows(cfg)):
        x = _uniform_layer(cfg, x, _layer(params["layers"], l),
                           None if win >= BIG_WINDOW else win, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=None, device: DeviceLike = None) -> Params:
    _require_dense(cfg)
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_quant:
        scale_shape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(scale_shape, dtype=dtype, device=dev),
            "v_scale": torch.zeros(scale_shape, dtype=dtype, device=dev),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


def zero_cache_slot(cfg: ModelConfig, cache: Params, slot: int) -> Params:
    """Clear one batch slot's rows across every array of a decode cache,
    in place.  Continuous-batching engines reuse decode slots; a refilled
    request must not attend to the previous occupant's keys/values."""
    _require_dense(cfg)
    for a in cache.values():
        a[:, slot] = 0
    return cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, index: Index) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); index: the cache fill cursor — an
    int (or 0-d tensor) when all rows decode in lockstep, or a per-slot
    (B,) tensor when a continuous-batching engine advances each slot
    independently.  The cache is written in place (``ck[l, b, index]``)
    and returned."""
    _require_dense(cfg)
    B = tokens.shape[0]
    x = params["embed"][tokens]
    if isinstance(index, torch.Tensor) and index.ndim == 1:
        index = index.to(x.device)
        positions = index[:, None]
    else:
        index = int(index)
        positions = torch.full((B, 1), index, dtype=torch.long,
                               device=x.device)
    for l, win in enumerate(layer_windows(cfg)):
        x = _uniform_layer(cfg, x, _layer(params["layers"], l), win,
                           positions, cache=_layer(cache, l),
                           cache_index=index)
    return _logits(params, cfg, x), cache
