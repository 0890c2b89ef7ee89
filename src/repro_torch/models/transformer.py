"""LM assembly for the dense, MoE, RWKV and hybrid families: init,
forward, decode cache, decode.

Port of the dense, ``moe``, ``rwkv`` and ``hybrid`` paths of
``repro.models.transformer``.  Uniform-layer families (dense, moe, rwkv)
stack per-layer parameters on a leading axis as in the reference; the hybrid
(RecurrentGemma) family keeps a list of per-layer dictionaries, since its
layers differ.  The port walks the layers in a Python loop (PyTorch runs
eagerly, so there is no ``scan`` and no remat).  A MoE layer differs
from a dense one only in its MLP (``layers.moe_ffn``); ``forward``
returns the mean of its layers' load-balance losses.  The vlm and encdec
families raise ``NotImplementedError``.

Entry points:
    init_model(cfg, seed, device)                    -> params
    forward(params, cfg, tokens)                     -> (logits, aux)
    init_cache(cfg, batch, max_len, device)          -> cache
    decode_step(params, cfg, tokens, cache, index)   -> (logits, cache)

``decode_step`` and ``zero_cache_slot`` update the cache tensors in place
and return the same dictionary.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from .common import (DeviceLike, ModelConfig, Params, dense_init,
                     resolve_device, rms_norm)
from .layers import (Index, attention, init_attention, init_moe,
                     init_swiglu, moe_ffn, swiglu)
from .rglru import init_recurrent_block, recurrent_block
from .rwkv6 import HEAD_SIZE, channel_mix, init_channel_mix, init_time_mix, \
    time_mix

BIG_WINDOW = 1 << 30   # "global" attention sentinel

#: a layer's load-balance loss: a 0-d float32 tensor, or 0.0 without experts
Aux = Union[torch.Tensor, float]


def _require_ported(cfg: ModelConfig) -> None:
    """Dense, moe, rwkv and hybrid run; vlm and encdec are not ported
    yet."""
    if cfg.arch_kind not in ("dense", "moe", "rwkv", "hybrid"):
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
    """Per-layer attention window (``BIG_WINDOW`` for global layers) of
    the gemma3-style local:global pattern: layer l is global when
    ``(l + 1) % global_every == 0``, so gemma3-4b's 34 layers are five
    groups of 5 local + 1 global and 4 local layers, global at 5, 11, 17,
    23 and 29, the windows the reference's pattern-group walk gives.  The
    hybrid family does not use it: its attention layers are all local
    (``cfg.local_window``)."""
    if cfg.local_window <= 0:
        return [BIG_WINDOW] * cfg.n_layers
    w = []
    for l in range(cfg.n_layers):
        is_global = cfg.global_every > 0 and (l + 1) % cfg.global_every == 0
        w.append(BIG_WINDOW if is_global else cfg.local_window)
    return w


def _block_kind(cfg: ModelConfig, l: int) -> str:
    return cfg.block_pattern[l % len(cfg.block_pattern)]


def _layer(tree, l: int):
    """Layer ``l``'s parameters or cache (views) from a stacked tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, l) for v in tree)
    return tree[l]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_decoder_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    zeros = dict(dtype=torch.float32, device=gen.device)
    p: Params = {"ln1": torch.zeros((cfg.d_model,), **zeros),
                 "ln2": torch.zeros((cfg.d_model,), **zeros)}
    if cfg.arch_kind == "rwkv":
        p["tmix"] = init_time_mix(gen, cfg)
        p["cmix"] = init_channel_mix(gen, cfg)
        return p
    p["attn"] = init_attention(gen, cfg)
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg)
    else:
        p["mlp"] = init_swiglu(gen, cfg)
    return p


def _empty_stack(tree, n: int):
    """Uninitialised tensors shaped like ``tree``'s with a leading axis
    of ``n``."""
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _init_stacked_layers(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The uniform families' layers, stacked on a leading axis, drawn
    layer after layer in the reference's order.  Each stacked tensor is
    allocated once, and each layer's draws are copied into their slice
    and dropped before the next layer is drawn: the peak holds the
    weights and one layer's draws, not the weights twice."""
    layer = _init_decoder_layer(gen, cfg)
    stacked = _empty_stack(layer, cfg.n_layers)
    for l in range(cfg.n_layers):
        if l:
            layer = _init_decoder_layer(gen, cfg)
        _copy_leaves(_layer(stacked, l), layer)
        layer = None
    return stacked


def _copy_leaves(dst, src) -> None:
    """Copy each tensor of ``src`` into its twin in ``dst``, in place (in
    a function of its own, so that no loop variable keeps a drawn tensor
    alive into the next layer's draws)."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def _init_hybrid_layer(gen: torch.Generator, cfg: ModelConfig, l: int
                       ) -> Params:
    zeros = dict(dtype=torch.float32, device=gen.device)
    p: Params = {"ln1": torch.zeros((cfg.d_model,), **zeros),
                 "ln2": torch.zeros((cfg.d_model,), **zeros)}
    if _block_kind(cfg, l) == "attn":
        p["attn"] = init_attention(gen, cfg)
    else:
        p["rec"] = init_recurrent_block(gen, cfg)
    p["mlp"] = init_swiglu(gen, cfg)
    return p


def init_model(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = None) -> Params:
    """Random parameters in the reference's layout, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``.  (The draws differ
    from ``jax.random``'s; tests carry JAX parameters across with
    ``convert.params_from_jax`` instead.)"""
    _require_ported(cfg)
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
    if cfg.arch_kind == "hybrid":
        # heterogeneous layers: a list, as in the reference
        params["layers"] = [_init_hybrid_layer(gen, cfg, l)
                            for l in range(cfg.n_layers)]
    else:
        params["layers"] = _init_stacked_layers(gen, cfg)
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _uniform_layer(cfg: ModelConfig, x: torch.Tensor, layer_p: Params,
                   window: Optional[int], positions: torch.Tensor,
                   cache: Optional[Params] = None,
                   cache_index: Optional[Index] = None
                   ) -> Tuple[torch.Tensor, Aux]:
    """One pre-norm decoder layer: (x, aux), aux the MoE load-balance
    loss (0.0 without experts); the cache (if any) updates in place."""
    h = rms_norm(x, layer_p["ln1"], cfg.norm_eps)
    if cfg.arch_kind == "rwkv":
        o, _ = time_mix(layer_p["tmix"], h, cfg,
                        state=cache["tmix"] if cache is not None else None)
        x = x + o
        h2 = rms_norm(x, layer_p["ln2"], cfg.norm_eps)
        o2, _ = channel_mix(layer_p["cmix"], h2,
                            state=cache["cmix"] if cache is not None
                            else None)
        return x + o2, 0.0
    if cache is not None and cfg.kv_quant:
        c_in = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
    elif cache is not None:
        c_in = (cache["k"], cache["v"])
    else:
        c_in = None
    x = x + attention(layer_p["attn"], h, cfg, positions, window=window,
                      cache=c_in, cache_index=cache_index)
    h2 = rms_norm(x, layer_p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        o2, aux = moe_ffn(layer_p["moe"], h2, cfg)
        return x + o2, aux
    return x + swiglu(layer_p["mlp"], h2, cfg), 0.0


def _hybrid_layer(cfg: ModelConfig, x: torch.Tensor, layer_p: Params,
                  positions: torch.Tensor, cache: Optional[Params] = None,
                  cache_index: Optional[Index] = None) -> torch.Tensor:
    """One Griffin layer (local attention or recurrent block, then the
    MLP); the cache (if any) updates in place.  The reference calls
    ``swiglu`` here without the config, so the hybrid MLP never takes
    ``fused_mlp``; the port does the same."""
    h = rms_norm(x, layer_p["ln1"], cfg.norm_eps)
    if "attn" in layer_p:
        o = attention(layer_p["attn"], h, cfg, positions,
                      window=cfg.local_window or None,
                      cache=None if cache is None else (cache["k"],
                                                        cache["v"]),
                      cache_index=cache_index)
    else:
        state = (cache["conv"], cache["h"]) if cache is not None else None
        o, _ = recurrent_block(layer_p["rec"], h, cfg, state=state)
    x = x + o
    h2 = rms_norm(x, layer_p["ln2"], cfg.norm_eps)
    return x + swiglu(layer_p["mlp"], h2)


def _layer_fns(params: Params, cfg: ModelConfig
               ) -> List[Callable[..., Tuple[torch.Tensor, Aux]]]:
    """One callable per layer: (x, positions, cache, index) -> (x, aux),
    aux the layer's MoE load-balance loss (0.0 without experts).  A
    global layer passes no window without a cache (as the reference's
    static windows do, so a long prefill takes window 0 in the chunked
    path or the flash kernel) and ``BIG_WINDOW`` with one."""
    if cfg.arch_kind == "hybrid":
        return [lambda x, pos, c, i, lp=lp: (
                    _hybrid_layer(cfg, x, lp, pos, c, i), 0.0)
                for lp in params["layers"]]
    fns = []
    for l, win in enumerate(layer_windows(cfg)):
        lp = _layer(params["layers"], l)
        fns.append(lambda x, pos, c, i, lp=lp, win=win: _uniform_layer(
            cfg, x, lp, None if (c is None and win >= BIG_WINDOW) else win,
            pos, c, i))
    return fns


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["unembed"]
    return _mask_pad_vocab(logits, cfg)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss): the mean over
    layers of the MoE load-balance loss, as in the reference (0 for the
    families without experts)."""
    _require_ported(cfg)
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for fn in _layer_fns(params, cfg):
        x, aux = fn(x, positions, None, None)
        aux_total = aux_total + aux
    return _logits(params, cfg, x), aux_total / max(1, cfg.n_layers)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=None, device: DeviceLike = None) -> Params:
    """The decode cache in the reference's layout: KV (layers first) for
    dense and moe; (last token, state) per mixer for rwkv; per-layer
    dictionaries with batch first for hybrid, whose local attention keeps
    a ring buffer of min(max_len, local_window) slots."""
    _require_ported(cfg)
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    L, hd = cfg.n_layers, cfg.hd
    if cfg.arch_kind == "rwkv":
        H = cfg.d_model // HEAD_SIZE
        return {"tmix": (zeros((L, batch, 1, cfg.d_model)),
                         zeros((L, batch, H, HEAD_SIZE, HEAD_SIZE),
                               torch.float32)),
                "cmix": zeros((L, batch, 1, cfg.d_model))}
    if cfg.arch_kind == "hybrid":
        caches: List[Params] = []
        for l in range(L):
            if _block_kind(cfg, l) == "attn":
                T = min(max_len, cfg.local_window or max_len)
                caches.append({"k": zeros((batch, T, cfg.n_kv_heads, hd)),
                               "v": zeros((batch, T, cfg.n_kv_heads, hd))})
            else:
                caches.append({
                    "conv": zeros((batch, cfg.conv1d_width - 1,
                                   cfg.rglru_dim)),
                    "h": zeros((batch, cfg.rglru_dim), torch.float32)})
        return {"layers": caches}
    shape = (L, batch, max_len, cfg.n_kv_heads, hd)
    if cfg.kv_quant:
        scale_shape = shape[:-1] + (1,)
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(scale_shape), "v_scale": zeros(scale_shape)}
    return {"k": zeros(shape), "v": zeros(shape)}


def zero_cache_slot(cfg: ModelConfig, cache: Params, slot: int) -> Params:
    """Clear one batch slot's rows across every array of a decode cache,
    in place.  Continuous-batching engines reuse decode slots; a refilled
    request must not attend to the previous occupant's keys/values (or
    carry its recurrent state).  The hybrid family keeps batch first in
    each layer's arrays; every other family stacks layers first."""
    _require_ported(cfg)
    for a in _leaves(cache):
        if cfg.arch_kind == "hybrid":
            a[slot] = 0
        else:
            a[:, slot] = 0
    return cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, index: Index) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); index: the cache fill cursor — an
    int (or 0-d tensor) when all rows decode in lockstep, or a per-slot
    (B,) tensor when a continuous-batching engine advances each slot
    independently.  The cache is written in place and returned."""
    _require_ported(cfg)
    B = tokens.shape[0]
    x = params["embed"][tokens]
    if isinstance(index, torch.Tensor) and index.ndim == 1:
        index = index.to(x.device)
        positions = index[:, None]
    else:
        index = int(index)
        positions = torch.full((B, 1), index, dtype=torch.long,
                               device=x.device)
    layer_caches: List[Any] = (
        cache["layers"] if cfg.arch_kind == "hybrid"
        else [_layer(cache, l) for l in range(cfg.n_layers)])
    for fn, c in zip(_layer_fns(params, cfg), layer_caches):
        x, _ = fn(x, positions, c, index)
    return _logits(params, cfg, x), cache
