"""Attention (GQA / RoPE / KV cache) and the SwiGLU MLP.

Port of the dense-path layers of ``repro.models.layers``.  Activations
follow the reference's (batch, seq, ...) layout and its rounding points.
Decode takes a KV cache and a scalar or per-slot ``(B,)`` cache index and
writes the new keys/values into the cache tensors in place (the reference
returns updated copies; the cache is the caller's to own here).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.fused_mlp import mlp_block

from .common import ModelConfig, Params, apply_rope, dense_init

#: sequence length from which the reference's no-cache path switches to
#: chunked attention (``repro.models.layers.CHUNKED_ATTN_THRESHOLD``)
CHUNKED_ATTN_THRESHOLD = 8192

Index = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    hd = cfg.hd
    p: Params = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), cfg.dtype),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), cfg.dtype),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), cfg.dtype),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), cfg.dtype),
    }
    if cfg.qkv_bias:
        zeros = dict(dtype=cfg.dtype, device=gen.device)
        p["bq"] = torch.zeros((cfg.n_heads * hd,), **zeros)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), **zeros)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), **zeros)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B,S,H,hd) x (B,T,Hkv,hd) -> (B,S,H,hd); GQA via head grouping."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    q = q.reshape(B, S, k.shape[2], G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, hd)


def _place(cache: torch.Tensor, new: torch.Tensor, index: Index) -> None:
    """Write ``new`` (B, S, ...) into ``cache`` (B, T, ...) in place, at
    ``index`` (an int, or a (B,) tensor of per-row starts).  Starts are
    clamped to [0, T - S] as the reference's ``dynamic_update_slice``
    clamps them."""
    S, T = new.shape[1], cache.shape[1]
    new = new.to(cache.dtype)
    if isinstance(index, torch.Tensor):
        start = torch.clamp(index, 0, T - S)
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cols = start[:, None] + torch.arange(S, device=cache.device)
        cache[rows, cols] = new
    else:
        i = min(max(index, 0), T - S)
        cache[:, i:i + S] = new


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor,
              window: Optional[int] = None,
              cache: Optional[Tuple[torch.Tensor, ...]] = None,
              cache_index: Optional[Index] = None,
              ) -> torch.Tensor:
    """Causal self-attention.

    window: attend only to keys within ``window`` positions (None means
    unbounded).  cache: (k, v) of shape (B, T_max, Hkv, hd), or (k, v,
    k_scale, v_scale) with ``cfg.kv_quant``; it is updated in place.
    cache_index: first free slot — a scalar when every batch row fills in
    lockstep, or a per-row (B,) vector when rows advance independently
    (continuous batching: each decode slot carries its own cursor).
    """
    B, S, _ = x.shape
    if positions.ndim == 1:
        positions = positions[None, :].expand(B, S)
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        per_slot = (isinstance(cache_index, torch.Tensor)
                    and cache_index.ndim == 1)
        index: Index = (cache_index.to(x.device) if per_slot
                        else int(cache_index))
        if cfg.kv_quant:
            # int8 cache with per-vector scales: quantize the new slice,
            # dequantize the whole cache on read
            ck, cv, ks, vs = cache
            k_s = torch.amax(torch.abs(k), dim=-1, keepdim=True) / 127.0 + 1e-8
            v_s = torch.amax(torch.abs(v), dim=-1, keepdim=True) / 127.0 + 1e-8
            _place(ck, torch.round(k / k_s).to(torch.int8), index)
            _place(cv, torch.round(v / v_s).to(torch.int8), index)
            _place(ks, k_s, index)
            _place(vs, v_s, index)
            k = ck.to(x.dtype) * ks.to(x.dtype)
            v = cv.to(x.dtype) * vs.to(x.dtype)
        else:
            ck, cv = cache
            _place(ck, k, index)
            _place(cv, v, index)
            k, v = ck, cv
        T = k.shape[1]
        kpos = torch.arange(T, device=x.device)[None, None, :]   # (1,1,T)
        qpos = positions[:, :, None]                              # (B,S,1)
        mask = kpos <= qpos                                       # causal
        fill = index[:, None, None] if per_slot else index
        mask = mask & (kpos < (fill + S))
        if window is not None:
            mask = mask & (qpos - kpos < window)
    else:
        if S >= CHUNKED_ATTN_THRESHOLD:
            raise NotImplementedError(
                f"S={S} >= {CHUNKED_ATTN_THRESHOLD} takes the reference's "
                "chunked attention, which is not ported yet (ROADMAP.md)")
        i = torch.arange(S, device=x.device)[:, None]
        j = torch.arange(S, device=x.device)[None, :]
        mask = j <= i
        if window is not None:
            mask = mask & (i - j < window)
        mask = mask[None].expand(B, S, S)

    out = _sdpa(q, k, v, mask, cfg)
    return out.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {
        "w_gate": dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.dtype),
        "w_up": dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.dtype),
        "w_down": dense_init(gen, (cfg.d_ff, cfg.d_model), cfg.dtype),
    }


def swiglu(p: Params, x: torch.Tensor,
           cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    if cfg is not None and cfg.use_kernels:
        # PipeOrgan fine-grained pipelining: the (t, f) intermediate tile
        # stays in shared memory across the gate/up -> down product chain
        return mlp_block(x, p["w_gate"], p["w_up"], p["w_down"])
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]
