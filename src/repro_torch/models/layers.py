"""Attention (GQA / RoPE / M-RoPE / sliding window / KV cache), cross-
attention, the SwiGLU and GELU MLPs and the top-k mixture of experts.

Port of ``repro.models.layers``.  Activations follow the reference's
(batch, seq, ...) layout and its rounding points.  Decode takes a KV
cache and a scalar or per-slot ``(B,)`` cache index and writes the new
keys/values into the cache tensors in place (the reference returns
updated copies; the cache is the caller's to own here).  A one-token
decode reads its cache as a ring buffer, which is what local attention
keeps (see ``attention``).

Without a cache (prefill, ``forward``, the whisper encoder and every
cross-attention) attention takes, under ``cfg.use_kernels``, the
hand-written flash-attention kernel
(``kernels.flash_attention.attention_op``) at any length, causal or not;
otherwise the reference's einsum path, chunked from
``CHUNKED_ATTN_THRESHOLD`` on when causal.  A one-token decode takes,
under ``cfg.use_kernels``, the hand-written decode kernel
(``kernels.decode_attention.decode_attention_op``), which reads the
cache in place.  The experts' products and the
GELU MLP are plain products, as in the reference, which has no kernel
for them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed.hints import (axis_sizes, current_mesh, hint,
                                           local_call, write_slice)
from repro_torch.kernels.decode_attention import (decode_attention_op,
                                                  ring_mask)
from repro_torch.kernels.flash_attention import attention_op
from repro_torch.kernels.fused_mlp import mlp_block

from .common import ModelConfig, Params, apply_mrope, apply_rope, dense_init

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


def _model_size() -> int:
    mesh = current_mesh()
    return axis_sizes(mesh).get("model", 1) if mesh is not None else 1


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    m = _model_size()
    return (_heads(q, cfg.n_heads, hd, cfg.n_heads % m == 0),
            _heads(k, cfg.n_kv_heads, hd, cfg.n_kv_heads % m == 0),
            _heads(v, cfg.n_kv_heads, hd, cfg.n_kv_heads % m == 0))


def _heads(t: torch.Tensor, n: int, hd: int, tp: bool) -> torch.Tensor:
    """(B, S, n hd) -> (B, S, n, hd), on a mesh hinted heads over the
    model axis when ``tp`` (the n heads divide it), else gathered.  The
    reference hints the flat n hd dim and lets GSPMD reshard; DTensor
    cannot split a sharded dim into heads that do not divide the axis,
    so the head count decides."""
    B, S, _ = t.shape
    t = hint(t, "batch", None, "model" if tp else None)
    return t.reshape(B, S, n, hd)


#: attention's layouts on a mesh (``_by_heads``, ``_sdpa_keys``,
#: ``_sdpa_chunked``): each rank its rows (batch over the data axes) and
#: its heads, or every head, or its block of the sequence.  DTensor has
#: no rule for the grouped einsum's merged (batch x head) dims or for a
#: softmax over a sharded dim, so attention's core is a local region.
_HEADS = ("batch", None, "model", None)
_ROWS = ("batch", None, None, None)
_SEQ = ("batch", "model", None, None)


def _merge(out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H hd).  On a mesh whose model axis the H
    heads do not divide, a local region: the gradient reaches the flat
    dim sharded like the next product's rows, and DTensor cannot view
    that back into the heads."""
    if isinstance(out, DTensor) and out.shape[2] % _model_size():
        return local_call(lambda t: t.flatten(2), [out], [_ROWS],
                          [("batch", None, None)])
    return out.flatten(2)


def _q_heads(H: int, Hkv: int, m: int) -> bool:
    """Whether the q heads split over a model axis of m ranks with each
    rank's heads in one GQA group (the kv heads do not divide m)."""
    return H % m == 0 and (H // Hkv) % (H // m) == 0


def _by_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              extra, extra_axes, **kwargs) -> torch.Tensor:
    """``fn(q, k, v, *extra, **kwargs)`` on each rank's rows and heads:
    every head split over the model axis where the kv heads divide it;
    else the q heads, each rank reading the one kv head of its GQA group
    (the reference's scores, hinted over the q heads); else every head on
    every rank."""
    mesh = current_mesh() or q.device_mesh
    m = axis_sizes(mesh).get("model", 1)
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv % m == 0 or not _q_heads(H, Hkv, m):
        axes = _HEADS if Hkv % m == 0 else _ROWS
        return local_call(fn, [q, k, v, *extra], [axes] * 3 + extra_axes,
                          [axes], **kwargs)
    first = mesh.get_local_rank("model") * (H // m) // (H // Hkv)

    def group(q, k, v, *extra, **kwargs):
        return fn(q, k[:, :, first:first + 1].contiguous(),
                  v[:, :, first:first + 1].contiguous(), *extra, **kwargs)

    return local_call(group, [q, k, v, *extra],
                      [_HEADS, _ROWS, _ROWS] + extra_axes, [_HEADS], **kwargs)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B,S,H,hd) x (B,T,Hkv,hd) -> (B,S,H,hd); GQA via head grouping.
    On a mesh, a local region per rank: by heads (``_by_heads``), or by
    keys (``_sdpa_keys``) where neither the kv heads nor the q heads
    split, or where the keys already lie split over their sequence (a
    decode cache)."""
    if isinstance(q, DTensor):
        m = _model_size()
        H, T, Hkv = q.shape[2], k.shape[1], k.shape[2]
        seq_cache = isinstance(k, DTensor) and any(
            p == Shard(1) for p in k.placements)
        if Hkv % m and T % m == 0 and (seq_cache or not _q_heads(H, Hkv, m)):
            return _sdpa_keys(q, k, v, mask, cfg)
        return _by_heads(_sdpa, q, k, v, [mask], [("batch", None, None)],
                         cfg=cfg)
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    q = q.reshape(B, S, k.shape[2], G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, hd)


def _softmax_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_sdpa`` over a block of the keys, unnormalised: the weights
    exp(score - row max) times v (B, S, H, hd), the row max and the sum
    of the weights (B, S, H), each with a leading dim of 1."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, S, Hkv, H // Hkv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    top = scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores - top)
    num = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)

    def rows(t):                                   # (B,Hkv,G,S) -> (B,S,H)
        return t.permute(0, 3, 1, 2).reshape(B, S, H)[None]

    return (num.reshape(B, S, H, hd)[None], rows(top[..., 0]),
            rows(w.sum(dim=-1)))


def _sdpa_keys(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``_sdpa`` on a mesh with the keys split over the model axis (the
    reference's fallback, its scores hinted over the key sequence): each
    rank the softmax's parts over its keys (``_softmax_parts``), combined
    by the ranks' largest row max.  The result is the softmax's to
    rounding; the max only steadies the exponentials, so its gradient is
    not taken."""
    part = ("model", "batch", None, None)
    num, top, den = local_call(
        _softmax_parts, [q, k, v, mask],
        [_ROWS, _SEQ, _SEQ, ("batch", None, "model")],
        [part + (None,), part, part], cfg=cfg)
    w = torch.exp(top - top.amax(dim=0).detach())
    out = (num * w[..., None]).sum(dim=0) / (den * w).sum(dim=0)[..., None]
    return hint(out.to(v.dtype), *_ROWS)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig, window: int, chunk: int = 512,
                  first_row: int = 0) -> torch.Tensor:
    """Chunked causal attention without an S x T score matrix (port of
    the reference's ``_sdpa_chunked``, the einsum counterpart of the
    flash kernel).  Query chunks run in order; a local layer slices only
    the ``window + chunk`` keys a chunk can see.  window <= 0 means
    unbounded.  Rounding as in ``_sdpa``: scores in the working type,
    then fp32 for the softmax, weights cast to v's type.  ``first_row``:
    the position of q's first row among the keys'.

    On a mesh, a local region per rank: by heads (``_by_heads``) where
    the kv heads or the q heads split; else each rank its block of the
    query rows against every key.  (The reference hints a chunk's scores
    over its key slice; a chunk's slice follows its rows, so the port
    splits the rows, with the same work a rank.)"""
    if isinstance(q, DTensor):
        m = _model_size()
        H, S, Hkv = q.shape[2], q.shape[1], k.shape[2]
        if Hkv % m and not _q_heads(H, Hkv, m) and S % m == 0:
            first = current_mesh().get_local_rank("model") * (S // m)
            return local_call(_sdpa_chunked, [q, k, v],
                              [_SEQ, _ROWS, _ROWS], [_SEQ], cfg=cfg,
                              window=window, chunk=chunk, first_row=first)
        return _by_heads(_sdpa_chunked, q, k, v, [], [], cfg=cfg,
                         window=window, chunk=chunk)
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    while chunk > 64 and S % chunk != 0:   # e.g. VLM seq = text + patches
        chunk //= 2
    if S % chunk != 0:
        chunk = next((c for c in range(min(chunk, S), 0, -1)
                      if S % c == 0), S)
    w_eff = window if window and 0 < window < T else T
    ksz = min(T, w_eff + chunk)
    outs = []
    for q0 in range(first_row, first_row + S, chunk):
        k0 = min(max(q0 + chunk - ksz, 0), T - ksz)
        qg = q[:, q0 - first_row:q0 - first_row + chunk].reshape(
            B, chunk, Hkv, G, hd)
        kc, vc = k[:, k0:k0 + ksz], v[:, k0:k0 + ksz]
        qpos = q0 + torch.arange(chunk, device=q.device)[:, None]
        kpos = k0 + torch.arange(ksz, device=q.device)[None, :]
        mask = (kpos <= qpos) & (qpos - kpos < w_eff)
        sc = torch.einsum("bskgh,btkh->bkgst", qg, kc).float()
        sc = sc / math.sqrt(hd)
        sc = torch.where(mask, sc, -1e30)
        w = torch.softmax(sc, dim=-1).to(v.dtype)
        oc = torch.einsum("bkgst,btkh->bskgh", w, vc)
        outs.append(oc.reshape(B, chunk, H, hd))
    return torch.cat(outs, dim=1)


def _place(cache: torch.Tensor, new: torch.Tensor, index: Index) -> None:
    """Write ``new`` (B, S, ...) into ``cache`` (B, T, ...) in place, at
    ``index`` (an int, or a (B,) tensor of per-row starts).  Starts are
    clamped to [0, T - S] as the reference's ``dynamic_update_slice``
    clamps them.  On a mesh each rank writes into its shard of the cache
    (``write_slice``); per-row starts are a single device's (the serving
    engine's)."""
    S, T = new.shape[1], cache.shape[1]
    new = new.to(cache.dtype)
    if isinstance(cache, DTensor):
        if isinstance(index, torch.Tensor):
            raise NotImplementedError("per-row cache starts on a mesh")
        write_slice(cache, 1, min(max(index, 0), T - S), new)
        return
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
              causal: bool = True,
              mrope_positions: Optional[torch.Tensor] = None,
              rope: bool = True,
              ) -> torch.Tensor:
    """Self-attention.

    window: attend only to keys within ``window`` positions (None means
    unbounded).  cache: (k, v) of shape (B, T_max, Hkv, hd), or (k, v,
    k_scale, v_scale) with ``cfg.kv_quant``; it is updated in place.
    cache_index: first free slot — a scalar when every batch row fills in
    lockstep, or a per-row (B,) vector when rows advance independently
    (continuous batching: each decode slot carries its own cursor).
    causal: without a cache, False admits every key (the whisper
    encoder); a cache is always read causally, as in the reference.
    mrope_positions: (B, S, 3) M-RoPE position ids, which replace
    ``positions`` for the rotation (qwen2-vl's forward); rope=False
    skips the rotation (whisper).

    One token per row (S = 1) without ``kv_quant`` is written at
    ``cache_index mod T_max``, and the mask reads each slot at the real
    position it holds (RoPE was applied at write time with that
    position).  While the index is below T_max this is the linear
    cache's write and mask bit for bit; past it, the cache is the ring
    buffer that local attention keeps (T_max = window).  The reference
    masks a ring buffer as if it were linear, which admits the wrong keys
    once it wraps (``ROADMAP.md``, Queue 3).

    Without a cache, ``cfg.use_kernels`` sends q, k and v to the flash
    kernel at any S, with ``causal`` as given; otherwise a causal
    S >= ``CHUNKED_ATTN_THRESHOLD`` takes ``_sdpa_chunked`` (window 0 on
    global layers), as in the reference.  The one-token decode without
    ``kv_quant`` takes, under ``cfg.use_kernels``, the decode kernel
    (``kernels.decode_attention.decode_attention_op``), which reads each
    row's admitted slots of the cache in place at the row's own position;
    without ``use_kernels``, and on a mesh (q a ``DTensor``), it stays on
    ``_sdpa`` over the ring mask, which computes the kernel's plain
    version.  The int8 ``kv_quant`` cache always takes ``_sdpa``.
    """
    B, S, _ = x.shape
    if positions.ndim == 1:
        positions = positions[None, :].expand(B, S)
    q, k, v = _qkv(p, x, cfg)
    if rope and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
    elif rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        per_slot = (isinstance(cache_index, torch.Tensor)
                    and cache_index.ndim == 1)
        index: Index = (cache_index.to(x.device) if per_slot
                        else int(cache_index))
        if S == 1 and not cfg.kv_quant:
            ck, cv = cache
            T = ck.shape[1]
            slot = torch.remainder(index, T) if per_slot else index % T
            _place(ck, k, slot)
            _place(cv, v, slot)
            w = T if window is None else window
            if cfg.use_kernels and not isinstance(q, DTensor):
                out = decode_attention_op(q, ck, cv, positions.contiguous(),
                                          w)
            else:
                out = _sdpa(q, ck, cv, ring_mask(positions, T, w), cfg)
            return _merge(out) @ p["wo"]
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
        if cfg.use_kernels:
            # the flash kernel: q tile, running max and sum and the fp32
            # accumulator stay on chip across the kv sweep
            out = (_by_heads(attention_op, q, k, v, [], [], causal=causal,
                             window=window or 0)
                   if isinstance(q, DTensor) else
                   attention_op(q, k, v, causal=causal, window=window or 0))
            return _merge(out) @ p["wo"]
        if causal and S >= CHUNKED_ATTN_THRESHOLD:
            out = _sdpa_chunked(q, k, v, cfg, window or 0)
            return _merge(out) @ p["wo"]
        i = torch.arange(S, device=x.device)[:, None]
        j = torch.arange(S, device=x.device)[None, :]
        mask = (j <= i if causal
                else torch.ones((S, S), dtype=torch.bool, device=x.device))
        if window is not None:
            mask = mask & (i - j < window)
        mask = mask[None].expand(B, S, S)

    out = _sdpa(q, k, v, mask, cfg)
    return _merge(out) @ p["wo"]


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return init_attention(gen, cfg)


def cross_attention(p: Params, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention onto the encoder's output: x (B, S, D),
    enc (B, T, D); no mask, no RoPE, no bias, no cache.  The reference
    computes it with plain ``_sdpa``; under ``cfg.use_kernels`` the port
    sends it to the flash kernel, not causal, as every attention without
    a cache (S = 1 in decode, T = ``cfg.enc_frames``)."""
    B, S, _ = x.shape
    T = enc.shape[1]
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (enc @ p["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = (enc @ p["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.use_kernels:
        out = attention_op(q, k, v, causal=False)
    else:
        mask = torch.ones((B, S, T), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
    return _merge(out) @ p["wo"]


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
    h = hint(h, "batch", None, "model")
    return hint(h @ p["w_down"], "batch", None, None)


def init_gelu_mlp(gen: torch.Generator, cfg: ModelConfig) -> Params:
    zeros = dict(dtype=cfg.dtype, device=gen.device)
    return {
        "w_in": dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.dtype),
        "b_in": torch.zeros((cfg.d_ff,), **zeros),
        "w_out": dense_init(gen, (cfg.d_ff, cfg.d_model), cfg.dtype),
        "b_out": torch.zeros((cfg.d_model,), **zeros),
    }


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP, at the reference's rounding points: the products
    and bias adds in the activation dtype, GELU in float32 in its tanh
    form (``jax.nn.gelu``'s default ``approximate=True``).  The reference
    has no kernel for it, so neither has the port."""
    h = x @ p["w_in"] + p["b_in"]
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    h = hint(h, "batch", None, "model")
    return h @ p["w_out"] + p["b_out"]


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-based)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The reference's draws, in its order.  ``dense_init`` takes its
    fan-in from ``shape[0]``, which for the (E, D, F) expert weights is
    E: they are scaled by E ** -0.5, as in the reference."""
    E = cfg.n_experts
    return {
        "router": dense_init(gen, (cfg.d_model, E), torch.float32),
        "w_gate": dense_init(gen, (E, cfg.d_model, cfg.d_ff), cfg.dtype),
        "w_up": dense_init(gen, (E, cfg.d_model, cfg.d_ff), cfg.dtype),
        "w_down": dense_init(gen, (E, cfg.d_ff, cfg.d_model), cfg.dtype),
    }


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots per expert and sample: the reference's formula, rounded up
    to a multiple of 8 and at least 8."""
    c = int(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def moe_route(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 router: (probs (B, S, E), gates (B, S, K) renormalised
    to sum to 1, expert ids (B, S, K)), the top k in descending order."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def moe_dispatch(idx: torch.Tensor, E: int, C: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample capacity dispatch, as the reference's ``route_one``: a
    stable sort of the sample's flattened (token, k) expert ids puts each
    expert's entries in token order; an entry's slot is its rank among
    its expert's entries, and ranks at or past C are dropped.

    Returns ``tok1`` (B, E, C), the token + 1 in each buffer slot (0 where
    empty), and ``slot`` (B, S, K), each (token, k)'s slot in its
    expert's buffer, C where it was dropped."""
    B, S, K = idx.shape
    se, order = torch.sort(idx.reshape(B, S * K), dim=-1, stable=True)
    experts = torch.arange(E, dtype=se.dtype, device=se.device)
    start = torch.searchsorted(se, experts.expand(B, E).contiguous(),
                               side="left")
    rank = (torch.arange(S * K, device=se.device)
            - torch.gather(start, 1, se))
    valid = rank < C
    slot_sorted = torch.where(valid, rank, C)
    # dropped entries all land in column C, which is cut away
    tok1 = torch.zeros((B, E * (C + 1)), dtype=torch.long, device=se.device)
    tok1.scatter_(1, se * (C + 1) + slot_sorted,
                  torch.where(valid, order // K + 1, 0))
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    return tok1.reshape(B, E, C + 1)[:, :, :C], slot.reshape(B, S, K)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-routed MoE (port of the reference's ``moe_ffn``).
    Returns (output, Switch load-balance loss E sum_e mean_prob_e load_e).

    Each sample fills an (E, C) buffer of token ids (``moe_dispatch``);
    the three expert products run over every expert's buffer, silu in
    float32.  The reference scales each slot's output by its gate and
    scatter-adds the slots back to their tokens in the activation dtype,
    so a token's contributions arrive in ascending expert order, each add
    rounded.  The port gathers them through the inverse map instead (each
    (token, k)'s slot, or dropped), scales each by its gate and sums them
    in that order, with no atomics: two calls on the same inputs give the
    same bits on the card too."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if isinstance(x, DTensor):
        return _moe_ffn_dtensor(p, x, cfg)
    probs, gate, idx = moe_route(p, x, cfg)

    me = probs.mean(dim=(0, 1))
    ce = _expert_counts(idx, E) / (B * S * K)
    aux = E * torch.sum(me * ce)
    return _moe_experts(p, x, cfg, gate, idx), aux


def _expert_counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) float32 count of each expert id in ``idx`` (``bincount``'s,
    with a shape that does not depend on the data)."""
    flat = idx.reshape(-1)
    return torch.zeros(E, dtype=torch.long, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float()


def _moe_gather(x: torch.Tensor, idx: torch.Tensor, C: int, E: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch of ``moe_ffn``: each expert's (C, D) buffer of its tokens
    (zeros in empty slots), (B, E, C, D), and each (token, k)'s slot."""
    tok1, slot = moe_dispatch(idx, E, C)
    rows = torch.arange(x.shape[0], device=x.device)
    xe = (x[rows[:, None, None], torch.clamp(tok1 - 1, min=0)]
          * (tok1 > 0)[..., None].to(x.dtype))
    return xe, slot


def _moe_products(xe: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The experts' three products over their buffers, silu in float32."""
    g = torch.einsum("becd,edf->becf", xe, w_gate)
    u = torch.einsum("becd,edf->becf", xe, w_up)
    h = torch.nn.functional.silu(g.float()).to(xe.dtype) * u
    return torch.einsum("becf,efd->becd", h, w_down)


def _moe_combine(ye: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """Each token's kept contributions, scaled by their gates (the
    reference's product of a slot's output and its gate in the activation
    dtype), summed in ascending expert order."""
    B, E, C, D = ye.shape
    K = idx.shape[-1]
    rows = torch.arange(B, device=ye.device)
    idx_s, perm = torch.sort(idx, dim=-1)
    slot_s = torch.gather(slot, -1, perm)
    gate_s = torch.gather(gate, -1, perm).to(ye.dtype)
    flat = idx_s * C + torch.clamp(slot_s, max=C - 1)        # (B, S, K)
    contrib = (ye.reshape(B, E * C, D)[rows[:, None, None], flat]
               * gate_s[..., None])
    contrib = torch.where((slot_s < C)[..., None], contrib, 0.0)
    y = contrib[:, :, 0]
    for k in range(1, K):
        y = y + contrib[:, :, k]
    return y


def _moe_experts(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 gate: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dispatch, the experts' products and the combine of ``moe_ffn``."""
    xe, slot = _moe_gather(x, idx, moe_capacity(cfg, x.shape[1]),
                           cfg.n_experts)
    ye = _moe_products(xe, p["w_gate"], p["w_up"], p["w_down"])
    return _moe_combine(ye, gate, idx, slot)


def _moe_ffn_dtensor(p: Params, x: DTensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` on a mesh.  DTensor has no sharding rule for the
    routing's sort, scatter and bincount or the combine's gather, so
    each rank routes, dispatches and combines its own rows (batch over
    the data axes) in local regions, the small router replicated.  The
    expert products run with the experts split over the model axis (the
    reference's EP, its ``xe`` hinted over "model"): each rank takes its
    experts' buffers and weights, and the combine gathers the experts'
    outputs over the model axis.  Where E does not divide that axis,
    every rank runs every expert.  The load-balance loss is formed from
    the ranks' summed probabilities and counts, so it is the global
    batch's."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S)

    def route(x, router):
        probs, gate, idx = moe_route({"router": router}, x, cfg)
        xe, slot = _moe_gather(x, idx, C, E)
        return (xe, gate, idx, slot, probs.sum(dim=(0, 1)),
                _expert_counts(idx, E))

    rows = ("batch", None, None)
    buffers = ("batch", None, None, None)
    xe, gate, idx, slot, psum, counts = local_call(
        route, [x, p["router"]], [rows, (None, None)],
        [buffers, rows, rows, rows, (None,), (None,)])
    experts = ("model", None, None)
    ye = local_call(_moe_products,
                    [xe, p["w_gate"], p["w_up"], p["w_down"]],
                    [("batch", "model", None, None)] + [experts] * 3,
                    [("batch", "model", None, None)])
    y = local_call(_moe_combine, [ye, gate, idx, slot],
                   [buffers, rows, rows, rows], [rows])
    aux = E * torch.sum((psum / (B * S)) * (counts / (B * S * K)))
    return hint(y, "batch", None, None), aux
