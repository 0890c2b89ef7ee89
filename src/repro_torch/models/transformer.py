"""LM assembly for every family of the model zoo: init, forward, decode
cache, decode; the whisper encoder-decoder's encoder, forward and decode.

Port of ``repro.models.transformer``.  Uniform-layer families (dense,
moe, rwkv, vlm) stack per-layer parameters on a leading axis as in the
reference, and whisper stacks its encoder and decoder layers apart; the
hybrid (RecurrentGemma) family keeps a list of per-layer dictionaries,
since its layers differ.  The port walks the layers in a Python loop
(PyTorch runs eagerly, so there is no ``scan``).  ``remat=True`` (the
default, as in the reference) recomputes each layer in the backward pass
(``torch.utils.checkpoint``, per layer where the reference checkpoints
per pattern group); it applies only while grad mode is on, so every
forward under ``no_grad`` or ``inference_mode`` computes the same ops
either way.  A MoE
layer differs from a dense one only in its MLP (``layers.moe_ffn``);
``forward`` returns the mean of its layers' load-balance losses.  A vlm
(qwen2-vl) forward prefixes the text with projected patch embeddings and
rotates by M-RoPE; its decode is text-only with plain RoPE, as the
reference's.  The vision and audio frontends are stubs in the reference
too: patch and frame embeddings are inputs.

Entry points:
    init_model(cfg, seed, device)                    -> params
    forward(params, cfg, tokens, patch_embeds=None, remat=True)
                                                     -> (logits, aux)
    loss_fn(params, cfg, batch)                      -> scalar loss
    init_cache(cfg, batch, max_len, device)          -> cache
    decode_step(params, cfg, tokens, cache, index)   -> (logits, cache)
    encode_frames(params, cfg, frames)               -> enc      (encdec)
    whisper_forward(params, cfg, frames, tokens)     -> logits   (encdec)
    whisper_loss_fn(params, cfg, batch)              -> scalar   (encdec)
    whisper_decode_step(params, cfg, tokens, cache, index)
                                                     -> (logits, cache)

``decode_step``, ``whisper_decode_step`` and ``zero_cache_slot`` update
the cache tensors in place and return the same dictionary.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.hints import hint, local_call, write_slice
from repro_torch.runtime.telemetry import mark

from .common import (DeviceLike, ModelConfig, Params, cross_entropy_loss,
                     dense_init, resolve_device, rms_norm,
                     sinusoidal_positions)
from .layers import (Index, attention, cross_attention, gelu_mlp,
                     init_attention, init_cross_attention, init_gelu_mlp,
                     init_moe, init_swiglu, moe_ffn, swiglu)
from .rglru import init_recurrent_block, recurrent_block
from .rwkv6 import HEAD_SIZE, channel_mix, init_channel_mix, init_time_mix, \
    time_mix

BIG_WINDOW = 1 << 30   # "global" attention sentinel

#: a layer's load-balance loss: a 0-d float32 tensor, or 0.0 without experts
Aux = Union[torch.Tensor, float]


def _require_decoder(cfg: ModelConfig) -> None:
    """``forward`` and ``decode_step`` take the decoder-only families;
    the encoder-decoder runs through its own entry points."""
    if cfg.arch_kind == "encdec":
        raise ValueError(
            f"{cfg.name}: arch_kind='encdec' runs through encode_frames, "
            "whisper_forward and whisper_decode_step")


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Neutralize the padded embedding rows (softmax- and argmax-safe)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    # a fill value, not a tensor made from a Python number: that would be
    # a host-to-device copy, which a CUDA graph's capture refuses
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(ids >= cfg.vocab, -1e30)


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


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings ``table[tokens]``.  On a mesh each rank looks
    up its rows of tokens in the whole table (gathered over the model
    axis when it is vocab-sharded): DTensor's sharded gather fails in
    its backward on some releases, and the local gather's backward is
    the plain path's."""
    if isinstance(table, DTensor):
        rows = ("batch",) + (None,) * (tokens.ndim - 1)
        return local_call(lambda w, t: w[t], [table, tokens],
                          [(None, None), rows], [rows + (None,)])
    return table[tokens]


def _rows(o: torch.Tensor) -> torch.Tensor:
    """A residual branch's (B, S, D) output, on a mesh summed over the
    model axis and sharded by rows before it meets the residual stream
    (DTensor would otherwise carry the partial sum into the next norm)."""
    return hint(o, "batch", None, None)


def _block_kind(cfg: ModelConfig, l: int) -> str:
    return cfg.block_pattern[l % len(cfg.block_pattern)]


def _layer(tree, l: int):
    """Layer ``l``'s parameters or cache (views) from a stacked tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, l) for v in tree)
    return tree[l]


def _unstack(tree, n: int) -> List[Any]:
    """The ``n`` per-layer trees of a stacked parameter tree, as views
    (``torch.unbind`` along the layer axis, the same views as ``_layer``).
    Under autograd a leaf's per-layer gradients come back stacked in one
    tensor, where ``n`` selects would each give a full-size one."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][l] for k in tree} for l in range(n)]
    return list(torch.unbind(tree, 0))


def _apply(remat: bool) -> Callable[..., Any]:
    """How a forward calls a layer: ``fn(*args)``, or under ``remat``
    with grad mode on, through ``checkpoint`` (the layer's activations
    are dropped and recomputed in the backward pass)."""
    if remat and torch.is_grad_enabled():
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)
    return lambda fn, *args: fn(*args)


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


#: ``init_model``'s ``shard``: (leaf path, full leaf or one layer's slice
#: of a stacked leaf, whether it is such a slice) -> the part to keep
KeepFn = Callable[[Tuple[str, ...], torch.Tensor, bool], torch.Tensor]


def _keep(tree, path: Tuple[str, ...], shard: Optional[KeepFn],
          layer_slice: bool = False):
    """``tree`` with each leaf cut by ``shard`` (as it is without one)."""
    if shard is None:
        return tree
    if isinstance(tree, dict):
        return {k: _keep(v, path + (k,), shard, layer_slice)
                for k, v in tree.items()}
    return shard(path, tree, layer_slice)


def _init_stacked_layers(gen: torch.Generator, cfg: ModelConfig,
                         init_layer: Callable[[torch.Generator, ModelConfig],
                                              Params] = _init_decoder_layer,
                         n: Optional[int] = None,
                         shard: Optional[KeepFn] = None,
                         path: Tuple[str, ...] = ("layers",)) -> Params:
    """``n`` layers (``cfg.n_layers`` by default) drawn by ``init_layer``,
    stacked on a leading axis, drawn layer after layer in the reference's
    order.  Each stacked tensor is allocated once, and each layer's draws
    are copied into their slice (the part ``shard`` keeps, if given) and
    dropped before the next layer is drawn: the peak holds the weights
    (or their shards) and one layer's draws, not the weights twice."""
    n = cfg.n_layers if n is None else n
    layer = _keep(init_layer(gen, cfg), path, shard, True)
    stacked = _empty_stack(layer, n)
    for l in range(n):
        if l:
            layer = _keep(init_layer(gen, cfg), path, shard, True)
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
               device: DeviceLike = None,
               shard: Optional[KeepFn] = None) -> Params:
    """Random parameters in the reference's layout, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``.  (The draws differ
    from ``jax.random``'s; tests carry JAX parameters across with
    ``convert.params_from_jax`` instead.)

    ``shard``: every leaf is drawn in full, the same on every rank, and
    only what ``shard`` keeps of it is held (a stacked leaf layer by
    layer): ``distributed.sharding.init_sharded`` builds a mesh's
    parameters so."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    if cfg.arch_kind == "encdec":
        return _init_whisper(gen, cfg, shard)

    def keep(name, t):
        return _keep(t, (name,), shard)

    params: Params = {
        "embed": keep("embed", dense_init(
            gen, (cfg.padded_vocab, cfg.d_model), cfg.dtype, scale=0.02)),
        "ln_f": keep("ln_f", torch.zeros((cfg.d_model,), dtype=torch.float32,
                                         device=gen.device)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = keep("unembed", dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), cfg.dtype))
    if cfg.arch_kind == "vlm":
        params["patch_proj"] = keep("patch_proj", dense_init(
            gen, (cfg.d_model, cfg.d_model), cfg.dtype))
    if cfg.arch_kind == "hybrid":
        # heterogeneous layers: a list, as in the reference
        params["layers"] = [
            _keep(_init_hybrid_layer(gen, cfg, l), ("layers", str(l)), shard)
            for l in range(cfg.n_layers)]
    else:
        params["layers"] = _init_stacked_layers(gen, cfg, shard=shard)
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _uniform_layer(cfg: ModelConfig, x: torch.Tensor, layer_p: Params,
                   window: Optional[int], positions: torch.Tensor,
                   cache: Optional[Params] = None,
                   cache_index: Optional[Index] = None,
                   mrope_positions: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Aux]:
    """One pre-norm decoder layer: (x, aux), aux the MoE load-balance
    loss (0.0 without experts); the cache (if any) updates in place.
    ``mrope_positions`` (vlm forward) rotates q and k by M-RoPE.  Marks
    the ``mixer`` and ``ffn`` halves (``runtime.telemetry``)."""
    mark("mixer")
    x = hint(x, "batch", None, None)
    h = rms_norm(x, layer_p["ln1"], cfg.norm_eps)
    if cfg.arch_kind == "rwkv":
        o, _ = time_mix(layer_p["tmix"], h, cfg,
                        state=cache["tmix"] if cache is not None else None)
        x = x + _rows(o)
        mark("ffn")
        h2 = rms_norm(x, layer_p["ln2"], cfg.norm_eps)
        o2, _ = channel_mix(layer_p["cmix"], h2,
                            state=cache["cmix"] if cache is not None
                            else None)
        return x + _rows(o2), 0.0
    if cache is not None and cfg.kv_quant:
        c_in = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
    elif cache is not None:
        c_in = (cache["k"], cache["v"])
    else:
        c_in = None
    x = x + _rows(attention(layer_p["attn"], h, cfg, positions,
                            window=window, cache=c_in,
                            cache_index=cache_index,
                            mrope_positions=mrope_positions))
    mark("ffn")
    h2 = rms_norm(x, layer_p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        o2, aux = moe_ffn(layer_p["moe"], h2, cfg)
        return x + _rows(o2), aux
    return x + _rows(swiglu(layer_p["mlp"], h2, cfg)), 0.0


def _hybrid_layer(cfg: ModelConfig, x: torch.Tensor, layer_p: Params,
                  positions: torch.Tensor, cache: Optional[Params] = None,
                  cache_index: Optional[Index] = None) -> torch.Tensor:
    """One Griffin layer (local attention or recurrent block, then the
    MLP); the cache (if any) updates in place.  The reference calls
    ``swiglu`` here without the config, so the hybrid MLP never takes
    ``fused_mlp``; the port does the same.  Marks the ``mixer`` and
    ``ffn`` halves."""
    mark("mixer")
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
    x = x + _rows(o)
    mark("ffn")
    h2 = rms_norm(x, layer_p["ln2"], cfg.norm_eps)
    return x + _rows(swiglu(layer_p["mlp"], h2))


def _layer_fns(params: Params, cfg: ModelConfig
               ) -> List[Callable[..., Tuple[torch.Tensor, Aux]]]:
    """One callable per layer: (x, positions, cache, index, mrope=None)
    -> (x, aux), aux the layer's MoE load-balance loss (0.0 without
    experts), ``mrope`` the vlm forward's M-RoPE position ids.  A global
    layer passes no window without a cache (as the reference's static
    windows do, so a long prefill takes window 0 in the chunked path or
    the flash kernel) and ``BIG_WINDOW`` with one."""
    if cfg.arch_kind == "hybrid":
        return [lambda x, pos, c, i, mrope=None, lp=lp: (
                    _hybrid_layer(cfg, x, lp, pos, c, i), 0.0)
                for lp in params["layers"]]
    fns = []
    layers = _unstack(params["layers"], cfg.n_layers)
    for lp, win in zip(layers, layer_windows(cfg)):
        fns.append(lambda x, pos, c, i, mrope=None, lp=lp, win=win:
                   _uniform_layer(
                       cfg, x, lp,
                       None if (c is None and win >= BIG_WINDOW) else win,
                       pos, c, i, mrope))
    return fns


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["unembed"]
    return hint(_mask_pad_vocab(logits, cfg), "batch", None, "model")


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss): the mean over
    layers of the MoE load-balance loss, as in the reference (0 for the
    families without experts).  ``remat``: recompute each layer in the
    backward pass (only while grad mode is on; see the module docstring).

    vlm: ``patch_embeds`` (B, n_patches, D), cast to ``cfg.dtype`` and
    projected by ``patch_proj``, come before the text; every layer
    rotates by M-RoPE (``_vlm_positions``), and the logits are those of
    the last S_text positions.  The reference asserts the patches are
    given; the port raises."""
    _require_decoder(cfg)
    B, S_text = tokens.shape
    x = _embed(params["embed"], tokens)
    mrope = None
    if cfg.arch_kind == "vlm":
        want = (B, cfg.n_patches, cfg.d_model)
        got = None if patch_embeds is None else tuple(patch_embeds.shape)
        if got != want:
            raise ValueError(f"{cfg.name}: forward takes patch_embeds of "
                             f"shape {want}, got {got}")
        pe = patch_embeds.to(cfg.dtype) @ params["patch_proj"]
        x = torch.cat([pe, x], dim=1)
        mrope = _vlm_positions(cfg, B, S_text, x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    call = _apply(remat)
    for fn in _layer_fns(params, cfg):
        x, aux = call(fn, x, positions, None, None, mrope)
        aux_total = aux_total + aux
    # the LM head on the text positions only (the reference cuts its
    # logits back to them; each position's logits are its own)
    return (_logits(params, cfg, x[:, -S_text:]),
            aux_total / max(1, cfg.n_layers))


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The training loss of a decoder-only batch ({"tokens", "labels"}
    (B, S), and "patch_embeds" for the vlm): mean token cross-entropy
    with z-loss, plus 0.01 x the MoE load-balance loss."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          patch_embeds=batch.get("patch_embeds"))
    return cross_entropy_loss(logits, batch["labels"]) + 0.01 * aux


def _vlm_positions(cfg: ModelConfig, B: int, S_text: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """(B, n_patches + S_text, 3) M-RoPE (t, h, w) position ids: the
    image grid (0, row, column) with side floor(sqrt(P)), then the text
    run, every stream at side + s."""
    P = cfg.n_patches
    side = max(1, int(P ** 0.5))
    p = torch.arange(P, device=device)
    img = torch.stack([torch.zeros_like(p), p // side, p % side], dim=-1)
    tt = side + torch.arange(S_text, device=device)
    txt = torch.stack([tt, tt, tt], dim=-1)
    pos = torch.cat([img, txt], dim=0)                    # (P + S, 3)
    return pos[None].expand(B, P + S_text, 3)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=None, device: DeviceLike = None) -> Params:
    """The decode cache in the reference's layout: KV (layers first) for
    dense, moe, vlm and encdec (the decoder's self-attention; the caller
    adds the encoded frames as ``"enc"``, as ``decode_input_specs`` lays
    the cache out); (last token, state) per mixer for rwkv; per-layer
    dictionaries with batch first for hybrid, whose local attention keeps
    a ring buffer of min(max_len, local_window) slots."""
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
    for a in _leaves(cache):
        dim = 0 if cfg.arch_kind == "hybrid" else 1
        if isinstance(a, DTensor):
            write_slice(a, dim, slot, torch.zeros_like(a.narrow(dim, 0, 1)))
        elif dim == 0:
            a[slot] = 0
        else:
            a[:, slot] = 0
    return cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, index: Index) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); index: the cache fill cursor — an
    int (or 0-d tensor) when all rows decode in lockstep, or a per-slot
    (B,) tensor when a continuous-batching engine advances each slot
    independently.  The cache is written in place and returned.

    vlm: text only, with plain RoPE at the cache index, as the
    reference's decode (it takes no patches and passes no M-RoPE ids).

    Marks its sections (``runtime.telemetry.SECTIONS``): ``embed``, each
    layer's ``mixer`` and ``ffn``, ``head``."""
    _require_decoder(cfg)
    B = tokens.shape[0]
    mark("embed")
    x = _embed(params["embed"], tokens)
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
    for l, (fn, c) in enumerate(zip(_layer_fns(params, cfg),
                                    layer_caches)):
        x, _ = fn(x, positions, c, index)
        if cfg.arch_kind != "hybrid":
            _write_layer(cache, l, c)
    mark("head")
    return _logits(params, cfg, x), cache


def _write_layer(cache: Params, l: int, layer: Params) -> None:
    """Put layer ``l``'s cache back into the stacked DTensor leaves whose
    layer dim is split over the mesh: their slice was a gathered copy.
    (Elsewhere the slice is a view, already written.)"""
    for stacked, one in zip(_leaves(cache), _leaves(layer)):
        if _split_on(stacked, 0):
            write_slice(stacked, 0, l, one[None])


def _split_on(t: torch.Tensor, dim: int) -> bool:
    """Whether ``t`` is a DTensor sharded over some mesh dim on ``dim``."""
    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) and p.dim == dim for p in t.placements)


# ---------------------------------------------------------------------------
# whisper-style encoder-decoder (the conv frontend is a stub, as in the
# reference: frame embeddings are the input)
# ---------------------------------------------------------------------------

def _init_whisper_enc_layer(gen: torch.Generator, cfg: ModelConfig
                            ) -> Params:
    zeros = dict(dtype=torch.float32, device=gen.device)
    return {"ln1": torch.zeros((cfg.d_model,), **zeros),
            "attn": init_attention(gen, cfg),
            "ln2": torch.zeros((cfg.d_model,), **zeros),
            "mlp": init_gelu_mlp(gen, cfg)}


def _init_whisper_dec_layer(gen: torch.Generator, cfg: ModelConfig
                            ) -> Params:
    zeros = dict(dtype=torch.float32, device=gen.device)
    return {"ln1": torch.zeros((cfg.d_model,), **zeros),
            "attn": init_attention(gen, cfg),
            "ln_x": torch.zeros((cfg.d_model,), **zeros),
            "xattn": init_cross_attention(gen, cfg),
            "ln2": torch.zeros((cfg.d_model,), **zeros),
            "mlp": init_gelu_mlp(gen, cfg)}


def _init_whisper(gen: torch.Generator, cfg: ModelConfig,
                  shard: Optional[KeepFn] = None) -> Params:
    """The reference's tree: ``embed``, stacked ``enc_layers`` and
    ``dec_layers`` (each stacked tensor allocated once), ``ln_enc`` and
    ``ln_f``; the LM head is tied to ``embed``."""
    zeros = dict(dtype=torch.float32, device=gen.device)
    return {
        "embed": _keep(dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                  cfg.dtype, scale=0.02), ("embed",), shard),
        "enc_layers": _init_stacked_layers(gen, cfg, _init_whisper_enc_layer,
                                           cfg.n_enc_layers, shard,
                                           ("enc_layers",)),
        "dec_layers": _init_stacked_layers(gen, cfg, _init_whisper_dec_layer,
                                           cfg.n_layers, shard,
                                           ("dec_layers",)),
        "ln_enc": _keep(torch.zeros((cfg.d_model,), **zeros), ("ln_enc",),
                        shard),
        "ln_f": _keep(torch.zeros((cfg.d_model,), **zeros), ("ln_f",), shard),
    }


def _enc_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params,
               positions: torch.Tensor) -> torch.Tensor:
    """One encoder layer: self-attention over every frame (not causal, no
    RoPE), then the GELU MLP."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + _rows(attention(lp["attn"], h, cfg, positions, causal=False,
                            rope=False))
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _rows(gelu_mlp(lp["mlp"], h2))


def _dec_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params,
               positions: torch.Tensor, enc: torch.Tensor,
               cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               cache_index: Optional[int] = None) -> torch.Tensor:
    """One decoder layer: causal self-attention without RoPE (through the
    KV cache, in place, when one is given), cross-attention onto ``enc``,
    then the GELU MLP."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + _rows(attention(lp["attn"], h, cfg, positions, rope=False,
                            cache=cache, cache_index=cache_index))
    hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    x = x + _rows(cross_attention(lp["xattn"], hx, enc, cfg))
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _rows(gelu_mlp(lp["mlp"], h2))


def encode_frames(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                  remat: bool = True) -> torch.Tensor:
    """frames: (B, T_enc, D) precomputed embeddings (the stub frontend),
    cast to ``cfg.dtype`` before the sinusoids are added -> (B, T_enc, D)
    after ``ln_enc``.  ``remat`` as in ``forward``."""
    T = frames.shape[1]
    x = frames.to(cfg.dtype) + sinusoidal_positions(
        T, cfg.d_model, device=frames.device).to(cfg.dtype)
    positions = torch.arange(T, device=x.device)
    call = _apply(remat)
    for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
        x = call(_enc_layer, cfg, x, lp, positions)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def whisper_forward(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                    tokens: torch.Tensor, remat: bool = True
                    ) -> torch.Tensor:
    """Encoder over ``frames``, then the decoder over ``tokens`` (B, S)
    with position s's sinusoid added at s -> (B, S, padded_vocab) logits,
    tied to ``embed``, the padded rows masked.  ``remat`` as in
    ``forward``, for the encoder and the decoder."""
    enc = encode_frames(params, cfg, frames, remat)
    S = tokens.shape[1]
    x = _embed(params["embed"], tokens) + sinusoidal_positions(
        S, cfg.d_model, device=tokens.device).to(cfg.dtype)
    positions = torch.arange(S, device=x.device)
    call = _apply(remat)
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        x = call(_dec_layer, cfg, x, lp, positions, enc)
    return _logits(params, cfg, x)


def whisper_loss_fn(params: Params, cfg: ModelConfig,
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The encoder-decoder's training loss: mean token cross-entropy
    (with z-loss) of ``whisper_forward`` over {"frames", "tokens"}
    against "labels"."""
    logits = whisper_forward(params, cfg, batch["frames"], batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"])


def whisper_decode_step(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, cache: Params, index: Index
                        ) -> Tuple[torch.Tensor, Params]:
    """One decoder step.  tokens: (B, 1); cache: {"enc": (B, T_enc, D)
    encoded frames, "k"/"v": the self-attention cache of ``init_cache``},
    written in place and returned; index: the fill cursor, one scalar for
    every row.

    The embedding of position ``index`` is added, as ``whisper_forward``
    adds position s's at s.  The reference adds position 0's at every
    index (``sinusoidal_positions(1, D)``), so its decode departs from its
    forward from the second token on; the port's agrees with both
    forwards at every position."""
    index = int(index)
    B = tokens.shape[0]
    x = _embed(params["embed"], tokens) + sinusoidal_positions(
        1, cfg.d_model, start=index, device=tokens.device).to(cfg.dtype)
    positions = torch.full((B, 1), index, dtype=torch.long,
                           device=x.device)
    for l in range(cfg.n_layers):
        x = _dec_layer(cfg, x, _layer(params["dec_layers"], l), positions,
                       cache["enc"], (cache["k"][l], cache["v"][l]), index)
    return _logits(params, cfg, x), cache
