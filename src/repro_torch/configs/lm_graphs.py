"""LM zoo -> planner graphs: decode-step and bucketed-prefill lowering.

Every registered architecture (``configs.ARCHS``) lowers to a
``core.Graph`` the PipeOrgan planner can solve: one op per GEMM-shaped
projection, ``OpKind.ATTEND`` for the token mixer (attention against a
KV cache, or a recurrent scan with ``S=1`` state reach), ``OpKind.ADD``
for residual joins and elementwise gates.  Norms, RoPE and embedding
gathers are not ops in this IR — they are bandwidth-trivial next to the
projections and the state sweep, and the planner's cost model has no
kind for them.

Two serving shapes per arch, emitted as distinct ``PlanRequest``s:

* ``decode_graph``  — one decode step: every token-parallel dim is the
  decode batch, the mixer sweeps the resident state (KV cache length
  ``context``, window-clipped for local-attention layers).
* ``prefill_graph`` — one prefill chunk of ``seq`` tokens (bucketed:
  serving engines pad prompts up to a bucket and reuse its plan); for
  the enc-dec arch this is the encoder pass over its fixed frame count.

The layer stacks are deliberately *structurally periodic* — the same
block repeated ``n_layers`` times (module ``local/global`` patterns
repeat with their own period) — which is exactly what the planner's
periodicity folding exploits (docs/planner.md): cold-planning cost is
near-O(unique structure), not O(layers).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core import Graph, Op, PlanRequest, add, attend, gemm

from . import ARCHS, get_config
from repro_torch.models.common import ModelConfig

#: decode-step batch (concurrent sequences) and resident context length.
DECODE_BATCH = 8
DECODE_CONTEXT = 4096

#: prefill chunk buckets (tokens); prompts pad up to a bucket so a
#: fleet serves every prompt length from a handful of plans.
PREFILL_BUCKETS = (1024, 4096)
PREFILL_BATCH = 1


def _mixer_span(cfg: ModelConfig, layer: int, context: int) -> int:
    """State length the layer-``layer`` attention sweeps: the full
    context, or the sliding window on local layers (gemma3's
    ``global_every``-periodic local/global pattern)."""
    if cfg.local_window <= 0:
        return context
    if cfg.global_every > 0 and (layer + 1) % cfg.global_every == 0:
        return context
    return min(context, cfg.local_window)


class _Wire:
    """Append-only op list with unique-name bookkeeping."""

    def __init__(self) -> None:
        self.ops: List[Op] = []

    def emit(self, op: Op) -> str:
        self.ops.append(op)
        return op.name


def _attention(w: _Wire, cfg: ModelConfig, tag: str, x: str, tokens: int,
               span: int, kv_streams: Optional[int] = None,
               q_only: bool = False) -> str:
    """Self- (or, with ``q_only``, cross-) attention over ``tokens`` new
    tokens against a resident state of ``span`` positions."""
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = nh * hd if q_only else (nh + 2 * nkv) * hd
    q = w.emit(gemm(f"{tag}.qkv", tokens, proj, cfg.d_model, inputs=(x,)))
    mix = w.emit(attend(f"{tag}.attend", tokens * nh, 1, hd, s=span,
                        g=(kv_streams if kv_streams is not None
                           else tokens) * nkv, inputs=(q,)))
    return w.emit(gemm(f"{tag}.out", tokens, cfg.d_model, nh * hd,
                       inputs=(mix,)))


def _recurrent_mix(w: _Wire, cfg: ModelConfig, tag: str, x: str,
                   tokens: int, width: int, heads: int = 1,
                   state_len: int = 1) -> str:
    """RG-LRU / RWKV-style token mix: project in, run the stateful scan
    (``ATTEND`` with state reach ``state_len`` — one resident vector per
    stream for a diagonal LRU, an hd-deep matrix per head for RWKV's
    outer-product state), project out."""
    hd = width // heads
    xin = w.emit(gemm(f"{tag}.in", tokens, 2 * width, cfg.d_model,
                      inputs=(x,)))
    mix = w.emit(attend(f"{tag}.scan", tokens * heads, 1, hd, s=state_len,
                        g=tokens * heads, inputs=(xin,)))
    return w.emit(gemm(f"{tag}.out", tokens, cfg.d_model, width,
                       inputs=(mix,)))


def _gated_mlp(w: _Wire, cfg: ModelConfig, tag: str, x: str,
               tokens: int) -> str:
    """SwiGLU/GeGLU: up & gate branches fork from ``x`` and join at the
    elementwise product — a series-parallel region the planner may
    co-place."""
    up = w.emit(gemm(f"{tag}.up", tokens, cfg.d_ff, cfg.d_model,
                     inputs=(x,)))
    gate = w.emit(gemm(f"{tag}.gate", tokens, cfg.d_ff, cfg.d_model,
                       inputs=(x,)))
    mul = w.emit(add(f"{tag}.mul", tokens, 1, 1, cfg.d_ff,
                     inputs=(up, gate)))
    return w.emit(gemm(f"{tag}.down", tokens, cfg.d_model, cfg.d_ff,
                       inputs=(mul,)))


def _plain_mlp(w: _Wire, cfg: ModelConfig, tag: str, x: str,
               tokens: int) -> str:
    up = w.emit(gemm(f"{tag}.up", tokens, cfg.d_ff, cfg.d_model,
                     inputs=(x,)))
    return w.emit(gemm(f"{tag}.down", tokens, cfg.d_model, cfg.d_ff,
                       inputs=(up,)))


def _moe_mlp(w: _Wire, cfg: ModelConfig, tag: str, x: str,
             tokens: int) -> str:
    """Routed MoE FFN: the router and each of the ``top_k`` active
    experts fork from ``x`` and join at the weighted combine — one wide
    series-parallel region per layer (the dominant fold win: unfolded,
    the planner re-prices this region's whole org x staging enumeration
    for every layer)."""
    router = w.emit(gemm(f"{tag}.router", tokens, cfg.n_experts,
                         cfg.d_model, inputs=(x,)))
    tails = [router]
    for e in range(cfg.top_k):
        up = w.emit(gemm(f"{tag}.e{e}.up", tokens, cfg.d_ff, cfg.d_model,
                         inputs=(x,)))
        tails.append(w.emit(gemm(f"{tag}.e{e}.down", tokens, cfg.d_model,
                                 cfg.d_ff, inputs=(up,))))
    return w.emit(add(f"{tag}.combine", tokens, 1, 1, cfg.d_model,
                      inputs=tuple(tails)))


def _block(w: _Wire, cfg: ModelConfig, tag: str, x: str, tokens: int,
           mixer: str, span: int, kv_streams: Optional[int] = None) -> str:
    """One transformer block: token mixer + residual, FFN + residual."""
    if mixer == "attn":
        mixed = _attention(w, cfg, f"{tag}.attn", x, tokens, span,
                           kv_streams=kv_streams)
    elif mixer == "rglru":
        mixed = _recurrent_mix(w, cfg, f"{tag}.rglru", x, tokens,
                               cfg.rglru_dim or cfg.d_model)
    elif mixer == "rwkv":
        hd = cfg.d_model // cfg.n_heads
        mixed = _recurrent_mix(w, cfg, f"{tag}.wkv", x, tokens,
                               cfg.d_model, heads=cfg.n_heads,
                               state_len=hd)
    else:
        raise ValueError(mixer)
    r1 = w.emit(add(f"{tag}.r1", tokens, 1, 1, cfg.d_model,
                    inputs=(mixed, x)))
    if cfg.arch_kind == "moe":
        ff = _moe_mlp(w, cfg, f"{tag}.moe", r1, tokens)
    elif cfg.arch_kind in ("encdec", "rwkv"):
        ff = _plain_mlp(w, cfg, f"{tag}.mlp", r1, tokens)
    else:
        ff = _gated_mlp(w, cfg, f"{tag}.mlp", r1, tokens)
    return w.emit(add(f"{tag}.r2", tokens, 1, 1, cfg.d_model,
                      inputs=(ff, r1)))


def _layer_mixer(cfg: ModelConfig, layer: int) -> str:
    if cfg.arch_kind == "hybrid" and cfg.block_pattern:
        return cfg.block_pattern[layer % len(cfg.block_pattern)]
    if cfg.arch_kind == "rwkv":
        return "rwkv"
    return "attn"


def decode_graph(cfg: ModelConfig, batch: int = DECODE_BATCH,
                 context: int = DECODE_CONTEXT) -> Graph:
    """One decode step: ``batch`` concurrent streams, one new token each,
    mixing against a ``context``-deep resident state; unembed included
    (the decode step's single largest GEMM)."""
    w = _Wire()
    x = w.emit(gemm("embed", batch, cfg.d_model, cfg.d_model))
    for layer in range(cfg.n_layers):
        tag = f"l{layer}"
        mixer = _layer_mixer(cfg, layer)
        span = _mixer_span(cfg, layer, context) if mixer == "attn" else 1
        x = _block(w, cfg, tag, x, batch, mixer, span)
        if cfg.arch_kind == "encdec":
            # decoder-only serve step: every layer also cross-attends the
            # encoder output (fixed enc_frames keys, one shared stream)
            ca = _attention(w, cfg, f"{tag}.xattn", x, batch,
                            cfg.enc_frames, kv_streams=1, q_only=True)
            x = w.emit(add(f"{tag}.r3", batch, 1, 1, cfg.d_model,
                           inputs=(ca, x)))
    w.emit(gemm("unembed", batch, cfg.padded_vocab, cfg.d_model,
                inputs=(x,)))
    return Graph(f"{cfg.name}-decode", w.ops)


def prefill_graph(cfg: ModelConfig, batch: int = PREFILL_BATCH,
                  seq: int = PREFILL_BUCKETS[0]) -> Graph:
    """One prefill chunk: ``batch * seq`` tokens flow through every
    projection; attention sweeps the chunk itself (window-clipped on
    local layers).  For the enc-dec arch this is the encoder pass, whose
    token count is the fixed ``enc_frames`` (``seq`` is ignored)."""
    if cfg.arch_kind == "encdec":
        tokens, context = cfg.enc_frames, cfg.enc_frames
        name = f"{cfg.name}-prefill-enc{cfg.enc_frames}"
    else:
        tokens, context = batch * seq, seq
        name = f"{cfg.name}-prefill-{seq}"
    w = _Wire()
    x = w.emit(gemm("embed", tokens, cfg.d_model, cfg.d_model))
    for layer in range(cfg.n_layers if cfg.arch_kind != "encdec"
                       else cfg.n_enc_layers):
        mixer = _layer_mixer(cfg, layer)
        span = _mixer_span(cfg, layer, context) if mixer == "attn" else 1
        x = _block(w, cfg, f"l{layer}", x, tokens, mixer, span,
                   kv_streams=batch if mixer == "attn" else None)
    return Graph(name, w.ops)


def lm_graphs(smoke: bool = False) -> Dict[str, Graph]:
    """Every (arch x serving shape) graph, keyed by graph name."""
    out: Dict[str, Graph] = {}
    for arch_id in ARCHS:
        cfg = get_config(arch_id, smoke=smoke)
        g = decode_graph(cfg)
        out[g.name] = g
        buckets: Iterable[int] = ((PREFILL_BUCKETS[0],)
                                  if cfg.arch_kind == "encdec"
                                  else PREFILL_BUCKETS)
        for seq in buckets:
            g = prefill_graph(cfg, seq=seq)
            out[g.name] = g
    return out


def lm_plan_requests(smoke: bool = False,
                     **request_kwargs) -> List[PlanRequest]:
    """One ``PlanRequest`` per LM graph (decode + each prefill bucket),
    ready for ``Planner.plan`` / the golden suite.  ``request_kwargs``
    override any ``PlanRequest`` field (hw, topology, objective, ...)."""
    return [PlanRequest(graph=g, **request_kwargs)
            for _, g in sorted(lm_graphs(smoke=smoke).items())]


__all__ = ["DECODE_BATCH", "DECODE_CONTEXT", "PREFILL_BATCH",
           "PREFILL_BUCKETS", "decode_graph", "prefill_graph",
           "lm_graphs", "lm_plan_requests"]
