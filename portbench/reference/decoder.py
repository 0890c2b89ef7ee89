"""The plain reference: a dense decoder with grouped-query attention, in
float32, written from the published description of Qwen2 and Phi-3.

Per layer: RMSNorm, q/k/v projections (with biases where the
configuration has them), rotary embeddings on q and k (the half-split
form of both models), causal softmax attention in which query head h
reads key/value head h // (heads / kv_heads), the output projection, a
residual add; RMSNorm, the SwiGLU MLP (silu(x Wg) * (x Wu)) Wd, a
residual add.  Then a final RMSNorm and the LM head (the embedding's
rows where the configuration ties them).  An RMSNorm's gain is 1 plus
the stored offset.

It reads the benchmark's weights (``families/dense.py``) one layer at a
time, cast to float32 there, so that a reference of a 14 B model fits
beside its bf16 weights; with TF32 off, since TF32 would round the
products below float32.  It imports nothing of the program under test.

``quant="fp8"`` is the control: every linear layer's weight and input
rounded to float8 e4m3 with one scale a tensor, as an fp8 engine would
compute them, the rest as above.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

#: the largest finite values of the two fp8 formats
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def spec_from_config(conf: Dict) -> Dict:
    """The shapes the reference needs, from a ``configs/<name>.json``."""
    p, d = conf["published"], conf["derived"]
    return {"layers": p["num_hidden_layers"], "d_model": p["hidden_size"],
            "heads": p["num_attention_heads"],
            "kv_heads": p["num_key_value_heads"],
            "head_dim": d["head_dim"], "d_ff": p["intermediate_size"],
            "vocab": p["vocab_size"], "rope_theta": p["rope_theta"],
            "eps": p["rms_norm_eps"], "qkv_bias": d["qkv_bias"],
            "tied": p["tie_word_embeddings"]}


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """Float32 products in float32: TF32 off for the block."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to fp8 (e4m3, or e5m2) under one scale (its largest
    magnitude to the format's largest), back in float32."""
    scale = t.abs().amax().clamp(min=1e-12) / FP8_MAX[dtype]
    return (t / scale).to(dtype).to(torch.float32) * scale


def _linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
            ) -> torch.Tensor:
    if quant == "fp8":
        return fp8(x) @ w
    return x @ w


def _rms(x: torch.Tensor, offset: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + offset.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, n, hd) at positions 0 .. S - 1, angles in float64."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer_weights(w: Dict, l: int, quant: Optional[str]) -> Dict:
    names = ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"]
    out = {n: w[n][l].float() for n in names}
    if quant == "fp8":
        out = {n: fp8(t) for n, t in out.items()}
    for n in ("bq", "bk", "bv", "norm1", "norm2"):
        if n in w:
            out[n] = w[n][l].float()
    return out


def _attention(h: torch.Tensor, lw: Dict, spec: Dict,
               quant: Optional[str]) -> torch.Tensor:
    S = h.shape[0]
    H, Hkv, hd = spec["heads"], spec["kv_heads"], spec["head_dim"]
    q = _linear(h, lw["wq"], quant)
    k = _linear(h, lw["wk"], quant)
    v = _linear(h, lw["wv"], quant)
    if spec["qkv_bias"]:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = _rope(q.view(S, H, hd), spec["rope_theta"])
    k = _rope(k.view(S, Hkv, hd), spec["rope_theta"])
    v = v.view(S, Hkv, hd)
    group = H // Hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hst,thd->shd", scores.softmax(-1), v)
    return _linear(out.reshape(S, H * hd), lw["wo"], quant)


def _mlp(h: torch.Tensor, lw: Dict, quant: Optional[str]) -> torch.Tensor:
    g = _linear(h, lw["w_gate"], quant)
    u = _linear(h, lw["w_up"], quant)
    return _linear(torch.nn.functional.silu(g) * u, lw["w_down"], quant)


def hidden_states(w: Dict, spec: Dict, seqs: Sequence[torch.Tensor],
                  quant: Optional[str] = None) -> List[torch.Tensor]:
    """Each sequence's (S, D) float32 states after the final norm, every
    sequence through a layer before the next layer is cast."""
    xs = [w["embed"][s.to(w["embed"].device)].float() for s in seqs]
    for l in range(spec["layers"]):
        lw = _layer_weights(w, l, quant)
        for i, x in enumerate(xs):
            x = x + _attention(_rms(x, lw["norm1"], spec["eps"]), lw, spec,
                               quant)
            xs[i] = x + _mlp(_rms(x, lw["norm2"], spec["eps"]), lw, quant)
        del lw
    return [_rms(x, w["norm_f"], spec["eps"]) for x in xs]


def head_weight(w: Dict, spec: Dict, quant: Optional[str]) -> torch.Tensor:
    """The LM head's (D, V) float32 weight, the published vocab only."""
    V = spec["vocab"]
    head = (w["embed"][:V].float().t() if spec["tied"]
            else w["unembed"][:, :V].float())
    return fp8(head) if quant == "fp8" else head


def logits(w: Dict, spec: Dict, seqs: Sequence[torch.Tensor],
           rows: Sequence[torch.Tensor], quant: Optional[str] = None
           ) -> List[torch.Tensor]:
    """(len(rows[i]), V) float32 logits of sequence i at positions
    ``rows[i]``."""
    with exact_float32():
        hs = hidden_states(w, spec, seqs, quant)
        head = head_weight(w, spec, quant)
        out = [_linear(h[r.to(h.device)], head, quant)
               for h, r in zip(hs, rows)]
    return out


def served_gaps(w: Dict, spec: Dict,
                served: Sequence[Tuple[Sequence[int], Sequence[int]]],
                control: bool = False) -> Dict[str, List[float]]:
    """For each (prompt, output) a model served, the gap by which each
    served token's logit lies below the reference's best at that
    position (0 where they agree).  With ``control``, also the gap of the
    token that the fp8 control puts first at the same positions."""
    device = w["embed"].device
    seqs, rows, toks = [], [], []
    for prompt, output in served:
        full = list(prompt) + list(output)
        seqs.append(torch.tensor(full[:-1], dtype=torch.long, device=device))
        first = len(prompt) - 1
        rows.append(torch.arange(first, first + len(output), device=device))
        toks.append(torch.tensor(list(output), dtype=torch.long,
                                 device=device))
    ref = logits(w, spec, seqs, rows)
    gaps = [float(g) for lg, t in zip(ref, toks)
            for g in (lg.amax(-1) - lg.gather(-1, t[:, None])[:, 0]).tolist()]
    out = {"gaps": gaps}
    if control:
        low = logits(w, spec, seqs, rows, quant="fp8")
        out["control_gaps"] = [
            float(g) for lg, lo in zip(ref, low)
            for g in (lg.amax(-1) - lg.gather(-1, lo.argmax(-1)[:, None])[:, 0]
                      ).tolist()]
    return out
