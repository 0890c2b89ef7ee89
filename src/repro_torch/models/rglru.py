"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU.

Port of ``repro.models.rglru``.  RG-LRU (arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)              recurrence gate
    i_t = sigmoid(W_x x_t + b_x)              input gate
    a_t = a ** (c * r_t),  a = sigmoid(lambda)  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``rg_lru`` (a prompt, or one decode token from the carried h) computes
a_t and b_t = sqrt(1 - a_t^2) i_t x_t as the reference does, then hands
h_t = a_t h_{t-1} + b_t to ``kernels.rglru_scan.rglru_chunked`` when
``use_kernels`` is set, else to ``rglru_doubling``, the plain form that
advances all of T in log2 T rounds (``rglru_ref``, the step-by-step
recurrence, is the witness both are held to).  Given a ``state``,
``recurrent_block`` writes the new state into those tensors in place and
returns them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.hints import hint
from repro_torch.kernels.rglru_scan import rglru_chunked, rglru_doubling

from .common import ModelConfig, Params, dense_init

_C = 8.0
#: decode state of one block: (conv_state (B, K-1, W), h (B, W) float32)
State = Tuple[torch.Tensor, torch.Tensor]


def init_recurrent_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, w = cfg.d_model, cfg.rglru_dim
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_x": dense_init(gen, (d, w), cfg.dtype),        # recurrence branch
        "w_y": dense_init(gen, (d, w), cfg.dtype),        # gate branch
        "conv_w": dense_init(gen, (cfg.conv1d_width, w), cfg.dtype,
                             scale=cfg.conv1d_width ** -0.5),
        "conv_b": torch.zeros((w,), dtype=cfg.dtype, device=gen.device),
        "rg_wa": dense_init(gen, (w, w), cfg.dtype),
        "rg_ba": torch.zeros((w,), **f32),
        "rg_wx": dense_init(gen, (w, w), cfg.dtype),
        "rg_bx": torch.zeros((w,), **f32),
        # lambda init so that a = sigmoid(lambda) in [0.9, 0.999]
        "rg_lambda": torch.linspace(2.2, 6.9, w, **f32),
        "w_out": dense_init(gen, (w, d), cfg.dtype),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B,S,W); w: (K,W); state: (B,K-1,W).
    Sums in ``x.dtype``, tap by tap, in the reference's order."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i]
    out = out + b
    return out.to(x.dtype), xp[:, -(K - 1):, :]


def _gates(p: Params, xf: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_t, b_t) of the recurrence from the float32 input ``xf``."""
    r = torch.sigmoid(xf @ p["rg_wa"].float() + p["rg_ba"])
    i = torch.sigmoid(xf @ p["rg_wx"].float() + p["rg_bx"])
    log_a = -_C * r * torch.nn.functional.softplus(p["rg_lambda"])
    a = torch.exp(log_a)                               # log(a_t) <= 0
    gated = i * xf
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                        min=1e-12))
    return a, multiplier * gated


def rg_lru(p: Params, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
           use_kernels: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,W) -> (y, h_last (B,W)).  The carry ``h0`` enters the
    recurrence as its start (the reference folds ``a_0 h0`` into ``b_0``:
    the same value)."""
    a, b = _gates(p, x.float())
    fn = rglru_chunked if use_kernels else rglru_doubling
    h, h_last = fn(a, b, None if h0 is None else h0.float())
    return h.to(x.dtype), h_last[:, 0, :]


def rg_lru_step(p: Params, x: torch.Tensor, h: torch.Tensor,
                use_kernels: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  x: (B,1,W); h: (B,W).  ``rg_lru`` at S = 1
    from h: the kernel's T = 1 with h0 = h."""
    return rg_lru(p, x, h, use_kernels)


def recurrent_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    state: Optional[State] = None
                    ) -> Tuple[torch.Tensor, State]:
    """Griffin recurrent block.  state = (conv_state, h) for decode.
    ``gate`` and ``u`` carry the reference's sharding hints (width over
    the model axis on a mesh)."""
    gate = torch.nn.functional.gelu((x @ p["w_y"]).float(),
                                    approximate="tanh").to(x.dtype)
    gate = hint(gate, "batch", None, "model")
    u = hint(x @ p["w_x"], "batch", None, "model")
    conv_state = state[0] if state is not None else None
    u, new_conv = _causal_conv1d(u, p["conv_w"], p["conv_b"], conv_state)
    y, h = rg_lru(p, u, state[1] if state is not None else None,
                  cfg.use_kernels)
    out = (y * gate) @ p["w_out"]
    if state is None:
        return out, (new_conv, h)
    state[0].copy_(new_conv)
    state[1].copy_(h)
    return out, state
