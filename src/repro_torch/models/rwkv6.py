"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time mixing with
data-dependent decay, plus channel mixing.

Port of ``repro.models.rwkv6``.  Time mixing (per head, head size 64):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state: N x N)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

The reference's model path runs the recurrence as a ``lax.scan``; here
``time_mix`` hands it to ``kernels.rwkv6_scan.wkv6`` at every sequence
length (a prompt in prefill, T = 1 with the cached state in decode) when
``cfg.use_kernels`` is set, else to its plain version ``wkv6_ref``.
Given a ``state``, ``time_mix`` and ``channel_mix`` write the new state
into those tensors in place and return them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_ref

from .common import ModelConfig, Params, dense_init

_LORA_RANK = 32
HEAD_SIZE = 64                                       # rwkv6 head size


def init_time_mix(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    heads = d // HEAD_SIZE
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "mu": torch.rand((5, d), generator=gen, **f32).to(cfg.dtype),
        "lora_a": dense_init(gen, (d, _LORA_RANK * 5), cfg.dtype),
        "lora_b": dense_init(gen, (5, _LORA_RANK, d), cfg.dtype),
        "w_r": dense_init(gen, (d, d), cfg.dtype),
        "w_k": dense_init(gen, (d, d), cfg.dtype),
        "w_v": dense_init(gen, (d, d), cfg.dtype),
        "w_g": dense_init(gen, (d, d), cfg.dtype),
        "w_o": dense_init(gen, (d, d), cfg.dtype),
        "w_decay": dense_init(gen, (d, d), cfg.dtype, scale=0.1 * d ** -0.5),
        "decay_bias": torch.full((d,), -4.0, **f32),
        "bonus_u": 0.5 * torch.rand((heads, HEAD_SIZE), generator=gen, **f32),
        "ln_x_scale": torch.ones((d,), **f32),       # group norm on output
    }


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((d,), 0.5, dtype=cfg.dtype, device=gen.device),
        "w_k": dense_init(gen, (d, f), cfg.dtype),
        "w_v": dense_init(gen, (f, d), cfg.dtype),
        "w_r": dense_init(gen, (d, d), cfg.dtype),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """shift(x)_t = x_{t-1}; ``last`` is the carry token for decode."""
    if last is None:
        last = torch.zeros_like(x[:, :1, :])
    return torch.cat([last, x[:, :-1, :]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, shifted: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    """Finch data-dependent lerp producing the 5 mixed streams."""
    delta = shifted - x
    lora_in = delta @ p["lora_a"]
    lora_in = torch.tanh(lora_in.float()).to(x.dtype)
    lora_in = lora_in.reshape(*lora_in.shape[:-1], 5, _LORA_RANK)
    adj = torch.einsum("bsir,ird->bsid", lora_in, p["lora_b"])
    mix = p["mu"][None, None] + adj                          # (B,S,5,D)
    streams = x[:, :, None, :] + delta[:, :, None, :] * mix
    return tuple(streams[:, :, i, :] for i in range(5))


def _wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
         use_kernels: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence in the model's layout.

    r, k, v, w: (B, S, H, N) float32; u: (H, N); s0: (B, H, N, N) or
    None.  Returns y (B, S, H, N) and the last state (B, H, N, N)."""
    B, S, H, N = r.shape
    # contiguous for the kernel: with B = 1 the reshape is a strided view
    rows = [t.transpose(1, 2).reshape(B * H, S, N).contiguous()
            for t in (r, k, v, w)]
    uu = u.float()[None].expand(B, H, N).reshape(B * H, 1, N)
    s = None if s0 is None else s0.reshape(B * H, N, N)
    fn = wkv6 if use_kernels else wkv6_ref
    y, s_last = fn(*rows, uu, s)
    return (y.reshape(B, H, S, N).transpose(1, 2),
            s_last.reshape(B, H, N, N))


def time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
             state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """RWKV6 attention replacement.  state = (last_token, S)."""
    B, S, D = x.shape
    H, N = D // HEAD_SIZE, HEAD_SIZE
    last = state[0] if state is not None else None
    shifted = _token_shift(x, last)
    xr, xk, xv, xw, xg = _ddlerp(p, x, shifted)

    r = (xr @ p["w_r"]).reshape(B, S, H, N)
    k = (xk @ p["w_k"]).reshape(B, S, H, N)
    v = (xv @ p["w_v"]).reshape(B, S, H, N)
    g = torch.nn.functional.silu((xg @ p["w_g"]).float()).to(x.dtype)
    decay_raw = (xw @ p["w_decay"]).float() + p["decay_bias"]
    w = torch.exp(-torch.exp(decay_raw)).reshape(B, S, H, N)  # in (0,1)

    y, s_last = _wkv(r.float(), k.float(), v.float(), w, p["bonus_u"],
                     state[1] if state is not None else None,
                     cfg.use_kernels)
    # per-head group norm (population variance, as jnp.var)
    mean = y.mean(-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    yh = (y - mean) * torch.rsqrt(var + 1e-5)
    y = (yh.reshape(B, S, D) * p["ln_x_scale"]).to(x.dtype) * g
    out = y @ p["w_o"]
    if state is None:
        return out, (x[:, -1:, :], s_last)
    state[0].copy_(x[:, -1:, :])
    state[1].copy_(s_last)
    return out, state


def channel_mix(p: Params, x: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV squared-relu FFN with token shift.  state = last token."""
    shifted = _token_shift(x, state)
    xk = x + (shifted - x) * p["mu_k"]
    k = xk @ p["w_k"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = k @ p["w_v"]
    r = torch.sigmoid((x @ p["w_r"]).float()).to(x.dtype)
    if state is None:
        return r * kv, x[:, -1:, :]
    state.copy_(x[:, -1:, :])
    return r * kv, state
