"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time mixing with
data-dependent decay, plus channel mixing.

Port of ``repro.models.rwkv6``.  Time mixing (per head, head size 64):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state: N x N)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

The reference's model path runs the recurrence as a ``lax.scan``; here
``time_mix`` hands it to ``kernels.rwkv6_scan.wkv6`` at every sequence
length (a prompt in prefill, T = 1 with the cached state in decode) when
``cfg.use_kernels`` is set, else to ``wkv6_blocks``, the plain form that
advances a block of steps per op (``wkv6_ref``, the step-by-step
recurrence, is the witness both are held to).
Given a ``state``, ``time_mix`` and ``channel_mix`` write the new state
into those tensors in place and return them.

On a mesh (DTensor inputs) the projections are tensor parallel, as
the parameters' shardings make them in the reference: ``time_mix``'s
token shift and low-rank lerp run on each rank's rows (their small
weights gathered), its five projections give each rank its columns,
the recurrence and the group norm run on each rank's heads (a local
region: DTensor has no rule for the recurrence), and ``w_o``'s rows are
summed over the model axis; ``channel_mix`` is a column- then
row-split product.  A state is written back in place whatever its
placements.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.hints import hint, local_call
from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_blocks

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
         log_w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
         use_kernels: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence in the model's layout.

    r, k, v, log_w (the log decays, <= 0): (B, S, H, N) float32; u: (H,
    N); s0: (B, H, N, N) or None.  The kernel takes the decays exp(log_w),
    the plain form the log decays themselves.  Returns y (B, S, H, N) and
    the last state (B, H, N, N)."""
    B, S, H, N = r.shape
    decay = torch.exp(log_w) if use_kernels else log_w
    # contiguous for the kernel: with B = 1 the reshape is a strided view
    rows = [t.transpose(1, 2).reshape(B * H, S, N).contiguous()
            for t in (r, k, v, decay)]
    uu = u.float()[None].expand(B, H, N).reshape(B * H, 1, N)
    s = None if s0 is None else s0.reshape(B * H, N, N)
    fn = wkv6 if use_kernels else wkv6_blocks
    y, s_last = fn(*rows, uu, s)
    return (y.reshape(B, H, S, N).transpose(1, 2),
            s_last.reshape(B, H, N, N))


def _time_mix_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, w: torch.Tensor,
                    decay_bias: torch.Tensor, bonus_u: torch.Tensor,
                    ln_x_scale: torch.Tensor, s0: Optional[torch.Tensor],
                    use_kernels: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``time_mix`` from its five projections (B, S, D) to the gated,
    group-normed output before ``w_o``, and the last state: per head, so
    that on a mesh each rank runs its own heads."""
    B, S, D = r.shape
    H, N = D // HEAD_SIZE, HEAD_SIZE
    g = torch.nn.functional.silu(g.float()).to(r.dtype)
    decay_raw = w.float() + decay_bias
    # log decays; the decays exp(-exp(decay_raw)) lie in (0, 1)
    log_w = (-torch.exp(decay_raw)).reshape(B, S, H, N)
    y, s_last = _wkv(r.reshape(B, S, H, N).float(),
                     k.reshape(B, S, H, N).float(),
                     v.reshape(B, S, H, N).float(), log_w, bonus_u, s0,
                     use_kernels)
    # per-head group norm (population variance, as jnp.var)
    mean = y.mean(-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    yh = (y - mean) * torch.rsqrt(var + 1e-5)
    return (yh.reshape(B, S, D) * ln_x_scale).to(r.dtype) * g, s_last


def _rows(t: torch.Tensor) -> Tuple[Optional[str], ...]:
    return ("batch",) + (None,) * (t.ndim - 1)


def time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
             state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """RWKV6 attention replacement.  state = (last_token, S)."""
    mesh = isinstance(x, DTensor)
    last = state[0] if state is not None else None
    if mesh:
        # the token shift and the low-rank lerp on each rank's rows
        def lerp(x, last, mu, lora_a, lora_b):
            return tuple(t.contiguous() for t in _ddlerp(
                {"mu": mu, "lora_a": lora_a, "lora_b": lora_b}, x,
                _token_shift(x, last)))
        streams = local_call(
            lerp, [x, last, p["mu"], p["lora_a"], p["lora_b"]],
            [_rows(x), None if last is None else _rows(last), (None, None),
             (None, None), (None, None, None)], [_rows(x)] * 5)
    else:
        streams = _ddlerp(p, x, _token_shift(x, last))
    xr, xk, xv, xw, xg = streams
    args = [xr @ p["w_r"], xk @ p["w_k"], xv @ p["w_v"], xg @ p["w_g"],
            xw @ p["w_decay"], p["decay_bias"], p["bonus_u"],
            p["ln_x_scale"], state[1] if state is not None else None]
    if mesh:
        # heads over the model axis: the projections' columns, the
        # recurrence and the group norm per head; w_o's rows summed
        width = ("batch", None, "model")
        heads = ("batch", "model", None, None)
        y, s_last = local_call(
            _time_mix_heads, args,
            [width] * 5 + [("model",), ("model", None), ("model",),
                           None if state is None else heads],
            [width, heads], use_kernels=cfg.use_kernels)
        out = hint(y @ p["w_o"], "batch", None, None)
    else:
        y, s_last = _time_mix_heads(*args, use_kernels=cfg.use_kernels)
        out = y @ p["w_o"]
    if state is None:
        return out, (x[:, -1:, :], s_last)
    state[0].copy_(x[:, -1:, :])
    state[1].copy_(s_last)
    return out, state


def channel_mix(p: Params, x: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV squared-relu FFN with token shift.  state = last token.  On
    a mesh ``w_k``'s and ``w_r``'s columns and ``w_v``'s rows split over
    the model axis, ``kv`` summed over it."""
    shifted = _token_shift(x, state)
    xk = x + (shifted - x) * p["mu_k"]
    k = xk @ p["w_k"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = hint(k @ p["w_v"], "batch", None, None)
    r = torch.sigmoid((x @ p["w_r"]).float()).to(x.dtype)
    out = hint(r * kv, "batch", None, None)
    if state is None:
        return out, x[:, -1:, :]
    state.copy_(x[:, -1:, :])
    return out, state
