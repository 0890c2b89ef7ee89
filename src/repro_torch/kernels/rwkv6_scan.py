"""WKV6 recurrence on Hopper (port of ``repro.kernels.rwkv6_scan``).

Per (batch x head) row, with head size N:

  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
  S_t = diag(w_t) S_{t-1} + k_t^T v_t,      S_{-1} = s0 (zero by default)

``wkv6`` launches the CUDA kernel in ``csrc/rwkv6_scan.cu`` in one of two
regimes, by ``choose_regime(T, N)``: ``"step"`` below ``CHUNK`` steps
(every decode call: one block per row, one step at a time) and
``"chunked"`` from ``CHUNK`` on (the reference's chunked form in chunks
of 16 steps with the decays as products, none above 1, one block per
row and slice of ``value_split(BH, N)`` value columns); the source's
header says what bounds each.  Unlike the reference kernel it takes a
starting state ``s0`` (the model's decode carries one) and any T (the
reference asserts ``T % chunk == 0``).

On a CPU tensor the wrapper computes the plain version ``wkv6_ref`` (the
sequential recurrence of ``repro.kernels.ref.wkv6_ref``, with ``s0``); on
a CUDA tensor it launches the kernel or raises.  ``wkv6.launches`` counts
launches.  ``wkv6_chunked_ref`` repeats the chunked kernel's arithmetic
in PyTorch, for the tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.distributed.hints import dtensor_local

from . import build

#: on a mesh each rank runs its (batch x head) rows: the recurrence is
#: independent from row to row
_ROWS = dtensor_local([("batch", None, None)] * 6, [("batch", None, None)] * 2)

#: head sizes the kernel is instantiated for (RWKV-6 uses 64)
HEAD_SIZES = (32, 64)
#: steps a chunk of the chunked regime (one m16 tile); shorter calls run
#: the step regime
CHUNK = 16
#: steps a sub-chunk: the kernel sums A's pairs inside one with their
#: decays, across them as the dot product of two factors
SUB = 4
#: value columns a chunked block may own (the kernel's instantiations)
VALUE_SPLITS = (8, 16, 32)
_REGIMES = {"step": 0, "chunked": 1}
#: steps a block of ``wkv6_blocks``: its scores' exponents take
#: BH T BLOCK N floats, and its carry two ops a block
BLOCK = 32
#: the least log decay ``wkv6_blocks`` takes: exp(-80) is 2e-35, a state
#: wiped as far as float32 sees, and sums of -80 keep their small
#: differences to about 1e-5
LOG_W_MIN = -80.0


def choose_regime(T: int, N: int) -> str:
    """The kernel regime of a call: ``"step"`` for T < ``CHUNK`` (decode),
    ``"chunked"`` from ``CHUNK`` steps on.  Raises for a head size the
    kernel does not take."""
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6 runs head sizes {HEAD_SIZES}, not N={N}")
    return "chunked" if T >= CHUNK else "step"


def value_split(BH: int, N: int, sms: int) -> int:
    """Value columns a block of the chunked regime owns on a card of
    ``sms`` streaming multiprocessors: the smallest of ``VALUE_SPLITS``
    whose grid of BH N / NV blocks fits one wave (a block of 512 threads
    takes one SM's registers), else the largest at most N.  A block
    recomputes its row's decays and A, so fewer, wider blocks repeat less
    of that work as long as the card stays full."""
    fits = [nv for nv in VALUE_SPLITS if nv <= N and BH * (N // nv) <= sms]
    return min(fits) if fits else max(nv for nv in VALUE_SPLITS if nv <= N)


@_ROWS
def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the recurrence step by step, in float32."""
    BH, T, N = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[:, 0, :, None]                        # (BH, N, 1)
    s = (torch.zeros((BH, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float().clone())
    ys = []
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]         # (BH, N, N)
        ys.append(torch.bmm(r[:, t, None, :], s + uu * kv)[:, 0])
        s = w[:, t, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None, chunk: int = CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's arithmetic in PyTorch, float32.  Per chunk,
    with the decays multiplied in order (none above 1, zeros exact): the
    prefix products P_t = prod_{s<t} w_s and y = (r P) S_in; the
    strictly-past scores A[t, tau] = sum_i r_t k_tau prod_{tau<s<t} w_s,
    inside a sub-chunk of ``SUB`` steps with the decays between, across
    sub-chunks as the dot product of r_t prod_{4a<=s<t} w_s and k_tau
    prod_{tau<s<4a} w_s (4a the start of t's sub-chunk); the bonus; and
    the state carried to the next chunk, P_end S + sum_tau k_tau
    prod_{s>tau} w_s v_tau.  A last chunk shorter than ``chunk`` takes
    only its own steps."""
    BH, T, N = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[:, 0, :]                              # (BH, N)
    s = (torch.zeros((BH, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float().clone())
    ys = []
    for t0 in range(0, T, chunk):
        rc, kc, vc, wc = (t[:, t0:t0 + chunk] for t in (r, k, v, w))
        n = rc.shape[1]
        ones = torch.ones_like(wc[:, 0])
        pre = [ones]                                     # prod_{s<t} w_s
        for t in range(n):
            pre.append(pre[-1] * wc[:, t])
        suf = [ones]                                     # prod_{t<s<n} w_s
        for t in range(n - 2, -1, -1):
            suf.insert(0, suf[0] * wc[:, t + 1])
        y = torch.bmm(rc * torch.stack(pre[:n], 1), s)
        a = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
        for t in range(n):
            start = t // SUB * SUB
            loc = ones
            for s_ in range(start, t):                   # prod_{4a<=s<t}
                loc = loc * wc[:, s_]
            sub = ones                                   # prod_{tau<s<4a}
            for tau in range(t - 1, -1, -1):
                if tau >= start:                         # inside
                    dec = ones
                    for s_ in range(tau + 1, t):
                        dec = dec * wc[:, s_]
                    a[:, t, tau] = (rc[:, t] * kc[:, tau] * dec).sum(-1)
                else:                                    # across
                    if tau < start - 1:
                        sub = sub * wc[:, tau + 1]
                    a[:, t, tau] = ((rc[:, t] * loc) * (kc[:, tau] * sub)
                                    ).sum(-1)
        y = y + torch.bmm(a, vc)
        y = y + (rc * uu[:, None, :] * kc).sum(-1, keepdim=True) * vc
        ys.append(y)
        s = (pre[n][:, :, None] * s
             + torch.bmm((kc * torch.stack(suf, 1)).transpose(1, 2), vc))
    return torch.cat(ys, dim=1), s


@_ROWS
def wkv6_blocks(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor,
                s0: Optional[torch.Tensor] = None, block: int = BLOCK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The models' plain path: the recurrence a block of ``block`` steps
    per op, in float32 (float64 inputs stay float64), differentiable.
    It takes the log decays ``log_w`` (<= 0; the model has them exactly,
    -exp of its decay projection), so that no gradient divides by a decay
    near 0.

    Per block, with lw = log w summed along the block inclusive (c_t) and
    exclusive (x_t), every decay is exp of a sum of lw: the scores
    A[t, tau] = sum_i r_ti k_taui exp(x_ti - c_taui) for tau < t, the
    exponent set to -inf on and above the diagonal before exp, so no
    exponent is positive; y = (r exp(x)) S_in + A v + (r u k) v, the
    bonus on the diagonal; the state carried to the next block, exp(c_end)
    S_in + sum_tau (k_tau exp(c_end - c_tau))^T v_tau.  Every op but the
    carry runs over all blocks at once; the carry is two ops a block.  A
    log decay below ``LOG_W_MIN`` (a decay of 0 included) counts as that
    bound, which keeps the sums finite.  A last block shorter than
    ``block`` is padded with steps of decay 1 and zero r, k, v.
    ``wkv6_ref`` on w = exp(log_w) is the step-by-step witness it is held
    to."""
    BH, T, N = r.shape
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    r, k, v = (t.to(dt) for t in (r, k, v))
    lw = torch.clamp(log_w.to(dt), min=LOG_W_MIN)
    L = min(block, T)
    nb = -(-T // L)
    if nb * L > T:
        pad = r.new_zeros((BH, nb * L - T, N))
        r, k, v, lw = (torch.cat([t, pad], 1) for t in (r, k, v, lw))
    rb, kb, vb, lw = (t.reshape(BH, nb, L, N) for t in (r, k, v, lw))
    c = torch.cumsum(lw, dim=2)                           # sum_{s<=t}
    x = torch.nn.functional.pad(c[:, :, :-1], (0, 0, 1, 0))  # sum_{s<t}
    past = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    expo = (x[:, :, :, None, :] - c[:, :, None, :, :]).masked_fill(
        ~past[:, :, None], float("-inf"))                 # (BH,nb,t,tau,N)
    a = ((rb[:, :, :, None, :] * kb[:, :, None, :, :])
         * torch.exp(expo)).sum(-1)                       # (BH, nb, L, L)
    # each block's own part of the state it hands on, and its decay
    kv = torch.matmul((kb * torch.exp(c[:, :, -1:] - c)).transpose(-1, -2),
                      vb)                                 # (BH, nb, N, N)
    decay = torch.exp(c[:, :, -1, :, None])               # (BH, nb, N, 1)
    s = (torch.zeros((BH, N, N), dtype=dt, device=r.device) if s0 is None
         else s0.to(dt))
    starts = []
    for kv_b, d_b in zip(kv.unbind(1), decay.unbind(1)):
        starts.append(s)
        s = d_b * s + kv_b
    y = (torch.matmul(rb * torch.exp(x), torch.stack(starts, 1))
         + torch.matmul(a, vb)
         + (rb * u.to(dt)[:, None] * kb).sum(-1, keepdim=True) * vb)
    return y.reshape(BH, nb * L, N)[:, :T], s


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("rwkv6_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wkv6_launch.restype = i
    lib.wkv6_error_string.argtypes = [i]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


@_ROWS
def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (BH, T, N); u: (BH, 1, N); s0: (BH, N, N) or None
    -> (y (BH, T, N), S_last (BH, N, N)), both float32."""
    if r.ndim != 3 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError("wkv6 takes r, k, v, w of one (BH, T, N) shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    BH, T, N = r.shape
    if tuple(u.shape) != (BH, 1, N):
        raise ValueError(f"u must be (BH, 1, N) = {(BH, 1, N)}, got "
                         f"{tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (BH, N, N):
        raise ValueError(f"s0 must be (BH, N, N) = {(BH, N, N)}, got "
                         f"{tuple(s0.shape)}")
    if T == 0:
        raise ValueError("wkv6 needs T >= 1")
    tensors = [t for t in (r, k, v, w, u, s0) if t is not None]
    if any(t.device != r.device for t in tensors):
        raise ValueError("wkv6 inputs must lie on one device")
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    build.refuse_grad("wkv6", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("wkv6 takes float32 inputs, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6 takes contiguous inputs")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6 runs head sizes {HEAD_SIZES}, not N={N}")
    regime = choose_regime(T, N)
    if regime == "chunked" and any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv6 takes r, k, v, w aligned to 16 bytes from "
                         f"T = {CHUNK} on")
    y, s_last = _launch(r, k, v, w, u, s0, regime)
    wkv6.launches += 1
    return y, s_last


wkv6.launches = 0


def _launch(r, k, v, w, u, s0, regime: str):
    """One launch of the kernel in ``regime`` on checked CUDA inputs; no
    launch count.  ``wkv6`` calls it, and ``chip_smoke.py`` times the step
    kernel on the chunked rows through it."""
    BH, T, N = r.shape
    nv = value_split(
        BH, N, torch.cuda.get_device_properties(r.device).multi_processor_count)
    y = torch.empty_like(r)
    s_last = torch.empty((BH, N, N), dtype=torch.float32, device=r.device)
    lib = _library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_last.data_ptr(), BH, T, N, _REGIMES[regime], nv,
            stream)
    if err != 0:
        raise RuntimeError(f"wkv6 {regime} launch failed: "
                           + lib.wkv6_error_string(err).decode())
    return y, s_last
