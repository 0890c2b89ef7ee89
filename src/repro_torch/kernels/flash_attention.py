"""Flash attention on Hopper (port of ``repro.kernels.flash_attention``).

Online-softmax attention with causal and sliding-window masks: the CUDA
kernel in ``csrc/flash_attention.cu`` keeps the query tile, the running
max and sum and the fp32 accumulator on chip for the whole kv sweep and
visits only the kv tiles the masks can admit; the source's header says
what bounds it.  ``choose_regime`` names its regime from the dtype and
head size: bfloat16 runs QK^T and PV on the tensor cores with fp32
accumulation (``wgmma`` from hd = 64, ``mma.sync`` below), float32 on
the CUDA cores in fp32.  Two entry points share the kernel:

* ``flash_attention(q, k, v, causal=, window=)`` in the reference's
  layout, q (BH, S, hd) and k/v (BH, T, hd);
* ``attention_op(q, k, v, causal=, window=)`` in the model's layout,
  q (B, S, H, hd) and k/v (B, T, Hkv, hd), GQA by head-group indexing
  (kv head ``h // (H // Hkv)``): k and v are never repeated in memory.

Masks: key j is admitted for query i when ``j <= i`` (causal) and
``i - j < window`` (window > 0; window <= 0 is unbounded); masked scores
are the finite ``NEG_INF``, as in the reference, and scores are scaled by
``hd ** -0.5``.  Unlike the reference kernel both take any S and T and
``T != S``.

On CPU tensors the wrappers compute the plain versions ``attention_ref``
and ``attention_op_ref`` (the reference's ``ref.attention_ref`` in fp32,
and its GQA form); on CUDA tensors they launch the kernel or raise.
``flash_attention.launches`` counts the launches of both entry points.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed.hints import dtensor_local

from . import build

#: the reference kernel's masked score (``flash_attention.py:23``)
NEG_INF = -1e30

#: head sizes one launch takes
HEAD_SIZES = (16, 32, 64, 128, 256)

#: kernel regime codes of ``flash_attention_launch``
_REGIMES = {"cuda_cores": 0, "mma": 1, "wgmma": 2}

#: the smallest head size of the ``wgmma`` regime (one 128-byte row)
WGMMA_MIN_HD = 64


def choose_regime(dtype: torch.dtype, hd: int) -> str:
    """The kernel regime of a call: for bfloat16 the tensor cores,
    ``"wgmma"`` from ``WGMMA_MIN_HD`` and ``"mma"`` (``mma.sync``) below;
    ``"cuda_cores"`` for float32 (fp32 products: TF32 would leave the
    reference's 3e-4).  Raises for another dtype or a head size the
    kernel does not take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes float32 or bfloat16, not "
                        f"{dtype}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"head size {hd} is not one of the kernel's "
                         f"{', '.join(map(str, HEAD_SIZES))}")
    if dtype == torch.float32:
        return "cuda_cores"
    return "wgmma" if hd >= WGMMA_MIN_HD else "mma"


def _mask(S: int, T: int, causal: bool, window: int,
          device) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= (i - j) < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version, q (BH, S, hd) and k/v (BH, T, hd) -> (BH, S, hd) in
    q's dtype: scores, softmax and the PV product in fp32."""
    S, T = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    s = torch.where(_mask(S, T, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def attention_op_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version in the model's layout, q (B, S, H, hd) and k/v
    (B, T, Hkv, hd) -> (B, S, H, hd): ``attention_ref`` with query head h
    reading kv head ``h // (H // Hkv)``."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, Hkv, H // Hkv, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * hd ** -0.5
    s = torch.where(_mask(S, T, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll, i, i,
        ctypes.c_float, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> None:
    """Device, grad mode, dtype, contiguity and alignment checks of a
    CUDA call."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    build.refuse_grad(name, q, k, v)
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise TypeError(f"{name} takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in (q, k, v)]}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name} takes contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} takes inputs aligned to 16 bytes")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            batch: int, heads: int, group: int, S: int, T: int, hd: int,
            q_strides, k_strides, causal: bool,
            window: int) -> torch.Tensor:
    regime = choose_regime(q.dtype, hd)
    if regime == "cuda_cores" and (batch > 65535 or heads > 65535):
        raise ValueError(f"batch {batch} or heads {heads} exceeds one "
                         "launch's 65535")
    lib = _library()
    if window > S:
        window = S                 # i - j < S holds for every key
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _REGIMES[regime], batch, heads, group, S, T, hd, *q_strides,
            *k_strides, int(causal), int(window), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (BH, S, hd); k/v: (BH, T, hd) -> (BH, S, hd) in q's dtype.
    window <= 0 means unbounded."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (BH, S, hd) and k, v "
                         f"(BH, T, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, hd = q.shape
    T = k.shape[1]
    if k.shape[0] != BH or k.shape[2] != hd or S == 0 or T == 0:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} "
                         "disagree in BH or hd, or are empty")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention inputs must lie on one device")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    _check("flash_attention", q, k, v)
    return _launch(q, k, v, batch=BH, heads=1, group=1, S=S, T=T, hd=hd,
                   q_strides=(S * hd, 0, hd), k_strides=(T * hd, 0, hd),
                   causal=causal, window=window)


flash_attention.launches = 0


@dtensor_local([("batch", None, "model", None)] * 3,
               [("batch", None, "model", None)])
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, Hkv, hd), H a multiple of Hkv ->
    (B, S, H, hd) in q's dtype.  window <= 0 means unbounded.  Given
    DTensors, each rank runs its rows (over the data axes) and its heads
    (over the model axis, where H and Hkv both divide it)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("attention_op takes q (B, S, H, hd) and k, v "
                         f"(B, T, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or H % Hkv
            or S == 0 or T == 0):
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} "
                         "disagree in B or hd, H is not a multiple of Hkv, "
                         "or an input is empty")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention_op inputs must lie on one device")
    if q.device.type == "cpu":
        return attention_op_ref(q, k, v, causal=causal, window=window)
    _check("attention_op", q, k, v)
    return _launch(q, k, v, batch=B, heads=H, group=H // Hkv, S=S, T=T,
                   hd=hd, q_strides=(S * H * hd, hd, H * hd),
                   k_strides=(T * Hkv * hd, hd, Hkv * hd), causal=causal,
                   window=window)
