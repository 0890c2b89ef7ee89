"""Candidate pricing kernel of the torch planning engine.

``price_rows`` prices a batch of DP candidates (one edge bucket) with the
CUDA kernel in ``csrc/price_rows.cu``: the Fig. 3 interval recurrence of
``repro.core.pipeline_model_jax._make_price_fn`` per candidate, one thread
each, built without fused multiply-adds so that its float64 results are
the host's to the last bit.  On a CPU tensor the wrapper computes the
plain version ``price_rows_ref`` (batched over B, looping over E, line by
line the reference's ``one``); on a CUDA tensor it launches the kernel or
raises.  ``price_rows.launches`` counts launches.

Both return ``(latency (B,), congested (B,) bool, hop_energy (B,),
deltas (B, E))``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

_FLOAT_NAMES = ("t_prod", "t_cons", "n", "fill", "load", "hops", "hop_unit")


def price_rows_ref(t_prod: torch.Tensor, t_cons: torch.Tensor,
                   n: torch.Tensor, fill: torch.Tensor, load: torch.Tensor,
                   hops: torch.Tensor, hop_unit: torch.Tensor,
                   sp: torch.Tensor, fin: torch.Tensor, inc: torch.Tensor,
                   mem_stall: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """Plain version: the reference's ``one``, batched over candidates."""
    B, E = t_prod.shape
    deltas = torch.zeros_like(t_prod)
    pfill = torch.zeros_like(t_prod)
    congested = torch.zeros(B, dtype=torch.bool, device=t_prod.device)
    max_hops = torch.zeros(B, dtype=t_prod.dtype, device=t_prod.device)
    hop_e = torch.zeros(B, dtype=t_prod.dtype, device=t_prod.device)
    for k in range(E):
        nk = n[:, k]
        prod_side = torch.where(inc[:, k], deltas * (n / nk[:, None]),
                                0.0).amax(dim=1)
        ci = torch.maximum(t_prod[:, k],
                           torch.maximum(t_cons[:, k], prod_side))
        over = sp[:, k] & (load[:, k] > ci)
        capped = torch.minimum(
            load[:, k] * torch.clamp(ci, min=1.0),
            torch.maximum(load[:, k] * 2.0, load[:, k] + hops[:, k] + ci))
        comm = torch.where(over, capped, ci)
        congested = congested | over
        max_hops = torch.maximum(max_hops,
                                 torch.where(sp[:, k], hops[:, k], 0.0))
        hop_e = hop_e + torch.where(sp[:, k], hop_unit[:, k] * nk, 0.0)
        delta = torch.maximum(ci, comm) + mem_stall / nk
        upstream = torch.where(inc[:, k], pfill, 0.0).amax(dim=1)
        deltas[:, k] = delta
        pfill[:, k] = upstream + delta * fill[:, k]
    latency = (torch.where(fin, pfill + n * deltas, -torch.inf).amax(dim=1)
               + max_hops)
    return latency, congested, hop_e, deltas


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("price_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.price_rows_launch.argtypes = [p] * 16 + [i, i, p]
    lib.price_rows_launch.restype = i
    lib.price_rows_error_string.argtypes = [i]
    lib.price_rows_error_string.restype = ctypes.c_char_p
    return lib


def price_rows(t_prod: torch.Tensor, t_cons: torch.Tensor, n: torch.Tensor,
               fill: torch.Tensor, load: torch.Tensor, hops: torch.Tensor,
               hop_unit: torch.Tensor, sp: torch.Tensor, fin: torch.Tensor,
               inc: torch.Tensor, mem_stall: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """(B, E) float64 ``t_prod .. hop_unit``, (B, E) bool ``sp``/``fin``,
    (B, E, E) bool ``inc``, (B,) float64 ``mem_stall`` -> latency (B,),
    congested (B,) bool, hop energy (B,), deltas (B, E)."""
    floats = (t_prod, t_cons, n, fill, load, hops, hop_unit)
    if t_prod.ndim != 2 or t_prod.shape[1] == 0:
        raise ValueError(f"price_rows takes (B, E) rows with E >= 1, got "
                         f"t_prod {tuple(t_prod.shape)}")
    B, E = t_prod.shape
    for name, t in zip(_FLOAT_NAMES, floats):
        if tuple(t.shape) != (B, E):
            raise ValueError(f"{name} is {tuple(t.shape)}, not ({B}, {E})")
    if tuple(sp.shape) != (B, E) or tuple(fin.shape) != (B, E):
        raise ValueError(f"sp/fin must be ({B}, {E})")
    if tuple(inc.shape) != (B, E, E) or tuple(mem_stall.shape) != (B,):
        raise ValueError(f"inc must be ({B}, {E}, {E}) and mem_stall ({B},)")
    tensors = (*floats, sp, fin, inc, mem_stall)
    if any(t.device != t_prod.device for t in tensors):
        raise ValueError("price_rows inputs must lie on one device")
    if any(t.dtype != torch.float64 for t in (*floats, mem_stall)):
        raise TypeError("price_rows takes float64 rows and mem_stall")
    if any(t.dtype != torch.bool for t in (sp, fin, inc)):
        raise TypeError("price_rows takes bool sp, fin and inc")
    if t_prod.device.type == "cpu":
        return price_rows_ref(*tensors)
    if t_prod.device.type != "cuda":
        raise ValueError(f"price_rows runs on cuda or cpu, not "
                         f"{t_prod.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("price_rows takes contiguous inputs")
    kw = dict(dtype=torch.float64, device=t_prod.device)
    latency = torch.empty(B, **kw)
    hop_e = torch.empty(B, **kw)
    deltas = torch.empty(B, E, **kw)
    pfill = torch.empty(B, E, **kw)
    congested = torch.empty(B, dtype=torch.bool, device=t_prod.device)
    if B == 0:
        return latency, congested, hop_e, deltas
    lib = _library()
    with torch.cuda.device(t_prod.device):
        stream = torch.cuda.current_stream(t_prod.device).cuda_stream
        err = lib.price_rows_launch(
            *(t.data_ptr() for t in tensors), latency.data_ptr(),
            congested.data_ptr(), hop_e.data_ptr(), deltas.data_ptr(),
            pfill.data_ptr(), B, E, stream)
    if err != 0:
        raise RuntimeError("price_rows launch failed: "
                           + lib.price_rows_error_string(err).decode())
    price_rows.launches += 1
    return latency, congested, hop_e, deltas


price_rows.launches = 0
