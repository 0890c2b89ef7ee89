"""Chunked max-plus scan on Hopper (port of ``repro.kernels.maxplus_scan``).

The simulator's per-burst recurrences are all instances of one max-plus
linear scan (``core/simulator.py``):

  x_t = max(x_{t-1} + s_t, u_t),   x_{-1} = h0

(emits gated by upstream readiness, the GB port server, the drain's
absorb loop).  Within a chunk the scan has a cumulative-sum closed form:

  x_t = P_t + max(h_in, max_{tau<=t} (u_tau - P_tau)),
  P_t = sum_{sigma<=t} s_sigma   (inclusive).

``maxplus_chunked`` launches the CUDA kernel in ``csrc/maxplus_scan.cu``
(one warp per row, a warp scan over the semiring pairs inside each
32-element chunk, the carry in a register); on a CPU tensor it computes
the plain version ``maxplus_chunked_ref`` (the closed form above), on a
CUDA tensor it launches the kernel or raises.
``maxplus_chunked.launches`` counts launches.

Engines (``maxplus_scan(..., engine=...)``):

  * ``"torch"`` — ``maxplus_chunked`` on ``device`` (default ``cuda``).
  * ``"numpy"`` — the closed form in numpy.
  * ``"auto"``  — ``REPRO_MAXPLUS_ENGINE`` (``torch`` or ``numpy``), else
    ``"torch"``: never quietly numpy when there is no card.

``maxplus_scan_reference`` is the scalar loop the parity suites pin the
engines against.  Every tensor here is float64: cycle counts pass 2**24,
where float32 drops whole cycles.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os

import numpy as np
import torch

from ..models.common import resolve_device
from . import build

ENGINES = ("auto", "torch", "numpy")


# ---------------------------------------------------------------------------
# reference + numpy closed form
# ---------------------------------------------------------------------------


def maxplus_scan_reference(u, s, h0: float = -math.inf) -> np.ndarray:
    """Scalar loop: x_t = max(x_{t-1} + s_t, u_t).  The semantic pin."""
    u = np.asarray(u, np.float64)
    s = np.asarray(s, np.float64)
    out = np.empty_like(u)
    x = h0
    for t in range(u.shape[0]):
        x = max(x + s[t], u[t])
        out[t] = x
    return out


def _maxplus_numpy(u: np.ndarray, s: np.ndarray, h0: float) -> np.ndarray:
    P = np.cumsum(s)
    return P + np.maximum(np.maximum.accumulate(u - P), h0)


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def maxplus_chunked_ref(u: torch.Tensor, s: torch.Tensor,
                        h0: torch.Tensor) -> torch.Tensor:
    """Plain version: the closed form, batched over rows."""
    P = torch.cumsum(s, dim=1)
    q = torch.cummax(u - P, dim=1).values
    return P + torch.maximum(q, h0.reshape(-1, 1))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("maxplus_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxplus_launch.argtypes = [p, p, p, p, i, i, p]
    lib.maxplus_launch.restype = i
    lib.maxplus_error_string.argtypes = [i]
    lib.maxplus_error_string.restype = ctypes.c_char_p
    return lib


def maxplus_chunked(u: torch.Tensor, s: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    """u, s: (B, T) float64; h0: (B,) or (B, 1) -> x: (B, T) float64.

    Any T: the kernel masks the ragged last chunk (the reference pads to
    a multiple of its chunk with u = -inf, s = 0)."""
    if u.ndim != 2 or s.shape != u.shape:
        raise ValueError(f"maxplus_chunked takes u, s of one (B, T) shape, "
                         f"got {tuple(u.shape)} and {tuple(s.shape)}")
    B, T = u.shape
    if h0.numel() != B or h0.ndim not in (1, 2):
        raise ValueError(f"h0 must be (B,) or (B, 1) with B={B}, got "
                         f"{tuple(h0.shape)}")
    tensors = (u, s, h0)
    if any(t.device != u.device for t in tensors):
        raise ValueError("maxplus_chunked inputs must lie on one device")
    if any(t.dtype != torch.float64 for t in tensors):
        raise TypeError("maxplus_chunked takes float64 inputs, got "
                        f"{[t.dtype for t in tensors]}")
    if u.device.type == "cpu":
        return maxplus_chunked_ref(u, s, h0)
    if u.device.type != "cuda":
        raise ValueError(f"maxplus_chunked runs on cuda or cpu, not "
                         f"{u.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("maxplus_chunked takes contiguous inputs")
    out = torch.empty_like(u)
    if u.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.maxplus_launch(u.data_ptr(), s.data_ptr(), h0.data_ptr(),
                                 out.data_ptr(), B, T, stream)
    if err != 0:
        raise RuntimeError("maxplus_chunked launch failed: "
                           + lib.maxplus_error_string(err).decode())
    maxplus_chunked.launches += 1
    return out


maxplus_chunked.launches = 0


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def _resolve_engine(engine: str) -> str:
    if engine != "auto":
        return engine
    env = os.environ.get("REPRO_MAXPLUS_ENGINE", "").strip().lower()
    if not env:
        return "torch"
    if env not in ("torch", "numpy"):
        raise ValueError(f"REPRO_MAXPLUS_ENGINE={env!r}; one of "
                         "('torch', 'numpy')")
    return env


def maxplus_scan(u, s, h0: float = -math.inf, engine: str = "auto",
                 device=None) -> np.ndarray:
    """x_t = max(x_{t-1} + s_t, u_t) over the last axis, x_{-1} = h0.

    Accepts 1-D (T,) or 2-D (B, T) arrays; returns numpy float64 of the
    same shape.  ``device`` (torch engine only) defaults to ``cuda`` and
    raises without a card; ``device="cpu"`` runs the plain version.
    """
    u = np.asarray(u, np.float64)
    s = np.asarray(s, np.float64)
    squeeze = u.ndim == 1
    if squeeze:
        u, s = u[None, :], s[None, :]
    B, T = u.shape
    # resolve + validate the engine before the empty-input early return:
    # a bogus engine name must raise even when there is nothing to scan
    eng = _resolve_engine(engine)
    if eng not in ("torch", "numpy"):
        raise ValueError(f"unknown maxplus engine {eng!r}; one of "
                         f"{ENGINES}")
    if T == 0:
        return np.zeros(0) if squeeze else np.zeros((B, 0))
    if eng == "numpy":
        out = np.stack([_maxplus_numpy(u[b], s[b], h0) for b in range(B)])
        return out[0] if squeeze else out
    dev = resolve_device(device)
    ut = torch.from_numpy(np.ascontiguousarray(u)).to(dev)
    st = torch.from_numpy(np.ascontiguousarray(s)).to(dev)
    h = torch.full((B,), h0, dtype=torch.float64, device=dev)
    out = maxplus_chunked(ut, st, h).cpu().numpy()
    return out[0] if squeeze else out
