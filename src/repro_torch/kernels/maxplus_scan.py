"""Chunked max-plus scan on Hopper (port of ``repro.kernels.maxplus_scan``).

The simulator's per-burst recurrences are all instances of one max-plus
linear scan (``core/simulator.py``):

  x_t = max(x_{t-1} + s_t, u_t),   x_{-1} = h0

(emits gated by upstream readiness, the GB port server, the drain's
absorb loop).  Within a chunk the scan has a cumulative-sum closed form:

  x_t = P_t + max(h_in, max_{tau<=t} (u_tau - P_tau)),
  P_t = sum_{sigma<=t} s_sigma   (inclusive).

``maxplus_chunked`` launches the CUDA kernel in ``csrc/maxplus_scan.cu``
(one block of 128 threads a row, up to 8 consecutive steps a thread, a
block-wide scan over the semiring pairs in tiles of up to 1024 steps, the
carry between tiles in shared memory); the source's header says what
bounds it: launch latency, not bytes.  On a CPU tensor it computes the plain version
``maxplus_chunked_ref`` (the closed form above), on a CUDA tensor it
launches the kernel or raises.  ``maxplus_chunked.launches`` counts
launches.

Engines (``maxplus_scan(..., engine=...)``):

  * ``"torch"`` — ``maxplus_chunked`` on ``device`` (default ``cuda``):
    u, s and h0 packed into one staging tensor (pinned for the card), one
    copy to the card, one launch on addresses inside it, one copy back.
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
    # the checks are written out, not looped: each is on the launch path
    dev = u.device
    if s.device != dev or h0.device != dev:
        raise ValueError("maxplus_chunked inputs must lie on one device")
    f64 = torch.float64
    if u.dtype != f64 or s.dtype != f64 or h0.dtype != f64:
        raise TypeError("maxplus_chunked takes float64 inputs, got "
                        f"{[t.dtype for t in (u, s, h0)]}")
    if dev.type == "cpu":
        return maxplus_chunked_ref(u, s, h0)
    if dev.type != "cuda":
        raise ValueError(f"maxplus_chunked runs on cuda or cpu, not {dev}")
    if not (u.is_contiguous() and s.is_contiguous()
            and h0.is_contiguous()):
        raise ValueError("maxplus_chunked takes contiguous inputs")
    out = torch.empty_like(u)
    if u.numel() == 0:
        return out
    return _launch(dev, u.data_ptr(), s.data_ptr(), h0.data_ptr(), out)


maxplus_chunked.launches = 0


def _launch(dev: torch.device, u: int, s: int, h0: int,
            out: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on ``dev`` over the float64 rows at
    addresses ``u``, ``s`` and ``h0``, into ``out`` (B, T); counts it.
    ``maxplus_chunked`` calls it on checked tensors, ``maxplus_scan`` on
    its staging tensor."""
    B, T = out.shape
    lib = _library()
    with build.on_device(dev):
        err = lib.maxplus_launch(u, s, h0, out.data_ptr(), B, T,
                                 build.launch_stream(dev))
    if err != 0:
        raise RuntimeError("maxplus_chunked launch failed: "
                           + lib.maxplus_error_string(err).decode())
    maxplus_chunked.launches += 1
    return out


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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"maxplus_scan runs on cuda or cpu, not {dev}")
    # u, s and h0 in one staging tensor [u | pad | s | h0], pinned for the
    # card; the pad (where B T is odd) keeps s 16-byte aligned for the
    # kernel's double2 loads
    n = B * T
    off = n + (n & 1)
    stage = torch.empty(off + n + B, dtype=torch.float64,
                        pin_memory=dev.type == "cuda")
    host = stage.numpy()
    host[:n] = u.reshape(-1)
    host[off:off + n] = s.reshape(-1)
    host[off + n:] = h0
    if dev.type == "cpu":
        out = maxplus_chunked(stage[:n].view(B, T),
                              stage[off:off + n].view(B, T), stage[off + n:])
    else:
        # one copy to the card, and the launch on addresses inside it: the
        # staged rows need neither the wrapper's checks nor views
        d = stage.to(dev, non_blocking=True)
        p = d.data_ptr()
        out = _launch(d.device, p, p + 8 * off, p + 8 * (off + n),
                      d.new_empty((B, T)))
    out = out.cpu().numpy()
    return out[0] if squeeze else out
