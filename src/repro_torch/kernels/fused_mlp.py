"""Fused SwiGLU MLP — PipeOrgan's fine-grained inter-op pipelining on Hopper.

Port of ``repro.kernels.fused_mlp``.  ``fused_mlp`` launches the CUDA
kernel in ``csrc/fused_mlp.cu``, which keeps each (T tile x F chunk) of
the intermediate ``silu(x Wg) * (x Wu)`` in shared memory and feeds it
straight into the down product: the (T, F) intermediate never reaches
device memory.  The source's header says what bounds it and why.

On a CPU tensor the wrapper computes the plain version, ``fused_mlp_ref``
(the port of ``repro.kernels.ref.fused_mlp_ref``); on a CUDA tensor it
launches the kernel or raises.  ``fused_mlp.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: kernel dtype codes of ``fused_mlp_launch``
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_mlp_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 products, h rounded to ``x.dtype``."""
    g = x.float() @ w_gate.float()
    u = x.float() @ w_up.float()
    h = torch.nn.functional.silu(g) * u
    return (h.to(x.dtype).float() @ w_down.float()).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("fused_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.fused_mlp_launch.restype = i
    lib.fused_mlp_max_t.argtypes = []
    lib.fused_mlp_max_t.restype = i
    lib.fused_mlp_error_string.argtypes = [i]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


def fused_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """x: (T, D); w_gate/w_up: (D, F); w_down: (F, D) -> (T, D) in x.dtype."""
    if x.ndim != 2 or w_gate.ndim != 2 or w_up.ndim != 2 or w_down.ndim != 2:
        raise ValueError("fused_mlp takes x (T, D), w_gate/w_up (D, F) and "
                         "w_down (F, D)")
    T, D = x.shape
    F = w_gate.shape[1]
    if (tuple(w_gate.shape) != (D, F) or tuple(w_up.shape) != (D, F)
            or tuple(w_down.shape) != (F, D)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, "
                         f"w_down {tuple(w_down.shape)}")
    tensors = (x, w_gate, w_up, w_down)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_mlp inputs must lie on one device")
    if x.device.type == "cpu":
        return fused_mlp_ref(x, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("fused_mlp takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp takes contiguous (row-major) inputs")
    lib = _library()
    if not 0 < T <= lib.fused_mlp_max_t():
        raise ValueError(f"T={T} is outside one launch's 1.."
                         f"{lib.fused_mlp_max_t()} rows")
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_mlp_launch(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), out.data_ptr(), T, D, F, _DTYPES[x.dtype],
            stream)
    if err != 0:
        raise RuntimeError("fused_mlp launch failed: "
                           + lib.fused_mlp_error_string(err).decode())
    fused_mlp.launches += 1
    return out.to(x.dtype)


fused_mlp.launches = 0


def mlp_block(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """(B, S, D) SwiGLU through ``fused_mlp`` (``repro.kernels.ops``)."""
    B, S, D = x.shape
    y = fused_mlp(x.reshape(B * S, D), w_gate, w_up, w_down)
    return y.reshape(B, S, D)
