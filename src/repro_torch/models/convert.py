"""Carry parameters of the JAX reference across to the port.

``params_from_jax`` takes the pytree that ``repro.models.init_model``
returns, already turned into numpy arrays by the caller (for example
``jax.tree.map(np.asarray, params)``), and returns the port's parameters:
the same nested dictionaries, the same layouts (``w_gate`` stays (D, F),
``w_down`` (F, D)), the same bits.  The port then computes what the JAX
model computes.  This module imports numpy, not JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .common import DeviceLike, resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands over ml_dtypes');
        # carry the bits across unchanged
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Map a numpy copy of the reference's parameter pytree (nested dicts
    and lists of arrays) onto tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _tensor(node, dev)

    return conv(tree)
