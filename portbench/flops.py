"""The benchmark's yardstick: the chip's peaks, and the operations and
bytes the algorithms need, counted from shapes alone (what implements
them does not change the count).

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates without sparsity.  A run prints the card's power limit beside the
shares it reports, since a card set lower reaches less.
"""
from __future__ import annotations

from typing import Dict

#: bf16 tensor-core peak, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12


def matmul_params(spec: Dict) -> int:
    """Weights a token passes through in matrix products: every layer's
    q, k, v, o and the three MLP matrices, and the LM head over the
    published vocab (biases and norms are not products and add no
    count here)."""
    D, F = spec["d_model"], spec["d_ff"]
    qd = spec["heads"] * spec["head_dim"]
    kd = spec["kv_heads"] * spec["head_dim"]
    layer = D * qd + 2 * D * kd + qd * D + 3 * D * F
    return spec["layers"] * layer + D * spec["vocab"]


def decode_token_flops(spec: Dict, context: int) -> float:
    """One token's forward through every layer and the head, attending
    to ``context`` positions (its own included): 2 N for the products,
    4 L H hd context for q k^T and the weighted sum of v."""
    attn = 4 * spec["layers"] * spec["heads"] * spec["head_dim"] * context
    return 2.0 * matmul_params(spec) + attn


def train_step_flops(spec: Dict, rows: int, seq: int) -> float:
    """A causal training step on ``rows`` x ``seq`` tokens, forward and
    backward, without the recomputation remat adds: 6 N T for the
    products and 6 L S H hd T for attention (half of the S x S scores
    under the causal mask, three passes)."""
    T = rows * seq
    attn = 6 * spec["layers"] * seq * spec["heads"] * spec["head_dim"] * T
    return 6.0 * matmul_params(spec) * T + attn


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the chip could take: bytes at HBM bandwidth or
    operations at the bf16 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def fused_mlp_bound_s(T: int, D: int, F: int, elem: int = 2) -> float:
    """One SwiGLU call, (x Wg, x Wu) -> silu * -> Wd, on T rows: each
    input byte read once (x and the three matrices) and the output
    written once; 6 T D F operations."""
    nbytes = elem * (T * D + 3 * D * F + T * D)
    return bound_s(nbytes, 6.0 * T * D * F)
