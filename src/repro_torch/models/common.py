"""Shared model machinery: config, shapes, device choice, norms, RoPE
(and Qwen2-VL's M-RoPE), sinusoidal positions, init, the training loss.

Port of ``repro.models.common``.  Models are plain dictionaries of tensors
plus functions on them, laid out exactly as the reference's pytrees
(per-layer parameters stacked on a leading axis, or a list of per-layer
dictionaries for the hybrid family), so ``convert.params_from_jax`` is a
leaf-by-leaf copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.hints import hint

Params = Dict[str, Any]
DeviceLike = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field-for-field copy of the reference ``ModelConfig``; ``dtype`` is
    a torch dtype.  Every family of the reference runs in this port:
    dense, moe, rwkv, hybrid, vlm and encdec."""
    name: str
    arch_kind: str                   # dense | moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: int = 0
    global_every: int = 0
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    block_pattern: Tuple[str, ...] = ()
    rglru_dim: int = 0
    conv1d_width: int = 4
    n_enc_layers: int = 0
    enc_frames: int = 1500
    n_patches: int = 256
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # int8 KV cache with per-vector scales
    kv_quant: bool = False
    # run every hand-written CUDA kernel on the path: the MLP through
    # kernels/fused_mlp, attention without a cache (prefill) through
    # kernels/flash_attention, the RWKV-6 recurrence through
    # kernels/rwkv6_scan, the RG-LRU recurrence through kernels/rglru_scan
    # (as the reference's ``use_pallas`` does for every op of kernels/ops)
    use_kernels: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a TP-shardable multiple (256)."""
        return -(-self.vocab // 256) * 256


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell of the reference's assignment
    (``repro.models.common.ShapeSpec``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises rather than quietly falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope_freqs(hd: int, theta: float, device: DeviceLike = None
               ) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    angles = angles[..., None, :]                          # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (..., S, H, hd); positions:
    (..., S, 3), the (temporal, height, width) position ids; sections:
    how many rotary frequency *pairs* each of (t, h, w) takes, summing to
    hd / 2.  Frequency pair f rotates by the position of its section's
    stream, so with three equal streams this is ``apply_rope`` bit for
    bit."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"hd / 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=hd // 2)                               # (hd/2,)
    pos = positions.float()[..., sec_ids]                  # (..., S, hd/2)
    angles = (pos * freqs)[..., None, :]                   # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, start: int = 0,
                         device: DeviceLike = None) -> torch.Tensor:
    """(length, dim) float32 embeddings of positions start .. start +
    length - 1: sine on the even columns, cosine on the odd ones."""
    pos = torch.arange(start, start + length, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal init scaled by fan-in (``shape[0]``), drawn in fp32 from
    ``gen`` on ``gen``'s device and cast to ``dtype``.  The scaling is in
    place, so a draw holds one fp32 copy beside its result."""
    fan_in = shape[0]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(s).to(dtype)


def _label_logits(logits: DTensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit at its label, on a mesh.  Logits whose vocab
    lies whole on each rank take the gather of the plain path on each
    rank's rows; vocab-sharded logits select it by the vocab ids sharded
    like their last dim, and the sum over the vocab (one term, the rest
    exact zeros) is reduced over the model axis.  DTensor's ``gather``
    would do the same forward, but its backward scatters into a
    replicated zero tensor of the global logits' size (80 GB a rank at
    qwen2.5-3b's train_4k)."""
    from repro_torch.distributed.hints import local_call
    from repro_torch.distributed.sharding import NamedSharding, from_full
    mesh = logits.device_mesh
    V = logits.shape[-1]
    spec = tuple(n for i, (n, p) in enumerate(zip(mesh.mesh_dim_names,
                                                  logits.placements))
                 if p.is_shard(logits.ndim - 1) and mesh.size(i) > 1)
    if not spec:
        return local_call(
            lambda lg, y: torch.gather(lg, -1, y[..., None].long())[..., 0],
            [logits, labels], [("batch", None, None), ("batch", None)],
            [("batch", None)])
    ids = from_full(torch.arange(V, device=logits.to_local().device),
                    NamedSharding(mesh, (spec,)))
    hit = labels[..., None].long() == ids
    return hint(torch.where(hit, logits, 0.0).sum(-1), "batch", None)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with the z-loss ``z_loss * lse**2``, in
    float32.  The padded vocab rows arrive at -1e30 (``_mask_pad_vocab``)
    and add nothing to the log-sum-exp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        ll = _label_logits(logits, labels)
    else:
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)
