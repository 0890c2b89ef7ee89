"""Decode attention on Hopper: one query a (slot, head) against that
slot's KV cache, read in place and split over the cache's length.

The serving tick's attention (``models.layers.attention`` with S = 1 and
a cache): q (B, 1, H, hd) at a per-slot position ``pos`` against k and v
(B, T, Hkv, hd).  The cache is a ring of T slots: slot j holds position
p_j = pos - (((pos mod T) - j) mod T) and is admitted when
0 <= p_j <= pos and pos - p_j < window (``ring_mask``), which is the
linear cache's mask before it wraps, a local layer's window, and the
ring buffer after it wraps.  Scores are scaled by ``hd ** -0.5``; masked
ones are ``_sdpa``'s finite -1e30.

``csrc/decode_attention.cu`` replaces no TPU kernel: the JAX package
decodes with its plain einsum attention.  Its header says what bounds it
(the bytes of the admitted K and V) and how it is split.  The grid
depends on static shapes only and each CTA reads its slot's position on
the device, so a call runs inside a captured CUDA graph with no host
sync.  bfloat16 runs its products on the tensor cores (``mma.sync``,
fp32 accumulation), float32 on the CUDA cores in fp32.

``decode_attention_op`` computes on CPU tensors the plain version
``decode_attention_ref`` (the ring mask, then ``_sdpa``'s einsums with
the softmax in fp32); on CUDA tensors it launches the kernel or raises.
``decode_attention_op.launches`` counts its calls on the card, one a
call whichever passes the kernel takes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: head sizes one launch takes
HEAD_SIZES = (16, 32, 64, 128, 256)

#: the most query heads that share a kv head (the mma's 16 rows)
MAX_GROUP = 16

#: the slots one CTA reads, largest first
CHUNKS = (256, 128, 64)

#: the most elements of one CTA's K (or V) tile: 32 KB in bf16, so K and
#: V together leave room for three CTAs an SM
MAX_TILE = 16384

#: CTAs an SM that a full cache should give before a smaller chunk is
#: taken
CTAS_PER_SM = 4

#: the most chunks of one cache (the combine pass weighs them in 48 KB of
#: shared memory)
MAX_CHUNKS = 12288

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ring_mask(positions: torch.Tensor, T: int, window: int) -> torch.Tensor:
    """(B, 1, T) mask of a ring-buffer cache for one query per row at
    real position ``pos``: slot j holds position
    p_j = pos - (((pos mod T) - j) mod T), admitted when 0 <= p_j <= pos
    and pos - p_j < window.  Before the ring wraps (pos < T) this is the
    linear cache's causal, fill and window mask."""
    pos = positions[:, :, None]                               # (B,1,1)
    j = torch.arange(T, device=positions.device)[None, None, :]
    p_j = pos - torch.remainder(torch.remainder(pos, T) - j, T)
    return (p_j >= 0) & (p_j <= pos) & (pos - p_j < window)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, positions: torch.Tensor,
                         window: int) -> torch.Tensor:
    """Plain version: ``models.layers._sdpa`` over ``ring_mask`` (scores in
    the inputs' type, then fp32 for the scale, the mask and the softmax;
    weights cast to v's type for the PV product)."""
    from repro_torch.models.layers import _sdpa     # layers imports this
    return _sdpa(q, k_cache, v_cache,
                 ring_mask(positions, k_cache.shape[1], window), None)


def choose_chunk(batch: int, kv_heads: int, T: int, hd: int,
                 sms: int) -> int:
    """The slots a CTA reads: the largest of ``CHUNKS`` whose tile holds
    at most ``MAX_TILE`` elements, halved (down to 64) while a full cache
    would give fewer than ``CTAS_PER_SM`` CTAs an SM."""
    chunk = next(c for c in CHUNKS if c * hd <= MAX_TILE)
    while (chunk > CHUNKS[-1]
           and batch * kv_heads * -(-T // chunk) < CTAS_PER_SM * sms):
        chunk //= 2
    return chunk


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           positions: torch.Tensor) -> None:
    """Grad mode, dtype, contiguity, alignment and size checks of a CUDA
    call whose shapes ``decode_attention_op`` has checked."""
    build.refuse_grad("decode_attention_op", q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention_op takes float32 or bfloat16 q, "
                        "k and v of one dtype, got "
                        f"{[t.dtype for t in (q, k, v)]}")
    if not all(t.is_contiguous() for t in (q, k, v, positions)):
        raise ValueError("decode_attention_op takes contiguous q, caches "
                         "and positions")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention_op takes inputs aligned to 16 "
                         "bytes")
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    if hd not in HEAD_SIZES:
        raise ValueError(f"head size {hd} is not one of the kernel's "
                         f"{', '.join(map(str, HEAD_SIZES))}")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"{H // Hkv} query heads a kv head: the kernel "
                         f"takes at most {MAX_GROUP}")
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"batch {B} or kv heads {Hkv} exceeds one "
                         "launch's 65535")


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, positions: torch.Tensor,
                        window: int) -> torch.Tensor:
    """q: (B, 1, H, hd); k_cache, v_cache: (B, T, Hkv, hd), H a multiple
    of Hkv; positions: (B, 1) int64, each row's real position (its key and
    value already written at slot pos mod T); window >= 1 -> (B, 1, H, hd)
    in q's dtype."""
    if q.ndim != 4 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention_op takes q (B, 1, H, hd) and "
                         "caches (B, T, Hkv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, S, H, hd = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (S != 1 or k_cache.shape[0] != B or k_cache.shape[3] != hd
            or Hkv == 0 or H % Hkv or T == 0):
        raise ValueError(f"q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} are not one query a row "
                         "against caches of the same B and hd, with H a "
                         "multiple of Hkv")
    if positions.dtype != torch.int64 or tuple(positions.shape) != (B, 1):
        raise ValueError(f"positions must be ({B}, 1) int64, got "
                         f"{tuple(positions.shape)} {positions.dtype}")
    if window < 1:
        raise ValueError(f"window {window} admits no key")
    if any(t.device != q.device for t in (k_cache, v_cache, positions)):
        raise ValueError("decode_attention_op inputs must lie on one device")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, positions, window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_op runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k_cache, v_cache, positions)
    return _launch(q, k_cache, v_cache, positions, window)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: torch.Tensor, window: int) -> torch.Tensor:
    """The split pass and, when the cache spans two chunks or more, the
    combine pass, on q's device and current stream; one count."""
    lib = _library()
    B, _, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    chunk = choose_chunk(B, Hkv, T, hd, _sm_count(q.device.index))
    n_chunks = -(-T // chunk)
    if n_chunks > MAX_CHUNKS:
        raise ValueError(f"a cache of {T} positions spans {n_chunks} chunks "
                         f"of {chunk}, over the kernel's {MAX_CHUNKS}")
    scratch = B * H * n_chunks if n_chunks > 1 else 0
    part_acc = torch.empty(scratch * hd, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(scratch * 2, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    with build.on_device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            _DTYPES[q.dtype], B, H, Hkv, T, hd, min(window, T), chunk,
            hd ** -0.5, build.launch_stream(q.device))
    if err != 0:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    decode_attention_op.launches += 1
    return out


decode_attention_op.launches = 0
