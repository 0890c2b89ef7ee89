"""Architecture registry of the port: the reference's ten archs.

``get_config(arch_id, smoke=False)`` returns the published config (or its
reduced smoke sibling), as ``repro.configs.get_config`` does.  All ten
run; whisper-medium (encdec) through ``encode_frames``,
``whisper_forward`` and ``whisper_decode_step`` rather than ``forward``
and ``decode_step``.  ``SHAPES`` holds the reference's input-shape
cells (``train_4k`` is the training launcher's default).

``input_specs(cfg, shape)`` and ``decode_input_specs(cfg, shape)`` give
stand-ins for every input of a cell: tensors on the ``meta`` device, with
the reference's shapes and dtypes and no storage (the torch counterpart
of ``jax.ShapeDtypeStruct``), which the dry-run shards and steps.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from repro_torch.models.common import SHAPES, ModelConfig, ShapeSpec

ARCHS = {
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen1.5-32b": "qwen1_5_32b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma3-4b": "gemma3_4b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-medium": "whisper_medium",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


#: archs with sub-quadratic long-context support: these run long_500k.
#: Pure full-attention archs skip it, as in the reference.
SUBQUADRATIC = {"gemma3-4b", "recurrentgemma-2b", "rwkv6-1.6b"}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; ROADMAP.md lists the port's archs "
            f"(known: {sorted(ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG


def cell_supported(arch_id: str, shape_name: str) -> bool:
    """Is this (arch x shape) cell runnable?  (40 cells; 7 skips: the
    full-attention archs at long_500k)"""
    if shape_name == "long_500k":
        return arch_id in SUBQUADRATIC
    return True


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Stand-ins for a train or prefill step's inputs: tokens and labels
    (B, S) int32, the vlm's patch embeddings and the encoder-decoder's
    frames (float32)."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32),
                             "labels": _meta((B, S), torch.int32)}
    if cfg.arch_kind == "vlm":
        specs["patch_embeds"] = _meta((B, cfg.n_patches, cfg.d_model),
                                      torch.float32)
    if cfg.arch_kind == "encdec":
        specs["frames"] = _meta((B, cfg.enc_frames, cfg.d_model),
                                torch.float32)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec
                       ) -> Dict[str, Any]:
    """Stand-ins for one serve step: one new token a row, a cache of
    ``seq_len`` positions (``init_cache`` on ``meta``; the
    encoder-decoder's also holds the encoded frames as ``"enc"``) and the
    0-d int32 index."""
    from repro_torch.models.transformer import init_cache

    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, device="meta")
    if cfg.arch_kind == "encdec":
        cache = {"enc": _meta((B, cfg.enc_frames, cfg.d_model), cfg.dtype),
                 "k": cache["k"], "v": cache["v"]}
    return {"tokens": _meta((B, 1), torch.int32), "cache": cache,
            "index": _meta((), torch.int32)}


__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "ShapeSpec", "cell_supported",
           "decode_input_specs", "get_config", "input_specs"]
