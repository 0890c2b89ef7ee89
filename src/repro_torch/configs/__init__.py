"""Architecture registry of the port: the reference's ten archs.

``get_config(arch_id, smoke=False)`` returns the published config (or its
reduced smoke sibling), as ``repro.configs.get_config`` does.  All ten
run; whisper-medium (encdec) through ``encode_frames``,
``whisper_forward`` and ``whisper_decode_step`` rather than ``forward``
and ``decode_step``.  ``SHAPES`` holds the reference's input-shape
cells (``train_4k`` is the training launcher's default).
"""
from __future__ import annotations

import importlib

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


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; ROADMAP.md lists the port's archs "
            f"(known: {sorted(ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config"]
