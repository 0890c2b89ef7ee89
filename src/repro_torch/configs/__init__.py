"""Architecture registry of the port: only the archs ported so far.

``get_config(arch_id, smoke=False)`` returns the published config (or its
reduced smoke sibling), as ``repro.configs.get_config`` does.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = {
    "gemma3-4b": "gemma3_4b",
    "qwen2.5-3b": "qwen2_5_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch yet; ROADMAP.md "
            f"lists the order of the port (ported: {sorted(ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "get_config"]
