"""Model zoo of the port: the dense decoder (qwen2.5-3b, qwen1.5-32b,
phi3-medium-14b, gemma3-4b), the MoE decoder (granite-moe-1b-a400m,
moonshot-v1-16b-a3b), RWKV-6 and hybrid (RecurrentGemma) families so far;
vlm and encdec raise ``NotImplementedError``."""
from .common import ModelConfig, Params, resolve_device
from .convert import params_from_jax
from .transformer import (decode_step, forward, init_cache, init_model,
                          layer_windows, zero_cache_slot)

__all__ = [
    "ModelConfig", "Params", "decode_step", "forward", "init_cache",
    "init_model", "layer_windows", "params_from_jax", "resolve_device",
    "zero_cache_slot",
]
