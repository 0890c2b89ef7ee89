"""Model zoo of the port: the dense decoder (qwen2.5-3b, qwen1.5-32b,
phi3-medium-14b, gemma3-4b), the MoE decoder (granite-moe-1b-a400m,
moonshot-v1-16b-a3b), the RWKV-6 and hybrid (RecurrentGemma) families,
the M-RoPE vlm (qwen2-vl-2b) and the whisper encoder-decoder
(whisper-medium): all ten archs of the reference."""
from .common import (SHAPES, ModelConfig, Params, ShapeSpec,
                     cross_entropy_loss, resolve_device)
from .convert import params_from_jax
from .transformer import (decode_step, encode_frames, forward, init_cache,
                          init_model, layer_windows, loss_fn,
                          whisper_decode_step, whisper_forward,
                          whisper_loss_fn, zero_cache_slot)

__all__ = [
    "SHAPES", "ModelConfig", "Params", "ShapeSpec", "cross_entropy_loss",
    "decode_step", "encode_frames", "forward", "init_cache", "init_model",
    "layer_windows", "loss_fn", "params_from_jax", "resolve_device",
    "whisper_decode_step", "whisper_forward", "whisper_loss_fn",
    "zero_cache_slot",
]
