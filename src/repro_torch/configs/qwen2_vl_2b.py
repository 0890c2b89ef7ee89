"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution; the vision frontend is a STUB
(input_specs ships precomputed patch embeddings).  [arXiv:2409.12191; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", arch_kind="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936, head_dim=128,
    qkv_bias=True, n_patches=256, mrope_sections=(16, 24, 24),
    rope_theta=1e6)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke", arch_kind="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
    qkv_bias=True, n_patches=4, mrope_sections=(2, 3, 3))
