"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", arch_kind="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352, head_dim=128)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke", arch_kind="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16)
