"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 — kimi/moonlight.
[hf:moonshotai/Moonlight-16B-A3B; hf]

As configured here (48 layers of 64 experts, each 3 x 2048 x 1408), the
model holds 27.7 B parameters, not the 16 B of its name."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", arch_kind="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840, head_dim=128,
    n_experts=64, top_k=6)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", arch_kind="moe", n_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=512, head_dim=16,
    n_experts=4, top_k=2)
