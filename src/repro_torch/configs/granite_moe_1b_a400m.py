"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", arch_kind="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
    n_experts=32, top_k=8)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke", arch_kind="moe", n_layers=2,
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab=512, head_dim=16,
    n_experts=4, top_k=2)
