"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch_kind="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6)

SMOKE = ModelConfig(
    name="qwen1.5-32b-smoke", arch_kind="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab=512, head_dim=16,
    qkv_bias=True)
