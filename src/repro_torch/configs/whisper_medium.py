"""whisper-medium [audio]: 24L(enc)+24L(dec) d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 — enc-dec; conv frontend is a STUB (input_specs
ships precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", arch_kind="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, head_dim=64,
    n_enc_layers=24, enc_frames=1500)

SMOKE = ModelConfig(
    name="whisper-medium-smoke", arch_kind="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=16,
    n_enc_layers=2, enc_frames=8)
