"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

A field-for-field copy of the reference's config
(``repro.configs.gemma3_4b``), not Hugging Face's: like the reference,
the port models no QK-norm, no per-layer RoPE base (one ``rope_theta``
for local and global layers) and no embedding scaling.  Every sixth
layer is global (``transformer.layer_windows``); the others attend to
the last ``local_window`` keys."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", arch_kind="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, d_ff=10240, vocab=262144, head_dim=256,
    local_window=1024, global_every=6, rope_theta=1e6)

SMOKE = ModelConfig(
    name="gemma3-4b-smoke", arch_kind="dense", n_layers=6, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
    local_window=8, global_every=6)
