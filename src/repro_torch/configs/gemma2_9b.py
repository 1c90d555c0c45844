"""gemma2-9b — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
local(4096)+global alternating attention, logit softcaps, head_dim 256.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="[arXiv:2408.00118; hf]",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=256_000,
    head_dim=256,
    attention="local_global",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    activation="geglu",
    post_norms=True,
    scale_embeddings=True,
    tie_embeddings=True,
)
