"""musicgen-medium — 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens.  The EnCodec frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model) and
the backbone predicts next-frame codes over the 2048-entry codebook.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="[arXiv:2306.05284; hf]",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    activation="swiglu",
    embed_inputs=False,          # frontend stub supplies frame embeddings
    media_embed_dim=128,         # raw EnCodec frame feature dim (stub)
)
