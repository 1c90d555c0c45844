"""llama-3.2-vision-11b — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer.  The vision
frontend (ViT) is a STUB: ``input_specs()`` provides precomputed patch
embeddings (B, 1600, 1280) projected into d_model.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    head_dim=128,
    activation="swiglu",
    cross_attn_period=5,          # every 5th layer is a cross-attn layer
    n_media_tokens=1600,
    media_embed_dim=1280,
)
