"""mixtral-8x7b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336/expert
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    source="[arXiv:2401.04088; hf]",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=128,
    attention="swa",
    window=4096,
    n_experts=8,
    top_k=2,
    activation="swiglu",
)
