"""qwen3-moe-30b-a3b — 48L d_model=2048 32H (GQA kv=4) d_ff=768/expert
vocab=151936, MoE 128 experts top-8, QK-norm.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    activation="swiglu",
)
