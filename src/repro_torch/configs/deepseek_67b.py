"""deepseek-67b — 95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400,
llama-arch.  [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    source="[arXiv:2401.02954; hf]",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=102_400,
    head_dim=128,
    activation="swiglu",
)
