"""nemotron-4-15b — 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000,
squared-ReLU MLP.  [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    source="[arXiv:2402.16819; unverified]",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    head_dim=128,
    activation="squared_relu",
)
