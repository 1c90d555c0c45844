"""smollm-360m — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152,
llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49_152,
    head_dim=64,
    activation="swiglu",
    tie_embeddings=True,
)
