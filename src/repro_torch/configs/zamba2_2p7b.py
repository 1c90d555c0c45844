"""zamba2-2.7b — 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Mamba2 backbone + shared-weight attention block every 6
mamba blocks (9 shared invocations).  [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="[arXiv:2411.15242; hf]",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10_240,
    vocab_size=32_000,
    head_dim=80,
    ssm_state=64,
    ssm_version=2,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    hybrid_period=6,
)
