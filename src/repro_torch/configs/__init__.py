"""Architecture registry: ``--arch <id>`` ids map to config modules."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shape_applicable

from repro_torch.configs import (
    falcon_mamba_7b,
    deepseek_67b,
    gemma2_9b,
    smollm_360m,
    nemotron_4_15b,
    zamba2_2p7b,
    musicgen_medium,
    qwen3_moe_30b_a3b,
    mixtral_8x7b,
    llama_3p2_vision_11b,
)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        falcon_mamba_7b,
        deepseek_67b,
        gemma2_9b,
        smollm_360m,
        nemotron_4_15b,
        zamba2_2p7b,
        musicgen_medium,
        qwen3_moe_30b_a3b,
        mixtral_8x7b,
        llama_3p2_vision_11b,
    )
}

ARCH_IDS = sorted(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return REGISTRY[arch]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells():
    """Yield (arch, shape, runnable, skip_reason) for all 40 cells."""
    for arch in ARCH_IDS:
        cfg = REGISTRY[arch]
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            yield arch, sname, ok, why


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "REGISTRY", "ARCH_IDS",
    "get_config", "get_shape", "all_cells", "shape_applicable",
]
