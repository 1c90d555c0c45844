"""Config system: architecture configs, input-shape configs, registry.

The port's copy of ``repro.configs.base``: every architecture has one
module in ``repro_torch/configs/<id>.py`` exporting ``CONFIG`` (the exact
published configuration) on the ``ModelConfig`` dataclass below, so
``--arch`` ids are the reference's.  ``ModelConfig.smoke()`` derives the
reduced same-family config of the CPU tests.  ``models.model.build_model``
runs all six families.  ``param_count()`` is the reference's census: for
the vlm it counts ``n_layers`` self blocks beside the cross blocks
(11.52B for llama-3.2-vision-11b), while the parameter tree holds ``n_layers
- n_layers / cross_attn_period`` self blocks (9.78B); memory reckonings
use the tree's count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                     # dense | ssm | hybrid | moe | audio | vlm
    source: str = ""                # provenance note "[arXiv:...; tier]"

    # trunk dims
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: Optional[int] = None  # None => d_model // n_heads

    # attention flavor
    attention: str = "full"         # full | swa | local_global
    window: int = 4096              # SWA / local window
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False

    # mlp
    activation: str = "swiglu"      # swiglu | squared_relu | geglu
    post_norms: bool = False        # gemma2-style post-attn/post-mlp RMSNorms
    scale_embeddings: bool = False  # multiply embeddings by sqrt(d_model)

    # ssm (mamba) — used by family in {ssm, hybrid}
    ssm_state: int = 0
    ssm_version: int = 1            # 1 => mamba1 selective scan, 2 => mamba2/SSD
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64          # mamba2 head dim (P)
    dt_rank: int = 0                # 0 => ceil(d_model / 16)

    # hybrid (zamba2-style): one shared-weight attention block per
    # ``hybrid_period`` mamba blocks.
    hybrid_period: int = 0

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # multimodal stubs: the frontend is a stub; input_specs() provides
    # precomputed frame/patch embeddings of dim ``media_embed_dim``.
    cross_attn_period: int = 0      # cross-attn layer every k-th layer (0 = none)
    n_media_tokens: int = 0
    media_embed_dim: int = 0
    embed_inputs: bool = True       # False: inputs are precomputed embeddings (audio)

    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"    # master params

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("ssm", "hybrid") and self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", max(1, math.ceil(self.d_model / 16)))

    # family predicates -------------------------------------------------- #
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(seq) (or O(window)) decoding — gate for
        the long_500k shape.  Pure full-attention stacks are quadratic in
        aggregate history; SSM / hybrid / pure-SWA qualify."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attention == "swa"  # rolling-window cache => O(window)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return max(1, self.d_inner // self.ssm_head_dim)

    # parameter census (used by roofline + planner cost models) ---------- #
    def param_count(self) -> int:
        d, L = self.d_model, self.n_layers
        n = 0
        # embeddings (+ output head)
        if self.embed_inputs:
            n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.family == "ssm":
            n += L * self._mamba_block_params()
        elif self.family == "hybrid":
            n += L * self._mamba_block_params()
            n += self._attn_block_params() + self._mlp_params(self.d_ff)  # shared once
        else:
            per_layer = self._attn_block_params()
            if self.is_moe:
                per_layer += d * self.n_experts                    # router
                per_layer += self.n_experts * 3 * d * self.d_ff    # expert swiglu
            else:
                per_layer += self._mlp_params(self.d_ff)
            n += L * per_layer
            if self.cross_attn_period:
                n_cross = L // self.cross_attn_period
                n += n_cross * (self._cross_attn_params() + self._mlp_params(self.d_ff))
        if self.media_embed_dim:
            n += self.media_embed_dim * d                          # projector
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        n = self.param_count()
        n -= L * self.n_experts * 3 * d * self.d_ff
        n += L * self.top_k * 3 * d * self.d_ff
        return n

    def _attn_block_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _cross_attn_params(self) -> int:
        return self._attn_block_params()

    def _mlp_params(self, f: int) -> int:
        if self.activation in ("swiglu", "geglu"):
            return 3 * self.d_model * f
        return 2 * self.d_model * f

    def _mamba_block_params(self) -> int:
        d, di, N, R = self.d_model, self.d_inner, self.ssm_state, self.dt_rank
        n = d * 2 * di                    # in_proj
        n += di * self.ssm_conv           # depthwise conv
        if self.ssm_version == 1:
            n += di * (R + 2 * N)         # x_proj
            n += R * di                   # dt_proj
            n += di * N + di              # A_log, D
        else:                             # mamba2 / SSD
            H = self.n_ssm_heads
            n += di * (2 * N + H)         # BC + dt heads  (x part comes from in_proj)
            n += 2 * H                    # A_log, D per head
        n += di * d                       # out_proj
        return n

    # reduced config for CPU smoke tests --------------------------------- #
    def smoke(self) -> "ModelConfig":
        kv = max(1, min(self.n_kv_heads, 2))
        heads = max(kv, 4) if self.n_heads else 0
        # keep head ratio GQA-like: 4 heads, kv per family
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, (2 * self.hybrid_period) if self.hybrid_period else 2)
            if self.family == "hybrid" else (self.cross_attn_period * 2 if self.cross_attn_period else 2),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16 if self.n_heads else None,
            d_ff=128 if not self.is_moe else 32,
            vocab_size=256,
            window=16,
            ssm_state=8 if self.ssm_state else 0,
            ssm_head_dim=16,
            dt_rank=8 if self.family in ("ssm", "hybrid") else 0,
            n_experts=4 if self.is_moe else 0,
            top_k=2 if self.is_moe else 0,
            n_media_tokens=8 if self.n_media_tokens else 0,
            media_embed_dim=32 if self.media_embed_dim else 0,
            hybrid_period=2 if self.hybrid_period else 0,
            cross_attn_period=self.cross_attn_period and 2,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell; reason if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k needs sub-quadratic attention (see DESIGN.md)"
    return True, ""


# Populated by repro_torch.configs.__init__
REGISTRY: dict = {}
