"""Three-term roofline cost model for (arch x shape x plan x resources).

The port's copy of ``repro.core.roofline``: the paper's cost model
f(d, r) -> C transplanted to accelerator jobs.  The "data
characteristics" are the architecture + input shape, the "resources" are
(pods, data degree, tensor degree, microbatch), and the cost is the sum of
three roofline terms:

    compute_s    = FLOPs / (chips * peak_FLOPs)
    memory_s     = HBM traffic / (chips * hbm_bw)
    collective_s = wire bytes / (chips * link_bw)

Two evaluation paths:

* ``terms_for(cfg, shape, r)``         — one Resources tuple, scalar floats.
* ``terms_grid(cfg, shape, resources)`` — an ``(N, 4)`` integer array of
  ``(pods, dp, tp, microbatch)`` configurations in one vectorized call,
  returning per-term arrays (``RooflineGrid``).  ``xp`` is numpy or torch.
  With numpy, or torch in float64, the arithmetic matches ``terms_for``
  and the reference bit for bit (shared expression order).  With torch
  the columns are cast to ``dtype`` (float64 unless asked) and every
  division whose one side is a Python number goes through ``_div``, a
  true IEEE division (PyTorch computes ``c / x`` as ``x.reciprocal() * c``
  and, on the card, ``x / c`` as ``x * (1 / c)``, one rounding more
  than numpy and the CUDA scan kernel).

``RooflineCost`` is one (cfg, shape, plan choice, hw) surface as data:
``cost_model.Surface`` evaluates it (the sharding planner's objective and
masks), and ``csrc/plan_scan.cu`` evaluates the same expressions in
float32 from the constants ``RooflineCost.consts()`` folds.

``HW`` is the planned cluster's per-chip hardware: the reference's target
(a TPU v5e-like chip), kept as data.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

HW = {
    "peak_flops": 197e12,
    "hbm_bw": 819e9,
    "link_bw": 50e9,
    "hbm_bytes": 16e9,
}


@dataclasses.dataclass(frozen=True)
class Resources:
    """The TPU 'resource configuration' (paper: container size x count)."""
    pods: int = 1
    dp: int = 16               # data-parallel degree within pod
    tp: int = 16               # model/tensor degree
    microbatch: int = 1

    @property
    def chips(self) -> int:
        return self.pods * self.dp * self.tp

    def as_tuple(self) -> Tuple[int, int, int, int]:
        return (self.pods, self.dp, self.tp, self.microbatch)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    traffic_per_chip: float
    wire_per_chip: float
    hbm_per_chip: float
    feasible: bool
    model_flops: float                 # 6*N*D (train) / 2*N*B (decode)
    notes: str = ""

    @property
    def step_s(self) -> float:
        # no overlap assumption for the baseline: sum of terms.  The perf
        # pass examines overlap separately.
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved (MFU-like)."""
        if self.step_s <= 0:
            return 0.0
        return self.compute_s / self.step_s


def _attn_seq_factor(cfg: ModelConfig, S: int, schedule: str) -> float:
    """Effective kv length per query position."""
    if cfg.family == "ssm":
        return 0.0
    if cfg.attention == "swa":
        return min(cfg.window, S)
    if cfg.attention == "local_global":
        local = min(cfg.window, S)
        full = S if schedule == "dense" else S / 2
        return 0.5 * local + 0.5 * full
    return S if schedule == "dense" else S / 2


def train_terms(cfg: ModelConfig, shape: ShapeConfig, r: Resources, *,
                schedule: str = "dense", remat: bool = True,
                fsdp: bool = True, seq_shard: bool = True,
                hw: Dict[str, float] = HW) -> RooflineTerms:
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    N = cfg.param_count()
    Na = cfg.active_param_count()
    chips = r.chips
    dp_total = r.pods * r.dp
    tp = r.tp
    notes = []

    # ---------------- FLOPs ----------------
    matmul = (8.0 if remat else 6.0) * Na * tokens     # fwd(2)+remat(2)+bwd(4)
    f_attn = 0.0
    if cfg.has_attention:
        kv_eff = _attn_seq_factor(cfg, S, schedule)
        n_attn = cfg.n_layers if cfg.family != "hybrid" \
            else cfg.n_layers // max(1, cfg.hybrid_period)
        per_layer = 4.0 * tokens * kv_eff * cfg.n_heads * cfg.head_dim
        f_attn = per_layer * n_attn * (3.0 if remat else 2.0) / 2.0 * 2.0 / 2.0
        # fwd = per_layer, bwd = 2x, remat adds fwd again
        f_attn = per_layer * n_attn * ((1 + 1 + 2) if remat else (1 + 2))
    f_ssm = 0.0
    if cfg.family in ("ssm", "hybrid"):
        n_ssm = cfg.n_layers
        f_ssm = 6.0 * tokens * cfg.d_inner * cfg.ssm_state * n_ssm * \
            (4 if remat else 3)
    flops = matmul + f_attn + f_ssm
    model_flops = 6.0 * Na * tokens

    # ---------------- HBM traffic per chip ----------------
    fsdp_deg = r.dp if fsdp else 1
    param_shard = N / (tp * fsdp_deg)
    weight_read = 3.0 * (N / tp) * 2          # fwd + remat + bwd read bf16/tp
    opt_rw = 5.0 * param_shard * 4            # adam m,v,p fp32 rw
    grad_rw = 2.0 * param_shard * 4
    tok_local = tokens / dp_total
    act_d = cfg.d_model * 2
    sp = tp if seq_shard else 1
    act_rw = 12.0 * cfg.n_layers * (tok_local / sp) * act_d \
        + 6.0 * cfg.n_layers * tok_local * act_d / tp
    traffic = weight_read + opt_rw + grad_rw + act_rw
    # microbatching repeats weight gathers/reads per microbatch
    traffic += (r.microbatch - 1) * weight_read * 0.5

    # ---------------- collective wire bytes per chip ----------------
    wire = 0.0
    n_layers = cfg.n_layers
    # TP activation collectives (Megatron-SP): ~4 per layer fwd, 4 bwd
    if tp > 1:
        blocks = 2 if cfg.family not in ("ssm",) else 1
        wire += 2 * 2 * blocks * n_layers * (tok_local * act_d) * (tp - 1) / tp
    # FSDP weight all-gathers: fwd + remat + bwd
    if fsdp and fsdp_deg > 1:
        wire += 3 * (N * 2 / tp) * (fsdp_deg - 1) / fsdp_deg * r.microbatch
    # gradient reduction over (pods x dp): all-reduce of bf16 grads/tp
    red = dp_total if not fsdp else r.pods   # FSDP reduce-scatters within pod
    if fsdp and r.dp > 1:
        wire += (N * 2 / tp) * (r.dp - 1) / r.dp          # reduce-scatter
    if red > 1:
        wire += 2 * (N * 2 / (tp * (fsdp_deg if fsdp else 1))) * (red - 1) / red
    # MoE all-to-all: dispatch+combine, fwd+bwd
    if cfg.is_moe:
        wire += 6.0 * (tokens / chips) * cfg.top_k * act_d

    # ---------------- HBM footprint per chip ----------------
    act_saved = cfg.n_layers * (tok_local / (sp * r.microbatch)) * act_d
    if not remat:
        act_saved *= 8
    hbm = param_shard * 16 + act_saved + (N / tp) * 2
    if cfg.is_moe:
        hbm += 0.0
    feasible = hbm < hw["hbm_bytes"] * 0.92
    if not feasible:
        notes.append(f"OOM est {hbm/1e9:.1f} GB/chip")

    return RooflineTerms(
        compute_s=flops / (chips * hw["peak_flops"]),
        memory_s=traffic / hw["hbm_bw"],
        collective_s=wire / hw["link_bw"],
        flops_per_chip=flops / chips,
        traffic_per_chip=traffic,
        wire_per_chip=wire,
        hbm_per_chip=hbm,
        feasible=feasible,
        model_flops=model_flops,
        notes="; ".join(notes),
    )


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    if cfg.family == "ssm":
        return cfg.n_layers * B * (cfg.d_inner * cfg.ssm_state * 4 +
                                   (cfg.ssm_conv - 1) * cfg.d_inner * 2)
    per_tok = cfg.n_kv_heads * cfg.head_dim * 2 * 2
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(1, cfg.hybrid_period)
        ssm = cfg.n_layers * B * (cfg.n_ssm_heads * cfg.ssm_head_dim *
                                  cfg.ssm_state * 4)
        return n_attn * B * S * per_tok + ssm
    if cfg.attention == "swa":
        S = min(S, cfg.window)
    if cfg.attention == "local_global":
        return (cfg.n_layers // 2) * B * (min(S, cfg.window) + S) * per_tok
    return cfg.n_layers * B * S * per_tok


def decode_terms(cfg: ModelConfig, shape: ShapeConfig, r: Resources, *,
                 weight_mode: str = "stationary",
                 hw: Dict[str, float] = HW) -> RooflineTerms:
    B, S = shape.global_batch, shape.seq_len
    Na = cfg.active_param_count()
    N = cfg.param_count()
    chips = r.chips
    tp = r.tp

    flops = 2.0 * Na * B
    cache = _cache_bytes(cfg, B, S)
    if cfg.has_attention:
        flops += 4.0 * B * _attn_seq_factor(cfg, min(S, 10**9), "dense") * \
            cfg.n_heads * cfg.head_dim * \
            (cfg.n_layers if cfg.family != "hybrid"
             else cfg.n_layers // max(1, cfg.hybrid_period))
    model_flops = 2.0 * Na * B

    # memory: every decode step reads all (sharded) weights + cache
    traffic = (N * 2 / chips if weight_mode == "gathered" else N * 2 / tp) \
        + cache / chips
    wire = 0.0
    if tp > 1:
        wire += 2 * cfg.n_layers * B * cfg.d_model * 2 * (tp - 1) / tp / \
            max(1, r.pods * r.dp)
    if weight_mode == "gathered":
        wire += (N * 2 / tp) * (r.dp - 1) / max(1, r.dp)
    if cfg.is_moe:
        wire += 6.0 * (B / chips) * cfg.top_k * cfg.d_model * 2

    hbm = (N * 2 / chips if weight_mode == "gathered" else N * 2 / tp) \
        + cache / chips
    feasible = hbm < hw["hbm_bytes"] * 0.92

    return RooflineTerms(
        compute_s=flops / (chips * hw["peak_flops"]),
        memory_s=traffic / hw["hbm_bw"],
        collective_s=wire / hw["link_bw"],
        flops_per_chip=flops / chips,
        traffic_per_chip=traffic,
        wire_per_chip=wire,
        hbm_per_chip=hbm,
        feasible=feasible,
        model_flops=model_flops,
        notes="" if feasible else f"OOM est {hbm/1e9:.1f} GB/chip",
    )


def prefill_terms(cfg: ModelConfig, shape: ShapeConfig, r: Resources, *,
                  schedule: str = "dense",
                  hw: Dict[str, float] = HW) -> RooflineTerms:
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    Na = cfg.active_param_count()
    N = cfg.param_count()
    chips = r.chips
    tp = r.tp
    dp_total = r.pods * r.dp

    flops = 2.0 * Na * tokens
    if cfg.has_attention:
        kv_eff = _attn_seq_factor(cfg, S, schedule)
        n_attn = cfg.n_layers if cfg.family != "hybrid" \
            else cfg.n_layers // max(1, cfg.hybrid_period)
        flops += 4.0 * tokens * kv_eff * cfg.n_heads * cfg.head_dim * n_attn / 2
    if cfg.family in ("ssm", "hybrid"):
        flops += 6.0 * tokens * cfg.d_inner * cfg.ssm_state * cfg.n_layers
    model_flops = 2.0 * Na * tokens

    tok_local = tokens / dp_total
    traffic = N * 2 / tp + 6.0 * cfg.n_layers * tok_local * cfg.d_model * 2 \
        + _cache_bytes(cfg, B, S) / chips
    wire = 0.0
    if tp > 1:
        wire += 4 * cfg.n_layers * tok_local * cfg.d_model * 2 * (tp - 1) / tp
    if cfg.is_moe:
        wire += 3.0 * (tokens / chips) * cfg.top_k * cfg.d_model * 2
    hbm = N * 2 / tp + _cache_bytes(cfg, B, S) / chips \
        + tok_local * cfg.d_model * 2 * 4
    feasible = hbm < hw["hbm_bytes"] * 0.92
    return RooflineTerms(
        compute_s=flops / (chips * hw["peak_flops"]),
        memory_s=traffic / hw["hbm_bw"],
        collective_s=wire / hw["link_bw"],
        flops_per_chip=flops / chips,
        traffic_per_chip=traffic,
        wire_per_chip=wire,
        hbm_per_chip=hbm,
        feasible=feasible,
        model_flops=model_flops,
        notes="" if feasible else f"OOM est {hbm/1e9:.1f} GB/chip",
    )


def terms_for(cfg: ModelConfig, shape: ShapeConfig, r: Resources,
              **kw) -> RooflineTerms:
    if shape.kind == "train":
        return train_terms(cfg, shape, r, **kw)
    if shape.kind == "prefill":
        return prefill_terms(cfg, shape, r, **kw)
    return decode_terms(cfg, shape, r, **kw)


def chip_seconds(t: RooflineTerms, r: Resources) -> float:
    """The TPU 'monetary cost' (paper §III-C: container-hours)."""
    return t.step_s * r.chips




# ------------------------- vectorized (grid) path --------------------------- #

def _div(a, b):
    """``a / b`` as one IEEE division wherever a Python number meets a
    tensor (see the module docstring); plain ``/`` otherwise."""
    if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return a / a.new_full((), b)
    if isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        return b.new_full((), a) / b
    return a / b


def _max1(x, xp):
    """``xp.maximum(1, x)``."""
    return torch.clamp_min(x, 1) if xp is torch else xp.maximum(1, x)


@dataclasses.dataclass
class RooflineGrid:
    """Per-term arrays over an (N, 4) batch of resource configurations.
    Field-for-field the array twin of RooflineTerms (minus notes)."""
    compute_s: "np.ndarray"
    memory_s: "np.ndarray"
    collective_s: "np.ndarray"
    flops_per_chip: "np.ndarray"
    traffic_per_chip: "np.ndarray"
    wire_per_chip: "np.ndarray"
    hbm_per_chip: "np.ndarray"
    feasible: "np.ndarray"
    chips: "np.ndarray"
    model_flops: float

    @property
    def step_s(self):
        # same no-overlap sum as RooflineTerms.step_s
        return self.compute_s + self.memory_s + self.collective_s


def _res_cols(resources, xp, dtype=None):
    """(N, 4) array of (pods, dp, tp, microbatch) -> columns: integer for
    numpy (the reference's), ``dtype`` (float64 by default) for torch."""
    a = xp.asarray(resources)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"expected (N, 4) resource configs, got "
                         f"{tuple(a.shape)}")
    if xp is torch:
        a = a.to(dtype or torch.float64)
    return a[:, 0], a[:, 1], a[:, 2], a[:, 3]


# the resource-independent FLOP census of each grid path, shared with
# RooflineCost.consts() (identical expressions, so identical floats)

def _n_attn(cfg: ModelConfig) -> int:
    return cfg.n_layers if cfg.family != "hybrid" \
        else cfg.n_layers // max(1, cfg.hybrid_period)


def _train_flops(cfg: ModelConfig, shape: ShapeConfig, schedule: str,
                 remat: bool) -> Tuple[float, float]:
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    Na = float(cfg.active_param_count())
    matmul = (8.0 if remat else 6.0) * Na * tokens
    f_attn = 0.0
    if cfg.has_attention:
        kv_eff = _attn_seq_factor(cfg, S, schedule)
        per_layer = 4.0 * tokens * kv_eff * cfg.n_heads * cfg.head_dim
        f_attn = per_layer * _n_attn(cfg) * ((1 + 1 + 2) if remat
                                             else (1 + 2))
    f_ssm = 0.0
    if cfg.family in ("ssm", "hybrid"):
        f_ssm = 6.0 * tokens * cfg.d_inner * cfg.ssm_state * cfg.n_layers * \
            (4 if remat else 3)
    return matmul + f_attn + f_ssm, 6.0 * Na * tokens


def _prefill_flops(cfg: ModelConfig, shape: ShapeConfig,
                   schedule: str) -> Tuple[float, float]:
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    Na = float(cfg.active_param_count())
    flops = 2.0 * Na * tokens
    if cfg.has_attention:
        kv_eff = _attn_seq_factor(cfg, S, schedule)
        flops += 4.0 * tokens * kv_eff * cfg.n_heads * cfg.head_dim * \
            _n_attn(cfg) / 2
    if cfg.family in ("ssm", "hybrid"):
        flops += 6.0 * tokens * cfg.d_inner * cfg.ssm_state * cfg.n_layers
    return flops, 2.0 * Na * tokens


def _decode_flops(cfg: ModelConfig,
                  shape: ShapeConfig) -> Tuple[float, float]:
    B, S = shape.global_batch, shape.seq_len
    Na = float(cfg.active_param_count())
    flops = 2.0 * Na * B
    if cfg.has_attention:
        flops += 4.0 * B * _attn_seq_factor(cfg, min(S, 10**9), "dense") * \
            cfg.n_heads * cfg.head_dim * _n_attn(cfg)
    return flops, 2.0 * Na * B


def train_terms_grid(cfg: ModelConfig, shape: ShapeConfig, resources, *,
                     schedule: str = "dense", remat: bool = True,
                     fsdp: bool = True, seq_shard: bool = True,
                     hw: Dict[str, float] = HW, xp=np,
                     dtype=None) -> RooflineGrid:
    """Batched ``train_terms``: identical expression order per element, so
    the numpy and float64 torch paths are bit-identical with the scalar
    loop."""
    pods, dp, tp, mb = _res_cols(resources, xp, dtype)
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    N = float(cfg.param_count())
    chips = pods * dp * tp
    dp_total = pods * dp

    # ---------------- FLOPs (resource-independent for training) ------------
    flops, model_flops = _train_flops(cfg, shape, schedule, remat)

    # ---------------- HBM traffic per chip ----------------
    fsdp_deg = dp if fsdp else 1
    param_shard = _div(N, tp * fsdp_deg)
    weight_read = 3.0 * _div(N, tp) * 2
    opt_rw = 5.0 * param_shard * 4
    grad_rw = 2.0 * param_shard * 4
    tok_local = _div(tokens, dp_total)
    act_d = cfg.d_model * 2
    sp = tp if seq_shard else 1
    act_rw = 12.0 * cfg.n_layers * _div(tok_local, sp) * act_d \
        + 6.0 * cfg.n_layers * tok_local * act_d / tp
    traffic = weight_read + opt_rw + grad_rw + act_rw
    traffic = traffic + (mb - 1) * weight_read * 0.5

    # ---------------- collective wire bytes per chip ----------------
    # each guarded term of the scalar path carries a (x - 1) / x factor
    # that is exactly 0.0 on its guard boundary, so unconditional adds
    # reproduce the scalar branches bit-for-bit
    wire = 0.0
    n_layers = cfg.n_layers
    blocks = 2 if cfg.family not in ("ssm",) else 1
    wire = wire + 2 * 2 * blocks * n_layers * (tok_local * act_d) * \
        (tp - 1) / tp
    if fsdp:
        wire = wire + 3 * _div(N * 2, tp) * (fsdp_deg - 1) / fsdp_deg * mb
    red = dp_total if not fsdp else pods
    if fsdp:
        wire = wire + _div(N * 2, tp) * (dp - 1) / dp
    wire = wire + 2 * _div(N * 2, tp * (fsdp_deg if fsdp else 1)) * \
        (red - 1) / red
    if cfg.is_moe:
        wire = wire + 6.0 * _div(tokens, chips) * cfg.top_k * act_d

    # ---------------- HBM footprint per chip ----------------
    act_saved = cfg.n_layers * (tok_local / (sp * mb)) * act_d
    if not remat:
        act_saved = act_saved * 8
    hbm = param_shard * 16 + act_saved + _div(N, tp) * 2
    feasible = hbm < hw["hbm_bytes"] * 0.92

    return RooflineGrid(
        compute_s=_div(flops, chips * hw["peak_flops"]),
        memory_s=_div(traffic, hw["hbm_bw"]),
        collective_s=_div(wire, hw["link_bw"]),
        flops_per_chip=_div(flops, chips),
        traffic_per_chip=traffic,
        wire_per_chip=wire,
        hbm_per_chip=hbm,
        feasible=feasible,
        chips=chips,
        model_flops=model_flops,
    )


def decode_terms_grid(cfg: ModelConfig, shape: ShapeConfig, resources, *,
                      weight_mode: str = "stationary",
                      hw: Dict[str, float] = HW, xp=np,
                      dtype=None) -> RooflineGrid:
    pods, dp, tp, _mb = _res_cols(resources, xp, dtype)
    B, S = shape.global_batch, shape.seq_len
    N = float(cfg.param_count())
    chips = pods * dp * tp

    flops, model_flops = _decode_flops(cfg, shape)
    # float() static int census: exact in float64 (< 2^53)
    cache = float(_cache_bytes(cfg, B, S))

    weights = _div(N * 2, chips) if weight_mode == "gathered" \
        else _div(N * 2, tp)
    traffic = weights + _div(cache, chips)
    wire = 0.0
    wire = wire + float(2 * cfg.n_layers * B * cfg.d_model * 2) * \
        (tp - 1) / tp / _max1(pods * dp, xp)
    if weight_mode == "gathered":
        wire = wire + _div(N * 2, tp) * (dp - 1) / _max1(dp, xp)
    if cfg.is_moe:
        wire = wire + 6.0 * _div(B, chips) * cfg.top_k * cfg.d_model * 2

    hbm = weights + _div(cache, chips)
    feasible = hbm < hw["hbm_bytes"] * 0.92

    # the reference multiplies the three terms by an exact 1.0 there (a
    # dtype anchor for jax's weak types); leaving it out changes no bit
    return RooflineGrid(
        compute_s=_div(flops, chips * hw["peak_flops"]),
        memory_s=_div(traffic, hw["hbm_bw"]),
        collective_s=_div(wire, hw["link_bw"]),
        flops_per_chip=_div(flops, chips),
        traffic_per_chip=traffic,
        wire_per_chip=wire,
        hbm_per_chip=hbm,
        feasible=feasible,
        chips=chips,
        model_flops=model_flops,
    )


def prefill_terms_grid(cfg: ModelConfig, shape: ShapeConfig, resources, *,
                       schedule: str = "dense",
                       hw: Dict[str, float] = HW, xp=np,
                       dtype=None) -> RooflineGrid:
    pods, dp, tp, _mb = _res_cols(resources, xp, dtype)
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    N = float(cfg.param_count())
    chips = pods * dp * tp
    dp_total = pods * dp

    flops, model_flops = _prefill_flops(cfg, shape, schedule)

    tok_local = _div(tokens, dp_total)
    cache = float(_cache_bytes(cfg, B, S))
    traffic = _div(N * 2, tp) + \
        6.0 * cfg.n_layers * tok_local * cfg.d_model * 2 + _div(cache, chips)
    wire = 0.0
    wire = wire + 4 * cfg.n_layers * tok_local * cfg.d_model * 2 * \
        (tp - 1) / tp
    if cfg.is_moe:
        wire = wire + 3.0 * _div(tokens, chips) * cfg.top_k * \
            cfg.d_model * 2
    hbm = _div(N * 2, tp) + _div(cache, chips) \
        + tok_local * cfg.d_model * 2 * 4
    feasible = hbm < hw["hbm_bytes"] * 0.92
    return RooflineGrid(
        compute_s=_div(flops, chips * hw["peak_flops"]),
        memory_s=_div(traffic, hw["hbm_bw"]),
        collective_s=_div(wire, hw["link_bw"]),
        flops_per_chip=_div(flops, chips),
        traffic_per_chip=traffic,
        wire_per_chip=wire,
        hbm_per_chip=hbm,
        feasible=feasible,
        chips=chips,
        model_flops=model_flops,
    )


def terms_grid(cfg: ModelConfig, shape: ShapeConfig, resources, *,
               xp=np, dtype=None, **kw) -> RooflineGrid:
    """Batched ``terms_for`` over an (N, 4) array of (pods, dp, tp,
    microbatch) configurations.  ``xp`` selects numpy (float64,
    bit-identical with the scalar path) or torch (``dtype`` columns)."""
    if shape.kind == "train":
        return train_terms_grid(cfg, shape, resources, xp=xp, dtype=dtype,
                                **kw)
    if shape.kind == "prefill":
        return prefill_terms_grid(cfg, shape, resources, xp=xp, dtype=dtype,
                                  **kw)
    return decode_terms_grid(cfg, shape, resources, xp=xp, dtype=dtype, **kw)


# ------------------------- the surface as data ------------------------------ #

ROOFLINE_FLAGS = {"remat": 1, "fsdp": 2, "seq_shard": 4, "is_moe": 8,
                  "gathered": 16}


@dataclasses.dataclass(eq=False)
class RooflineCost:
    """The roofline of one (cfg, shape, plan choice) on the hardware
    ``hw``, as the cost model of a ``cost_model.Surface`` (kinds
    ``train``, ``prefill``, ``decode``)."""
    cfg: ModelConfig
    shape: ShapeConfig
    choice: Dict
    hw: Dict[str, float]

    @property
    def kind(self) -> str:
        return self.shape.kind

    def grid(self, cfgs, dtype=None) -> RooflineGrid:
        return terms_grid(self.cfg, self.shape, cfgs, xp=torch, dtype=dtype,
                          hw=self.hw, **self.choice)

    def flags(self) -> int:
        """The plan choice's switches, as csrc/plan_scan.cu reads them."""
        ch = {"remat": True, "fsdp": True, "seq_shard": True, **self.choice}
        on = {"remat": ch["remat"], "fsdp": ch["fsdp"],
              "seq_shard": ch["seq_shard"], "is_moe": self.cfg.is_moe,
              "gathered": ch.get("weight_mode") == "gathered"}
        return sum(ROOFLINE_FLAGS[k] for k, v in on.items() if v)

    def consts(self) -> Tuple[float, ...]:
        """The resource-independent terms in csrc/plan_scan.cu's order
        (N, N * 2, the HBM limit, FLOPs, the three rates, tokens, top_k,
        then five per kind), each folded in float64 exactly as the grid
        path's Python expression folds it before meeting a tensor."""
        cfg, shape, hw = self.cfg, self.shape, self.hw
        B, S = shape.global_batch, shape.seq_len
        N = float(cfg.param_count())
        L = cfg.n_layers
        if shape.kind == "train":
            flops, _ = _train_flops(cfg, shape,
                                    self.choice.get("schedule", "dense"),
                                    self.choice.get("remat", True))
            blocks = 2 if cfg.family not in ("ssm",) else 1
            extra = (12.0 * L, 6.0 * L, cfg.d_model * 2,
                     2 * 2 * blocks * L, L)
        elif shape.kind == "prefill":
            flops, _ = _prefill_flops(cfg, shape,
                                      self.choice.get("schedule", "dense"))
            extra = (6.0 * L, cfg.d_model, 4 * L,
                     float(_cache_bytes(cfg, B, S)), 0)
        else:
            flops, _ = _decode_flops(cfg, shape)
            extra = (float(_cache_bytes(cfg, B, S)),
                     float(2 * L * B * cfg.d_model * 2), B, cfg.d_model, 0)
        return tuple(float(v) for v in (
            N, N * 2, hw["hbm_bytes"] * 0.92, flops, hw["peak_flops"],
            hw["hbm_bw"], hw["link_bw"], B * S, cfg.top_k) + extra)


# --------------------------------------------------------------------------- #
# plan-lint registration: expose the roofline surfaces (one per shape kind,
# with the sharding planner's feasibility masking) to the surface contract
# lint.  Factories are lazy; Surface and TpuCluster are imported inside them
# because cost_model and sharding_planner import this module.
# --------------------------------------------------------------------------- #

def _register_lint_surfaces() -> None:
    from repro_torch.analysis.registry import (CostSurface,
                                               register_cost_surface)

    lint_cfg = ModelConfig(name="lint-dense", family="dense", n_layers=4,
                           d_model=256, n_heads=8, n_kv_heads=8,
                           d_ff=1024, vocab_size=1024)

    def roofline_surface(kind: str) -> None:
        shape = ShapeConfig(name=f"lint-{kind}", seq_len=512,
                            global_batch=8, kind=kind)

        def make_fn():
            # params = [chip_budget, max_chips], masked as
            # ShardingPlanner._grid_fn's surface masks them
            from repro_torch.core.cost_model import Surface
            surface = Surface(RooflineCost(lint_cfg, shape, {}, HW), "time")

            def fn(cfgs, params):
                return surface(cfgs, params)

            fn.surface = surface
            return fn

        def make_cluster():
            from repro_torch.core.sharding_planner import TpuCluster
            return TpuCluster().dims(shape)

        register_cost_surface(CostSurface(
            name=f"tpu/roofline/{kind}", domain="tpu", make_fn=make_fn,
            make_cluster=make_cluster, params=(64.0, 256.0)))

    for kind in ("train", "prefill", "decode"):
        roofline_surface(kind)


_register_lint_surfaces()
