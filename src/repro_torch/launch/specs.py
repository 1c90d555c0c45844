"""The plan of every (arch x shape) cell, and meta-tensor stand-ins with
their placements (the port of ``repro.launch.specs``).

No device memory: the stand-ins are meta tensors (the reference's
``ShapeDtypeStruct``).  ``plan_for`` picks the canonical ParallelPlan per
shape kind, line for line the reference's (the RAQO sharding planner
picks the mesh it runs on).  It reads only the mesh's axis names and
sizes, so a stand-in with ``mesh_dim_names`` and ``shape`` serves where
no process group exists.  A model runs every plan ``plan_for`` makes:
the train plan with any of the reference's overrides (``tp_mode``,
``attention_schedule``, ``pipeline_stages``, ``remat``, ...), and the
prefill and decode plans of ``serve_plan`` (the cache's sequence over
"kv_seq", ``models.model``), whose decode inputs ``decode_input_specs``
gives.  Under a decode plan ``tp_mode="shard_map"`` raises
``ValueError``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding import (ParallelPlan, defs_to_shapes, mesh_shape,
                                  moe_rules_for, serve_plan, train_plan)


def plan_for(cfg: ModelConfig, shape: ShapeConfig, mesh,
             **overrides) -> ParallelPlan:
    sizes = mesh_shape(mesh)
    axes = tuple(sizes)
    n_dev = 1
    for a in axes:
        n_dev *= sizes[a]
    weight_mode = overrides.pop("serve_weight_mode", "stationary")
    if shape.kind == "train":
        plan = train_plan(axes)
    elif shape.kind == "prefill":
        plan = serve_plan(axes, global_batch=shape.global_batch,
                          weight_mode=weight_mode)
        plan = plan.with_(seq_shard=True, rules=tuple(
            (k, ("model" if k == "seq" else v)) for k, v in plan.rules))
    else:
        plan = serve_plan(axes, global_batch=shape.global_batch,
                          weight_mode=weight_mode)
        # decode moves <= a few hundred tokens: keep the MoE dispatch
        # token-replicated, experts sharded
        plan = plan.with_(rules=tuple(
            (k, (None if k == "tokens" else v)) for k, v in plan.rules))
    # MoE grouping adapts to token count so groups shard over the mesh
    plan = plan.with_(
        moe_target_groups=1 if shape.kind == "decode" else n_dev, mesh=mesh)
    if cfg.is_moe:
        plan = moe_rules_for(plan, cfg.n_experts, sizes["model"])
    if overrides:
        plan = plan.with_(**overrides)
    return plan


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                with_labels: bool = True) -> Dict[str, torch.Tensor]:
    """The batch's inputs as meta tensors."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    out: Dict[str, torch.Tensor] = {}
    if cfg.embed_inputs:
        out["tokens"] = meta((B, S), torch.int32)
    else:
        out["embeddings"] = meta((B, S, cfg.media_embed_dim), torch.float32)
    if cfg.family == "vlm":
        out["media"] = meta((B, cfg.n_media_tokens, cfg.media_embed_dim),
                            torch.float32)
    if with_labels:
        out["labels"] = meta((B, S), torch.int32)
    return out


def batch_logical(cfg: ModelConfig, with_labels: bool = True
                  ) -> Dict[str, Tuple]:
    """Each batch input's logical axes."""
    out: Dict[str, Tuple] = {}
    if cfg.embed_inputs:
        out["tokens"] = ("batch", "seq")
    else:
        out["embeddings"] = ("batch", "seq", None)
    if cfg.family == "vlm":
        out["media"] = ("batch", None, None)
    if with_labels:
        out["labels"] = ("batch", "seq")
    return out


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    plan: ParallelPlan, with_labels: bool = True):
    """Each batch input's DTensor placements on ``mesh``."""
    return {k: plan.placements(v, mesh)
            for k, v in batch_logical(cfg, with_labels).items()}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, model
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor], torch.Tensor]:
    """(inputs, cache, q_pos) of a decode step, as meta tensors: one new
    token (the audio family's frame embedding) against a cache of
    ``shape.seq_len`` slots (``model.init_cache`` on the meta device; its
    placements are ``model.cache_specs()``)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.embed_inputs:
        inputs = {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                        device="meta")}
    else:
        inputs = {"embeddings": torch.empty((B, 1, cfg.media_embed_dim),
                                            dtype=torch.float32,
                                            device="meta")}
    cache = model.init_cache(B, S, device="meta")
    q_pos = torch.empty((B,), dtype=torch.int32, device="meta")
    return inputs, cache, q_pos


def train_state_specs(model) -> Tuple[Any, Any]:
    """(state of meta tensors, state of specs) for a ``TrainState`` of
    ``model``: its named parameters, float32 moments keyed alike."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.runtime.steps import TrainState
    defs = model.param_defs()
    p_shapes = {k: torch.empty(d.shape, dtype=model.param_dtype,
                               device="meta") for k, d in defs.items()}
    m_shapes = {k: torch.empty(d.shape, dtype=torch.float32, device="meta")
                for k, d in defs.items()}
    step = torch.empty((), dtype=torch.int32, device="meta")
    state = TrainState(params=p_shapes,
                       opt_state=OptState(step=step, m=m_shapes,
                                          v=dict(m_shapes)),
                       step=step)
    specs = {k: model.plan.spec(d.logical) for k, d in defs.items()}
    state_specs = TrainState(
        params=specs, opt_state=OptState(step=(), m=specs, v=dict(specs)),
        step=())
    return state, state_specs


def serve_param_specs(cfg: ModelConfig, model=None,
                      dtype: torch.dtype = torch.bfloat16):
    """Serving params are bf16 (halves HBM): the parameter tree (the
    reference's stacked layout) as meta tensors."""
    from repro_torch.models.transformer import model_defs
    return defs_to_shapes(model_defs(cfg), dtype)
