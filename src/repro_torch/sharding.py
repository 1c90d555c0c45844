"""Parameter definitions and the single-device parallel plan (the port's
part of ``repro.sharding``).

``ParamDef``, ``stack_defs`` and ``init_from_defs`` are the single source
of truth for shapes, logical axes and initialisation.  ``ParallelPlan``
carries only the fields a single-device step reads (``remat``,
``microbatch``, ``ssm_chunk`` and the MoE grouping, ``moe_group_size`` and
``moe_target_groups``); the reference's sharding rules, mesh and
tensor-parallel modes wait for the multi-device slice.  On one device the
reference's ``ParallelPlan.constrain`` is the identity and its
``col_parallel_project`` / ``row_parallel_project`` are ``x @
w.astype(x.dtype)``; the model code writes those out directly.  The
logical axis names are kept so a later multi-GPU slice can map them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """A parallelism plan for one (arch x shape), cut to one device."""
    # per layer: none | nothing_saveable (torch.utils.checkpoint) |
    # dots_saveable (a selective checkpoint that keeps matmul outputs)
    remat: str = "nothing_saveable"
    microbatch: int = 1               # gradient-accumulation steps
    moe_group_size: int = 2048        # tokens routed together (a group)
    moe_target_groups: int = 1        # aim for >= this many groups
    # time steps the selective scan's backward recomputes at a time
    ssm_chunk: int = 256

    def with_(self, **kw) -> "ParallelPlan":
        return dataclasses.replace(self, **kw)


def single_device_plan() -> ParallelPlan:
    return ParallelPlan(remat="none")


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | scaled | const
    scale: float = 0.02
    const: float = 0.0

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def stack_defs(tree, n: int):
    """Prepend a stacked-layers dim of size n to every ParamDef leaf."""
    if isinstance(tree, ParamDef):
        return dataclasses.replace(tree, shape=(n,) + tree.shape,
                                   logical=(None,) + tree.logical)
    return {k: stack_defs(v, n) for k, v in tree.items()}


def init_from_defs(defs, generator: torch.Generator, dtype: torch.dtype,
                   device=None) -> Dict[str, Any]:
    """Materialise params from defs with the reference's distributions:
    normal x scale, normal x fan_in^-1/2 ("scaled", fan_in = shape[-2]),
    zeros, ones, const.  Leaves are drawn in sorted key order (the order
    jax flattens a dict) from ``generator``, which lives on ``device``;
    the numbers differ from jax.random's for the same seed."""
    device = generator.device if device is None else torch.device(device)

    def draw(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        if d.init == "const":
            return torch.full(d.shape, d.const, dtype=dtype, device=device)
        out = torch.randn(d.shape, generator=generator, dtype=dtype,
                          device=device)
        if d.init == "scaled":   # fan-in scaled
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            return out.mul_(fan_in ** -0.5)
        return out.mul_(d.scale)

    def walk(tree):
        if isinstance(tree, ParamDef):
            return draw(tree)
        return {k: walk(tree[k]) for k in sorted(tree)}

    return walk(defs)
