"""The Model API of the six families (the port of
``repro.models.model``), with the full, swa and local_global attention
schedules of the dense, moe and audio families.

    model = build_model(cfg, plan, device="cuda", seed=0)
    hidden, aux, cache = model.forward(batch)              # full sequence
    h = model.final_hidden(hidden)                         # train path
    logits, cache = model.prefill(batch, cache_len)
    logits, cache = model.decode_step(cache, inputs, q_pos)

Batches (numpy arrays or tensors; moved to the model's device):
    dense/moe/ssm/hybrid : {"tokens": (B, S) integer}
    audio (musicgen)     : {"embeddings": (B, S, media_embed_dim)}
    vlm (llama-3.2-v)    : {"tokens": (B, S), "media": (B, M, media_embed_dim)}
each with an optional "positions": (B, S) integer, -1 an invalid slot (a
left-padded prompt's pads), as the reference takes them.
Decode inputs are ``{"tokens": (B, 1)}``, or ``{"embeddings": (B, 1,
media_embed_dim)}`` for the audio family.  Embeddings and media go
through ``projector`` (``media_embed_dim x d_model``) in the compute
dtype.

Parameters live in the module, named by the reference's dict keys
(``embed``, ``final_ln``, ``layers.<i>.attn.wq``, ``shared_attn.attn.wq``,
``cross.<g>.gate_attn``, ...), with weights in the reference's ``(in,
out)`` layout; a Python loop over ``layers`` (an ``nn.ModuleList``)
takes the place of ``lax.scan``.  ``load_jax_params`` carries the
reference's parameter tree across.  Parameters are trainable; serving
runs under ``torch.no_grad`` (``runtime.steps``).  With gradients
enabled, the plan's ``remat`` wraps each layer (a hybrid's and a vlm's
each group, local_global's each pair) as the reference's ``_remat`` wraps
its scan body: ``nothing_saveable`` in ``torch.utils.checkpoint``,
``dots_saveable`` in a selective checkpoint that keeps matmul outputs.

Attention schedules of the dense, moe and audio families: ``full``;
``swa``, every layer windowed to ``cfg.window`` with a rolling cache of
``min(cache_len, window)`` slots; ``local_global``, layers in (local,
global) pairs, layer 2g windowed with a rolling cache, layer 2g + 1 full
with a cache of ``cache_len`` slots.  Prefill attention (K7) takes the
window, decode attention masks by it.

A hybrid model (zamba2) runs its L Mamba2 blocks (or Mamba1 blocks, by
``ssm_version``, as the original Zamba does: their scan is K8) in groups
of ``k = hybrid_period``, each group followed by the one ``shared_attn``
block (full attention through K7 in prefill); the same shared parameters
serve all L / k groups, and autograd sums their gradients.  The ssm
family runs Mamba1 or Mamba2 blocks by ``ssm_version``.  A vlm
(llama-3.2-vision) runs ``g = L / k`` groups, ``k = cross_attn_period``:
k - 1 self-attention blocks (``layers``, K7 in prefill), then the group's
gated cross block (``cross``, an ``nn.ModuleList`` of g) onto the media's
K/V, which each cross block projects once per prefill; so its ``layers``
hold L - L / k blocks (32 of 40 at full size).  Cross attention is plain torch, as the
reference's is plain jnp.

The cache is a flat dict whose leaves have a leading layer (or group)
axis and the batch axis second (``CACHE_BATCH_AXIS``): dense ``k``,
``v`` (L, B, S, KV, hd) and ``slot_pos`` (L, B, S); ssm ``conv`` (L, B,
K-1, d_inner) and ``ssm`` (L, B, d_inner, N), Mamba2's (L, B, H, P, N),
float32; hybrid ``conv`` and ``ssm`` over its L Mamba blocks as in the
ssm family (a Mamba1 hybrid's ``ssm`` (L, B, d_inner, N)), and the
shared block's ``k``, ``v``, ``slot_pos`` over its L / k groups, (L / k,
B, ...); local_global ``k_local``, ``v_local``,
``slot_pos_local`` (L / 2, B, min(S, W), ...) for the local layers and
``k``, ``v``, ``slot_pos`` (L / 2, B, S, ...) for the global ones; vlm
``k``, ``v``, ``slot_pos`` over its self blocks and ``media_k``,
``media_v`` (g, B, M, KV, hd) over its cross blocks; ``pos`` (B,).  The
hybrid's, local_global's and the vlm's layouts are not the reference's
((L / k, k, B, ...) Mamba leaves, (g, k - 1, B, ...) vlm self leaves,
nested ``attn``, ``local``, ``global`` and ``self`` dicts): flat names of
one batch axis each are what ``serve.merge_cache`` scatters along.
``decode_step`` writes the new token's state into the cache tensors in
place and returns the same dict.

Positions are the batch's own ``"positions"`` where it carries them,
else ``arange(S)``, which the reference builds too.  RoPE, every cache
write (a rolling layer's last W, ``attention.prefill_tail``) and the
cache's ``pos`` (the last position + 1) take them.  Prefill attention
(K7) masks by the batch's positions where it carried them, as the
reference's jnp ``flash_attention`` does, and by index otherwise (the
same mask for ``arange(S)``, with K7's tile skip), so a batch without
positions launches exactly what it did before positions were taken.  A
pad at -1 attends to nothing: its row averages V over all keys, as the
reference's does (``kernels.flash_attention``); the Mamba blocks scan the
pads as the reference's do.  ``forward``'s aux holds a moe model's
``lb_loss``, ``z_loss`` and ``drop_frac``, each the mean over the layers
(empty for the other families, and for local_global and the vlm, whose
groups the reference runs without collecting them).

Under an enabled plan (``launch.specs.plan_for`` on a ``DeviceMesh``,
one process per device) the model is distributed: each parameter,
drawn whole from the seeded generator on every rank (or carried across
by ``load_jax_params``), becomes a DTensor of its definition's
placements (``ParallelPlan.placements``) as soon as it is drawn, so the
multi-device model starts from the single-device one's numbers and a
rank never holds more than one whole parameter besides its shards; the
batch's inputs and the positions are sharded by the plan as they enter
(``shard``; a vlm's media and the audio family's frame embeddings as
the reference's ``batch_shardings`` places them, before ``projector``),
and the blocks' constraints place the activations.  Every family runs
under a plan, with each attention schedule, both block schedules
(``"dense"``, ``"causal_skip"``: one K7 launch either way) and both
``tp_mode``s (``"shard_map"``: the explicit Megatron projections,
``transformer``); ``pipeline_stages`` is read by no model path, as in
the reference, so every rank trains the whole model.  ``_check_plan``
raises ``ValueError`` for an unknown ``tp_mode`` or block schedule and
``NotImplementedError`` for a model axis that does not divide the
heads, Mamba's channels or the experts.  A hybrid's ``shared_attn``
block is one set of DTensor parameters that every group reads: autograd
sums their gradients over the groups, placed like the parameters before
the update (``runtime.steps``).  A moe model's aux losses are replicated 0-d
DTensors (``models.moe``).  A vlm's cross blocks attend on each rank's
q heads (``attention.cross_attention``) onto media K/V placed by
``transformer.media_kv_for``.

Serving runs under ``plan_for``'s prefill and decode plans (the
reference's ``serve_plan``), which place every parameter alike: the
decode model is ``model.with_plan(decode_plan)``, over the prefill
model's parameter tensors (``check_shared_params`` raises
``ValueError`` where two plans would place one differently).  The cache
is then a dict of DTensors placed as ``cache_specs`` says (the
reference's rule on the flat names: K/V and ``slot_pos`` along "batch"
and "kv_seq", the Mamba states along "batch" and "inner", the media K/V
and ``pos`` along "batch"); ``init_cache`` allocates on each rank only
its own chunk of each (``sharding.zeros_sharded``).  Below a global
batch of 16 the batch stays whole and "kv_seq" runs over every mesh
axis, data-major; from 16 the batch runs over the data axes and
"kv_seq" over "model".  Prefill builds the cache in place: each layer's
K/V (a rolling layer's last W positions, at slot ``position % W``) go
into each rank's own slots (``attention.write_cache``), the Mamba
states and media K/V into their shards (``store``).  A decode step's
inputs enter ("batch", None[, None]) and q_pos ("batch",), as the
reference's dry run places them; its attention runs on each rank's
slots and reduces over the sequence's mesh dims
(``attention.decode_attention``), its Mamba steps on each rank's
channels, and it updates the cache in place.  A decode step under
``tp_mode="shard_map"`` raises ``ValueError`` (its explicit projections
split a sequence of one token).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import like, rms_norm, softcap
from repro_torch.sharding import (TP_MODES, ParallelPlan, ParamDef,
                                  active_mesh, distribute, init_from_defs,
                                  is_dtensor, single_device_plan,
                                  zeros_sharded)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the batch axis of every cache leaf of every family (merging a prefill
# wave into the live cache scatters along it)
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "slot_pos": 1, "k_local": 1,
                    "v_local": 1, "slot_pos_local": 1, "conv": 1, "ssm": 1,
                    "media_k": 1, "media_v": 1, "pos": 0}
KV_NAMES = ("k", "v", "slot_pos")
# a plan's attention_schedule ("window" is a windowed layer's own)
BLOCK_SCHEDULES = ("dense", "causal_skip")


def resolve_device(device) -> torch.device:
    """``torch.device`` for a model; a CUDA device without a GPU raises
    instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is available for the model; pass "
                           "device='cpu' to run it on the CPU")
    return dev


def check_supported(cfg: ModelConfig,
                    plan: Optional[ParallelPlan] = None) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet
    (on one device, or under ``plan`` when it is enabled), ``ValueError``
    for an enabled plan's unknown ``tp_mode`` or block schedule."""
    if plan is not None and plan.enabled:
        _check_plan(cfg, plan)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_version not in (1, 2):
        raise NotImplementedError(
            f"{cfg.name}: ssm_version={cfg.ssm_version} is not ported yet")


def _check_plan(cfg: ModelConfig, plan: ParallelPlan) -> None:
    if plan.tp_mode not in TP_MODES:
        raise ValueError(f"{plan.name}: tp_mode={plan.tp_mode!r}; expected "
                         f"one of {TP_MODES}")
    if plan.attention_schedule not in BLOCK_SCHEDULES:
        raise ValueError(f"{plan.name}: attention_schedule="
                         f"{plan.attention_schedule!r}; expected one of "
                         f"{BLOCK_SCHEDULES}")
    if plan.mesh is None:
        raise ValueError(f"{plan.name}: an enabled plan needs its mesh "
                         f"(launch.specs.plan_for sets it)")
    names = tuple(plan.mesh.mesh_dim_names)
    tp = plan.mesh.size(names.index("model")) if "model" in names else 1
    split = []              # (what, count) the model axis must divide
    if cfg.family == "vlm":
        # the cross blocks' q heads are the self blocks' n_heads too
        split.append(("attention heads (self and cross)", cfg.n_heads))
    elif cfg.family != "ssm":
        split.append(("attention heads", cfg.n_heads))
    if cfg.family in ("ssm", "hybrid"):
        split.append(("Mamba channels (d_inner)", cfg.d_inner))
        if cfg.ssm_version == 2:
            split.append(("Mamba2 heads", cfg.n_ssm_heads))
    if cfg.is_moe and cfg.n_experts % tp:
        # moe_rules_for's TP-within-expert shards each expert's FFN dim
        split.append((f"expert FFN dims (d_ff; {cfg.n_experts} experts do "
                      f"not split over it)", cfg.d_ff))
    for what, n in split:
        if n % tp:
            raise NotImplementedError(
                f"{cfg.name}: {n} {what} over a model axis of {tp}: a "
                f"tensor-parallel degree must divide them")


REMATS = ("none", "nothing_saveable", "dots_saveable")
# the matmuls whose outputs dots_saveable keeps (jax's dots_saveable keeps
# every dot_general's); einsum and @ reach these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, plan: ParallelPlan):
    """``fn`` (a layer) under the plan's rematerialisation policy; the
    identity for ``"none"`` and whenever gradients are off."""
    if plan.remat not in REMATS:
        raise ValueError(f"remat={plan.remat!r}; expected one of {REMATS}")
    if plan.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if plan.remat == "dots_saveable":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors become trainable
    parameters, dicts sub-trees; indexable by the reference's keys."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _flatten(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def load_jax_params(tree, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree of ``cfg`` (array leaves, layer
    leaves under ``"layers"`` stacked by ``transformer.layer_stack(cfg)``:
    ``(L, ...)``, a hybrid's ``(L / k, k, ...)`` groups beside its
    ``"shared_attn"``, local_global's (local, global) pairs, a vlm's ``(g,
    k - 1, ...)`` self blocks beside its ``(g, ...)`` ``"cross"`` blocks)
    as a state dict of ``Model``: the layers unstacked into
    ``layers.<i>.<path>`` (group g's j-th block is layer ``g * k + j``),
    the cross blocks into ``cross.<g>.<path>``, the rest as it is; CPU
    tensors."""
    stacked = {"layers.": len(tf.layer_stack(cfg)), "cross.": 1}
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        top = name[:name.index(".") + 1] if "." in name else name
        if top in stacked:
            path = name[len(top):]
            arr = arr.reshape((-1,) + arr.shape[stacked[top]:])
            for i in range(arr.shape[0]):
                out[f"{top}{i}.{path}"] = torch.from_numpy(np.array(arr[i]))
        else:
            out[name] = torch.from_numpy(np.array(arr))
    return out


# each cache leaf's logical axes (the reference's ``cache_specs`` rule on
# the port's flat names; a Mamba2 ``ssm`` leaf has one more None)
KV_LOGICAL = (None, "batch", "kv_seq", "kv_heads", None)
CACHE_LOGICAL = {"k": KV_LOGICAL, "v": KV_LOGICAL,
                 "slot_pos": (None, "batch", "kv_seq"),
                 "conv": (None, "batch", None, "inner"),
                 "ssm": (None, "batch", "inner", None),
                 "media_k": (None, "batch", "media", "kv_heads", None),
                 "media_v": (None, "batch", "media", "kv_heads", None),
                 "pos": ("batch",)}


def cache_logical(name: str, ndim: int):
    """The logical axes of cache leaf ``name`` of ``ndim`` dims (a
    local_global model's ``*_local`` leaves as their global twins')."""
    axes = CACHE_LOGICAL[name[:-len("_local")] if name.endswith("_local")
                         else name]
    return axes + (None,) * (ndim - len(axes))


def cache_layout(cfg: ModelConfig, B: int, cache_len: int, dtype):
    """{leaf name: (shape, dtype, fill)} of a cache of ``B`` rows and
    ``cache_len`` slots (a windowed layer's ``min(cache_len, window)``, as
    the reference's)."""
    L = cfg.n_layers
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    i64 = torch.int64

    def kv_cache(n, size=cache_len, sfx=""):
        return {"k" + sfx: ((n, B, size, KV, hd), dtype, 0),
                "v" + sfx: ((n, B, size, KV, hd), dtype, 0),
                "slot_pos" + sfx: ((n, B, size), i64, -1)}

    out = {"pos": ((B,), i64, 0)}
    if cfg.family in ("ssm", "hybrid"):
        di, N, Kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv - 1
        state = (di, N) if cfg.ssm_version == 1 else \
            (cfg.n_ssm_heads, cfg.ssm_head_dim, N)
        out.update(conv=((L, B, Kc, di), dtype, 0),
                   ssm=((L, B) + state, torch.float32, 0))
        if cfg.family == "hybrid":
            out.update(kv_cache(L // cfg.hybrid_period))
        return out
    if cfg.family == "vlm":
        g, M = L // cfg.cross_attn_period, cfg.n_media_tokens
        out.update(kv_cache(math.prod(tf.layer_stack(cfg))))
        out.update({name: ((g, B, M, KV, hd), dtype, 0)
                    for name in ("media_k", "media_v")})
        return out
    window = min(cache_len, cfg.window or cache_len)
    if cfg.attention == "local_global":
        out.update(kv_cache(L // 2, window, "_local"))
        out.update(kv_cache(L // 2))
    else:
        out.update(kv_cache(L, window if cfg.attention == "swa"
                            else cache_len))
    return out


def cache_specs(cfg: ModelConfig, plan: ParallelPlan):
    """{cache leaf name: its mesh-axis assignments under ``plan``} (the
    reference's ``Model.cache_specs``, leaf for leaf on the port's flat
    names)."""
    return {name: plan.spec(cache_logical(name, len(shape)))
            for name, (shape, _, _) in cache_layout(cfg, 1, 1,
                                                    torch.float32).items()}


def store(dst, src) -> None:
    """``src`` written into the cache view ``dst`` in place; DTensors
    shard for shard (``src`` placed as ``dst`` first)."""
    if is_dtensor(dst):
        if src.placements != dst.placements:
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst, src = dst.to_local(), src.to_local()
    dst.copy_(src)


def check_shared_params(cfg: ModelConfig, have: ParallelPlan,
                        want: ParallelPlan) -> None:
    """Raise ``ValueError`` unless the parameters of ``cfg`` are placed
    alike under plans ``have`` and ``want`` (one set of tensors can then
    serve both: a serve plan's prefill and decode models)."""
    if have.enabled != want.enabled or (have.enabled and
                                        have.mesh is not want.mesh):
        raise ValueError(f"{want.name}: the parameters of a model under "
                         f"{have.name} live on another mesh")
    if not have.enabled:
        return
    mesh = active_mesh(have.mesh)
    defs = dict(_flatten(tf.model_defs(cfg)))
    for name, d in defs.items():
        a, b = (p.placements(d.logical, mesh) for p in (have, want))
        if a != b:
            raise ValueError(
                f"{want.name}: parameter {name} is placed {tuple(b)}, not "
                f"{tuple(a)} as under {have.name}: the two plans cannot "
                f"share one set of parameter tensors")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, plan: Optional[ParallelPlan] = None,
                 *, device="cuda", seed: int = 0, impl: str = "cuda"):
        super().__init__()
        self.plan = plan or single_device_plan()
        check_supported(cfg, self.plan)
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.param_dtype = pdt = DTYPES[cfg.param_dtype]
        self.mesh = active_mesh(self.plan.mesh) if self.plan.enabled \
            else None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        place = None if self.mesh is None else self._place
        for k, v in init_from_defs(tf.top_defs(cfg), gen, pdt,
                                   place=place).items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))
        self.layers = nn.ModuleList(
            ParamTree(init_from_defs(tf.layer_defs(cfg), gen, pdt,
                                     place=place))
            for _ in range(math.prod(tf.layer_stack(cfg))))
        if cfg.family == "vlm":
            self.cross = nn.ModuleList(
                ParamTree(init_from_defs(tf.cross_block_defs(cfg), gen, pdt,
                                         place=place))
                for _ in range(cfg.n_layers // cfg.cross_attn_period))

    def param_defs(self) -> Dict[str, ParamDef]:
        """Each named parameter's definition (a layer's without the
        reference's stacked dims)."""
        cfg = self.cfg
        out = dict(_flatten(tf.top_defs(cfg)))
        for i in range(len(self.layers)):
            out.update(_flatten(tf.layer_defs(cfg), f"layers.{i}."))
        for g in range(len(getattr(self, "cross", ()))):
            out.update(_flatten(tf.cross_block_defs(cfg), f"cross.{g}."))
        return out

    def _place(self, d: ParamDef, t: torch.Tensor):
        """A tensor of definition ``d``, whole and equal on every rank, as
        this rank's shard: a DTensor of ``d``'s placements (a sharded
        one's own copy, so the whole tensor is freed)."""
        return distribute(t.to(self.device), self.mesh,
                          self.plan.placements(d.logical, self.mesh))

    def load_jax_params(self, tree) -> "Model":
        """Copy the reference's parameter tree into this model (each
        rank's shard of it, when distributed)."""
        state = load_jax_params(tree, self.cfg)
        if self.mesh is not None:
            defs = self.param_defs()
            state = {k: self._place(defs[k], t) for k, t in state.items()}
        self.load_state_dict(state)
        return self

    def shard(self, t: torch.Tensor, logical) -> torch.Tensor:
        """An input every rank holds whole (a batch's tokens or labels,
        the positions) as this rank's shard of a DTensor of the plan's
        placements for ``logical``; ``t`` itself on one device."""
        if self.mesh is None:
            return t
        return distribute(t.contiguous(), self.mesh,
                          self.plan.placements(logical, self.mesh))

    def _attn_layout(self, i: int):
        """Layer ``i``'s attention in a dense, moe, audio or vlm model: (the
        suffix of its cache leaves' names, its index along their layer
        axis, its window or None; a vlm's self blocks attend in full under
        any schedule, as the reference's vlm branch runs them)."""
        cfg = self.cfg
        if cfg.family == "vlm":
            return "", i, None
        if cfg.attention == "swa":
            return "", i, cfg.window
        if cfg.attention == "local_global":
            return ("_local", i // 2, cfg.window) if i % 2 == 0 else \
                ("", i // 2, None)
        return "", i, None

    # ------------------------------------------------------------------ #
    def _index(self, x) -> torch.Tensor:
        """Token ids or positions (numpy or torch) as int64 on the device."""
        return torch.as_tensor(x, device=self.device).to(torch.int64)

    def _project(self, x, logical) -> torch.Tensor:
        """Embeddings or media (numpy or torch, (B, n, media_embed_dim))
        through ``projector``, in the compute dtype.  Under a plan the
        input enters sharded by ``logical``; the product takes it whole
        but for the batch, and the projector, FSDP-sharded in d over
        "data", whole (torch 2.11's DTensor refuses a matmul of a
        sequence-sharded 3-D tensor: ROADMAP, "torch versions")."""
        x = self.shard(torch.as_tensor(x, device=self.device).to(self.dtype),
                       logical)
        x = self.plan.constrain(x, ("batch", None, None))
        w = self.plan.constrain(self.projector, (None, None))
        return x @ w.to(self.dtype)

    def _embed(self, batch):
        cfg, plan = self.cfg, self.plan
        if cfg.embed_inputs:
            tokens = self.shard(self._index(batch["tokens"]),
                                ("batch", "seq"))
            # the lookup takes the table's vocab shards whole in d
            table = plan.constrain(self.embed, ("vocab", None))
            x = F.embedding(tokens, table).to(self.dtype)
        else:
            x = self._project(batch["embeddings"], ("batch", "seq", None))
        if cfg.scale_embeddings:
            # the factor rounded to the compute dtype, as the reference's
            # (a replicated DTensor beside a DTensor x)
            x = x * like(torch.tensor(cfg.d_model ** 0.5, dtype=self.dtype,
                                      device=self.device), x)
        return plan.constrain(x, ("batch", "seq", None))

    def _media(self, batch):
        """A vlm batch's media (B, M, media_embed_dim) projected to
        (B, M, d_model), the batch sharded as the reference's
        ``batch_shardings`` places it."""
        return self._project(batch["media"], ("batch", None, None))

    def logits(self, hidden):
        cfg = self.cfg
        h = self.plan.constrain(rms_norm(hidden, self.final_ln, cfg.norm_eps),
                                ("batch", None, None))
        head = self.embed.T if cfg.tie_embeddings else self.head
        # h.dtype operands, float32 products and sums
        out = h.float() @ head.to(h.dtype).float()
        out = self.plan.constrain(out, ("batch", None, "vocab"))
        return softcap(out, cfg.final_softcap)

    def final_hidden(self, hidden):
        return rms_norm(hidden, self.final_ln, self.cfg.norm_eps)

    # ====================== full-sequence forward ====================== #
    def forward(self, batch, *, build_cache: bool = False,
                cache_len: Optional[int] = None):
        """Returns (hidden (B,S,d), aux dict, cache-or-None).  The batch's
        own ``"positions"`` (B, S), where it carries them, mask K7 and
        place RoPE and the cache writes (module docstring)."""
        cfg = self.cfg
        x = self._embed(batch)
        B, S = x.shape[:2]
        if "positions" in batch:
            positions = self._index(batch["positions"]).contiguous()
            if tuple(positions.shape) != (B, S):
                raise ValueError(f"positions {tuple(positions.shape)} for "
                                 f"a batch of {(B, S)}")
        else:
            positions = torch.arange(S, device=self.device).expand(B, S)
        positions = self.shard(positions, ("batch", None))
        # K7 masks by the batch's own positions, else by index
        kw = dict(positions=positions, attn_positions=positions
                  if "positions" in batch else None)
        cache, aux = None, {}
        if build_cache:
            cache = self.init_cache(B, cache_len or S)

        def write_kv(kv, sfx, j, window=None):
            k, v, pos = kv[0], kv[1], positions
            if window:
                k, v, pos = attn.prefill_tail(k, v, pos, window)
            attn.write_cache(*(cache[n + sfx][j] for n in KV_NAMES), k, v,
                             pos, rolling_window=window)

        if cfg.family == "vlm":
            k = tf.layer_groups(cfg)
            media = self._media(batch)
            for g in range(len(self.cross)):
                x, group_kvs, mkv = remat(functools.partial(
                    self._vlm_group, g=g, k=k, **kw), self.plan)(x, media)
                if build_cache:
                    for j, kv in enumerate(group_kvs, g * k):
                        write_kv(kv, "", j)
                    store(cache["media_k"][g], mkv[0])
                    store(cache["media_v"][g], mkv[1])
        elif cfg.family in ("ssm", "hybrid"):
            # an ssm model is one group per layer with no shared block
            k = cfg.hybrid_period if cfg.family == "hybrid" else 1
            for g in range(cfg.n_layers // k):
                x, states, kv = remat(functools.partial(
                    self._mamba_group, g=g, k=k, **kw), self.plan)(x)
                if build_cache:
                    for i, (conv, ssm) in enumerate(states, g * k):
                        store(cache["conv"][i], conv)
                        store(cache["ssm"][i], ssm)
                    if kv is not None:
                        write_kv(kv, "", g)
        else:
            # one layer a group; local_global's (local, global) pairs
            k = tf.layer_groups(cfg)
            layer_aux = []
            for g in range(cfg.n_layers // k):
                x, kvs, auxs = remat(functools.partial(
                    self._dense_group, g=g, k=k, **kw), self.plan)(x)
                if build_cache:
                    for i, kv in enumerate(kvs, g * k):
                        write_kv(kv, *self._attn_layout(i))
                layer_aux += [a for a in auxs if a is not None]
            # the reference's local_global branch collects no aux
            if layer_aux and cfg.attention != "local_global":
                aux = {k: torch.stack([a[k] for a in layer_aux]).mean()
                       for k in layer_aux[0]}
        if build_cache:
            store(cache["pos"], positions[:, -1] + 1)
        return x, aux, cache

    def _dense_group(self, x, *, g: int, k: int, positions, attn_positions):
        """Group ``g``: blocks ``g*k .. g*k+k-1``, each with its window.
        Returns (x, [(k, v) per block], [aux or None per block])."""
        kvs, auxs = [], []
        for i in range(g * k, (g + 1) * k):
            x, kv, aux_l = tf.dense_block(
                self.layers[i], x, self.cfg, self.plan, positions,
                window=self._attn_layout(i)[2], impl=self.impl,
                attn_positions=attn_positions)
            kvs.append(kv)
            auxs.append(aux_l)
        return x, kvs, auxs

    def _vlm_group(self, x, media, *, g: int, k: int, positions,
                   attn_positions):
        """A vlm's group ``g``: self blocks ``g*k .. g*k+k-1``, then cross
        block ``g`` onto the media.  Returns (x, [(k, v) per self block],
        the cross block's media (k, v))."""
        x, kvs, _ = self._dense_group(x, g=g, k=k, positions=positions,
                                      attn_positions=attn_positions)
        p = self.cross[g]
        mkv = tf.media_kv_for(p["attn"], media, self.cfg, self.plan)
        return tf.cross_attn_block(p, x, mkv, self.cfg, self.plan), kvs, mkv

    def _mamba_group(self, x, *, g: int, k: int, positions,
                     attn_positions):
        """Group ``g``: Mamba blocks ``g*k .. g*k+k-1``, then a hybrid's
        shared attention block.  Returns (x, [(conv, ssm) state per
        block], the shared block's (k, v) or None)."""
        cfg, states = self.cfg, []
        for p in self.layers[g * k:(g + 1) * k]:
            x, conv_st, ssm_st = tf.mamba_block(p, x, cfg, self.plan,
                                                impl=self.impl)
            states.append((conv_st, ssm_st))
        kv = None
        if cfg.family == "hybrid":
            x, kv, _ = tf.dense_block(self.shared_attn, x, cfg, self.plan,
                                      positions, impl=self.impl,
                                      attn_positions=attn_positions)
        return x, states, kv

    # ============================ prefill ============================== #
    def prefill(self, batch, cache_len: Optional[int] = None):
        hidden, _, cache = self.forward(batch, build_cache=True,
                                        cache_len=cache_len)
        # the last position, from the sequence gathered whole
        hidden = self.plan.constrain(hidden, ("batch", None, None))
        logits = self.logits(hidden[:, -1:])[:, 0]
        return logits, cache

    # ============================ decode =============================== #
    def decode_step(self, cache, inputs, q_pos):
        """inputs: {"tokens": (B, 1)} (the audio family's {"embeddings":
        (B, 1, media_embed_dim)}); q_pos: (B,) position of the new token.
        Returns (logits (B, V) f32, cache), the cache's tensors updated in
        place (a vlm's media K/V are read, not written).  Under a plan the
        inputs enter ("batch", None[, None]) and q_pos ("batch",), as the
        reference's dry run places them, and each rank writes and reads
        its own shards of the cache."""
        cfg, plan = self.cfg, self.plan
        if plan.enabled and plan.tp_mode == "shard_map":
            raise ValueError(
                f"{plan.name}: tp_mode='shard_map' does not decode: its "
                f"explicit projections split the sequence over 'model', "
                f"and a decode step's is one token (ROADMAP §1, serving "
                f"under shard_map)")
        q_pos = self.shard(self._index(q_pos), ("batch",))
        x = self._embed(inputs)
        if cfg.family in ("ssm", "hybrid"):
            k = cfg.hybrid_period if cfg.family == "hybrid" else 1
            for i, p in enumerate(self.layers):
                x, conv_st, ssm_st = tf.mamba_block(
                    p, x, cfg, plan, conv_state=cache["conv"][i],
                    ssm_state=cache["ssm"][i], decode=True, impl=self.impl)
                store(cache["conv"][i], conv_st)
                store(cache["ssm"][i], ssm_st)
                if cfg.family == "hybrid" and (i + 1) % k == 0:
                    g = i // k
                    layer_cache = {n: cache[n][g] for n in KV_NAMES}
                    x, _ = tf.dense_block_decode(self.shared_attn, x, cfg,
                                                 plan, layer_cache, q_pos)
        else:
            k = tf.layer_groups(cfg)
            for i, p in enumerate(self.layers):
                sfx, j, window = self._attn_layout(i)
                layer_cache = {n: cache[n + sfx][j] for n in KV_NAMES}
                x, _ = tf.dense_block_decode(p, x, cfg, plan, layer_cache,
                                             q_pos, window=window)
                if cfg.family == "vlm" and (i + 1) % k == 0:
                    g = i // k
                    x = tf.cross_attn_block(
                        self.cross[g], x,
                        (cache["media_k"][g], cache["media_v"][g]), cfg,
                        plan)
        store(cache["pos"], q_pos + 1)
        logits = self.logits(x)[:, 0]
        return logits, cache

    # ========================= cache allocation ======================== #
    def cache_specs(self):
        """{cache leaf name: mesh-axis assignments} under the model's plan
        (the reference's ``cache_specs``, on the port's flat names)."""
        return cache_specs(self.cfg, self.plan)

    def init_cache(self, B: int, cache_len: int, device=None):
        """Zero-initialised cache (a windowed layer's of ``min(cache_len,
        window)`` slots, as the reference's; ``slot_pos`` -1, every slot
        empty).  Under an enabled plan each leaf is a DTensor placed as
        ``cache_specs`` says, of which each rank allocates only its own
        shard (``sharding.zeros_sharded``).  On the meta device (``device=
        "meta"``) the leaves are meta tensors of the whole shapes, the
        reference's ``eval_shape`` of ``init_cache``."""
        device = self.device if device is None else torch.device(device)
        out = {}
        for name, (shape, dt, fill) in cache_layout(
                self.cfg, B, cache_len, self.dtype).items():
            if self.mesh is None or device.type == "meta":
                out[name] = torch.full(shape, fill, dtype=dt, device=device)
            else:
                out[name] = zeros_sharded(
                    shape, dt, self.mesh, self.plan.placements(
                        cache_logical(name, len(shape)), self.mesh),
                    fill=fill, device=device)
        return out

    def with_plan(self, plan: ParallelPlan) -> "Model":
        """This model under ``plan``, over the same parameter tensors (no
        copy): a serve plan's decode model beside its prefill model, as
        the reference passes one params tree to both.  Raises
        ``ValueError`` where ``plan`` would place a parameter otherwise
        than the model's plan does (``check_shared_params``)."""
        check_shared_params(self.cfg, self.plan, plan)
        check_supported(self.cfg, plan)
        other = Model.__new__(Model)
        nn.Module.__init__(other)
        for k, v in self.__dict__.items():
            if not k.startswith("_"):
                setattr(other, k, v)
        for k, v in self._parameters.items():
            other.register_parameter(k, v)
        for k, m in self._modules.items():
            other.add_module(k, m)
        other.plan = plan
        return other


def build_model(cfg: ModelConfig, plan: Optional[ParallelPlan] = None, *,
                device="cuda", seed: int = 0, impl: str = "cuda") -> Model:
    """A model of ``cfg`` under ``plan`` (default ``single_device_plan()``)
    with parameters drawn by ``init_from_defs`` from a generator seeded
    with ``seed`` on ``device`` (the GPU unless the caller asks for the
    CPU; without a GPU that raises)."""
    return Model(cfg, plan, device=device, seed=seed, impl=impl)
