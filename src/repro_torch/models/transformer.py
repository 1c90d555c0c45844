"""Decoder blocks of the six families (dense, moe, ssm, hybrid, audio,
vlm), and their parameter definitions (the port of
``repro.models.transformer``).

``model_defs`` gives the reference's parameter tree with its stacked
layer leaves (``layer_stack(cfg)`` leading dims: ``(L, ...)``; the
hybrid's ``(L / k, k, ...)`` groups of ``k = hybrid_period`` Mamba
blocks (Mamba2, or Mamba1 by ``ssm_version``) beside one unstacked
``shared_attn`` block; local_global's
``(L / 2, 2, ...)`` (local, global) pairs; the vlm's ``(g, k - 1, ...)``
self-attention blocks, ``k = cross_attn_period``, beside ``cross``, its
g gated cross-attention blocks ``(g, ...)``); the port's ``Model`` holds
one module per block and loops over them in Python where the reference
runs ``lax.scan``.  Block functions take ``p`` as anything indexable by
the reference's keys (a ``ParamTree`` module or a nested dict).  The
dense block calls ``plan.constrain`` and the plan's column/row-parallel
projections where the reference does (q, k, v, the MLP's gate, the
projections and both residuals): under a multi-device plan they place
the block's DTensors, on one device the constraint is the identity and
a projection is ``x @ w.to(x.dtype)``.  Under ``tp_mode="shard_map"``
the projections the reference writes through the plan (q and ``wo`` of
a self-attention block, every MLP's) take the explicit collectives
(``sharding.explicit_col_project`` / ``explicit_row_project``), q from
the sequence-sharded input as the reference's ``in_specs`` take it; a
cross block's q and ``wo`` and the Mamba mixers', plain einsums in the
reference, keep the GSPMD form.

Each block runs in two modes: full sequence (prefill, returning the K/V
or SSM state for the cache) and one-token decode against a cache.  A moe
block is a dense block whose MLP is ``moe.moe_ffn``; a Mamba block runs
the Mamba1 or the Mamba2 mixer by ``cfg.ssm_version``.  The audio family
runs dense blocks on projected frame embeddings (no ``embed``).  A vlm
cross-attention block (``cross_attn_block``) attends from the text onto
the projected media's K/V (``media_kv_for``, no RoPE), its attention and
MLP residuals gated by ``tanh`` of 0-d parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import activate, rms_norm, rope
from repro_torch.models.moe import moe_ffn
from repro_torch.sharding import ParamDef, single_device_plan, stack_defs

_SINGLE = single_device_plan()


# =========================== parameter definitions ========================= #

def attn_defs(cfg, *, cross: bool = False) -> Dict[str, ParamDef]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": ParamDef((d, H * hd), ("embed", "heads")),
        "wk": ParamDef((d, KV * hd), ("embed", "kv")),
        "wv": ParamDef((d, KV * hd), ("embed", "kv")),
        "wo": ParamDef((H * hd, d), ("heads", "embed"), init="scaled"),
    }
    if cfg.qk_norm or cross:
        out["q_norm"] = ParamDef((hd,), (None,), init="zeros")
        out["k_norm"] = ParamDef((hd,), (None,), init="zeros")
    return out


def mlp_defs(cfg) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    out = {"w1": ParamDef((d, f), ("embed", "ff")),
           "w2": ParamDef((f, d), ("ff", "embed"), init="scaled")}
    if cfg.activation in ("swiglu", "geglu"):
        out["w3"] = ParamDef((d, f), ("embed", "ff"))
    return out


def block_defs(cfg, *, moe: bool = False) -> Dict[str, Any]:
    d = cfg.d_model
    out: Dict[str, Any] = {
        "ln1": ParamDef((d,), (None,), init="zeros"),
        "attn": attn_defs(cfg),
        "ln2": ParamDef((d,), (None,), init="zeros"),
    }
    if cfg.post_norms:
        out["ln1p"] = ParamDef((d,), (None,), init="zeros")
        out["ln2p"] = ParamDef((d,), (None,), init="zeros")
    if moe:
        E, f = cfg.n_experts, cfg.d_ff
        out["moe"] = {
            "router": ParamDef((d, E), ("embed", None)),
            "w1": ParamDef((E, d, f), ("experts", "embed", "ff_expert")),
            "w3": ParamDef((E, d, f), ("experts", "embed", "ff_expert")),
            "w2": ParamDef((E, f, d), ("experts", "ff_expert", "embed"),
                           init="scaled"),
        }
    else:
        out["mlp"] = mlp_defs(cfg)
    return out


def cross_block_defs(cfg) -> Dict[str, Any]:
    """A vlm cross-attention block: q from the text, k and v from the
    media, QK-norm, an MLP, and the two 0-d gates (zeros at init, so a
    fresh block adds nothing)."""
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), (None,), init="zeros"),
        "attn": attn_defs(cfg, cross=True),
        "gate_attn": ParamDef((), (), init="zeros"),
        "ln2": ParamDef((d,), (None,), init="zeros"),
        "mlp": mlp_defs(cfg),
        "gate_mlp": ParamDef((), (), init="zeros"),
    }


def mamba_defs(cfg) -> Dict[str, Any]:
    """Mamba block parameters: Mamba1's (``ssm_version == 1``) or
    Mamba2's."""
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    out: Dict[str, Any] = {
        "ln": ParamDef((d,), (None,), init="zeros"),
        "conv_w": ParamDef((di, K), ("inner", None), init="scaled"),
        "conv_b": ParamDef((di,), ("inner",), init="zeros"),
        "out_proj": ParamDef((di, d), ("inner", "embed"), init="scaled"),
    }
    if cfg.ssm_version == 1:
        R = cfg.dt_rank
        out.update({
            "in_proj": ParamDef((d, 2 * di), ("embed", "inner")),
            "x_proj": ParamDef((di, R + 2 * N), ("inner", None)),
            "dt_proj": ParamDef((R, di), (None, "inner")),
            "dt_bias": ParamDef((di,), ("inner",), init="const", const=-4.0),
            "A_log": ParamDef((di, N), ("inner", None), init="const",
                              const=0.0),
            "D": ParamDef((di,), ("inner",), init="ones"),
        })
    else:
        H = cfg.n_ssm_heads
        out.update({
            "in_proj_xz": ParamDef((d, 2 * di), ("embed", "inner")),
            "in_proj_bc": ParamDef((d, 2 * N), ("embed", None)),
            "in_proj_dt": ParamDef((d, H), ("embed", "inner")),
            "dt_bias": ParamDef((H,), ("inner",), init="const", const=-4.0),
            "A_log": ParamDef((H,), ("inner",), init="const", const=0.0),
            "D": ParamDef((H,), ("inner",), init="ones"),
            "norm": ParamDef((di,), ("inner",), init="zeros"),
        })
    return out


def layer_defs(cfg) -> Dict[str, Any]:
    """One layer's parameter definitions (a hybrid's layers are its
    Mamba blocks, a vlm's its self-attention blocks)."""
    if cfg.family in ("ssm", "hybrid"):
        return mamba_defs(cfg)
    return block_defs(cfg, moe=cfg.is_moe)


def top_defs(cfg) -> Dict[str, Any]:
    """The parameters outside the layer stacks: ``embed`` unless the
    inputs are embeddings, ``head`` unless tied, the media or frame
    ``projector``, a hybrid's shared attention block.  (A vlm's cross
    blocks are ``cross_block_defs``, g of them.)"""
    d = cfg.d_model
    out: Dict[str, Any] = {"final_ln": ParamDef((d,), (None,), init="zeros")}
    if cfg.embed_inputs:
        out["embed"] = ParamDef((cfg.vocab_size, d), ("vocab", "embed"))
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((d, cfg.vocab_size), ("embed", "vocab"),
                               init="scaled")
    if cfg.media_embed_dim:
        out["projector"] = ParamDef((cfg.media_embed_dim, d),
                                    (None, "embed"), init="scaled")
    if cfg.family == "hybrid":
        out["shared_attn"] = block_defs(cfg)            # one shared block
    return out


def layer_stack(cfg) -> Tuple[int, ...]:
    """The leading dims of the reference's stacked layer leaves:
    ``(L,)``, or ``(L / k, k)`` for a hybrid's groups of ``hybrid_period``
    and local_global's (local, global) pairs, or ``(g, k - 1)`` for a
    vlm's self blocks, ``g = L / k`` with ``k = cross_attn_period`` (so
    L / k cross blocks and L - L / k self blocks: 32 of
    llama-3.2-vision-11b's 40 layers)."""
    L = cfg.n_layers
    if cfg.family == "vlm":
        k = cfg.cross_attn_period
        return (L // k, k - 1)
    if cfg.family == "hybrid":
        return (L // cfg.hybrid_period, cfg.hybrid_period)
    if cfg.family in ("dense", "moe", "audio") and \
            cfg.attention == "local_global":
        return (L // 2, 2)
    return (L,)


def layer_groups(cfg) -> int:
    """Blocks a group of ``layer_stack(cfg)`` holds: its last dim, 1 for a
    plain ``(L, ...)`` stack."""
    stack = layer_stack(cfg)
    return stack[-1] if len(stack) > 1 else 1


def model_defs(cfg) -> Dict[str, Any]:
    """Full parameter-definition tree, in the reference's layout (layer
    leaves stacked by ``layer_stack(cfg)`` under ``"layers"``; a vlm's
    cross blocks stacked ``(g, ...)`` under ``"cross"``)."""
    out = top_defs(cfg)
    defs = layer_defs(cfg)
    for n in reversed(layer_stack(cfg)):
        defs = stack_defs(defs, n)
    out["layers"] = defs
    if cfg.family == "vlm":
        out["cross"] = stack_defs(cross_block_defs(cfg),
                                  cfg.n_layers // cfg.cross_attn_period)
    return out


# ============================ block forwards =============================== #

def _qkv(p, x, cfg, plan, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = x                       # sequence-sharded, as explicit q takes it
    x = plan.constrain(x, ("batch", None, None))      # the sequence whole
    q = plan.col_parallel_project(h if plan.tp_mode == "shard_map" else x,
                                  p["wq"]).reshape(B, S, H, hd)
    # K/V gathered over the model axis before they split into heads (KV
    # need not divide the TP degree)
    k = plan.constrain(x @ p["wk"].to(x.dtype), ("batch", None, None)
                       ).reshape(B, S, KV, hd)
    v = plan.constrain(x @ p["wv"].to(x.dtype), ("batch", None, None)
                       ).reshape(B, S, KV, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = plan.constrain(q, ("batch", None, "heads", None))
    # K/V keep their KV heads replicated over the model axis; each rank's
    # attention picks the ones its q heads read (ops.local_kv_heads)
    k = plan.constrain(k, ("batch", None, None, None))
    v = plan.constrain(v, ("batch", None, None, None))
    return q, k, v


def self_attention_block(p, x, cfg, positions, *, window=None,
                         schedule=None, impl: str = "cuda", plan=_SINGLE,
                         attn_positions=None):
    """Pre-norm attention sub-block (full sequence), K7 under
    ``schedule``, resolved as the reference resolves it: "window" under a
    window, else the plan's.  RoPE takes ``positions`` (B, S); K7 masks by
    ``attn_positions`` (a batch's own, or None: by index, which equals the
    mask of ``arange(S)`` and lets K7 skip tiles).  Returns (y, (k, v))."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p["attn"], h, cfg, plan, positions)
    sched = schedule or ("window" if window is not None
                         else plan.attention_schedule)
    o = ops.flash_attention(q, k, v, causal=True, window=window,
                            attn_softcap=cfg.attn_softcap, schedule=sched,
                            impl=impl, q_positions=attn_positions,
                            kv_positions=attn_positions)
    B, S = x.shape[:2]
    o = plan.row_parallel_project(
        o.reshape(B, S, cfg.n_heads * cfg.head_dim), p["attn"]["wo"])
    if cfg.post_norms:
        o = rms_norm(o, p["ln1p"], cfg.norm_eps)
    return o, (k, v)


def mlp_block(p, x, cfg, plan=_SINGLE):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    g = plan.col_parallel_project(h, p["mlp"]["w1"])
    g = plan.constrain(g, ("batch", None, "ff"))
    u = None
    if "w3" in p["mlp"]:
        u = plan.col_parallel_project(h, p["mlp"]["w3"])
    a = activate(g, u, cfg.activation)
    o = plan.row_parallel_project(a, p["mlp"]["w2"])
    if cfg.post_norms:
        o = rms_norm(o, p["ln2p"], cfg.norm_eps)
    return o


def ffn_block(p, x, cfg, plan):
    """The block's feed-forward half: the MLP, or the MoE FFN with its
    aux losses.  Returns (y, aux or None)."""
    if "moe" not in p:
        return mlp_block(p, x, cfg, plan), None
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = moe_ffn(p["moe"], h, cfg, plan)
    if cfg.post_norms:
        y = rms_norm(y, p["ln2p"], cfg.norm_eps)
    return y, aux


def dense_block(p, x, cfg, plan, positions, *, window=None,
                impl: str = "cuda", attn_positions=None):
    """Full transformer block (``attn_positions``: K7's mask,
    ``self_attention_block``).  Returns (x_out, kv, aux): aux is the MoE
    layer's losses, None for an MLP block."""
    o, kv = self_attention_block(p, x, cfg, positions, window=window,
                                 impl=impl, plan=plan,
                                 attn_positions=attn_positions)
    x = plan.constrain(x + o, ("batch", "seq", None))
    y, aux = ffn_block(p, x, cfg, plan)
    return plan.constrain(x + y, ("batch", "seq", None)), kv, aux


def cross_attn_block(p, x, media_kv, cfg, plan=_SINGLE, *,
                     media_valid=None):
    """Gated cross-attention block: pre-norm q from ``x`` (QK-norm, no
    RoPE) onto the media's (k, v), then the MLP; each residual scaled by
    ``tanh`` of its 0-d gate.  Under a plan q is column-parallel (its
    heads over "model"), the attention runs on each rank's heads
    (``attention.cross_attention``) and ``wo`` projects row-parallel, as
    in the self-attention block, both in the GSPMD form under any
    ``tp_mode`` (the reference's are plain einsums); the MLP takes the
    plan's."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = plan.col_parallel_project(h, p["attn"]["wq"], tp_mode="gspmd"
                                  ).reshape(B, S, H, hd)
    if "q_norm" in p["attn"]:
        q = rms_norm(q, p["attn"]["q_norm"], cfg.norm_eps)
    q = plan.constrain(q, ("batch", None, "heads", None))
    k, v = media_kv
    o = attn.cross_attention(q, k, v, media_valid)
    o = plan.row_parallel_project(o.reshape(B, S, H * hd), p["attn"]["wo"],
                                  tp_mode="gspmd")
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * o
    y = mlp_block(p, x, cfg, plan)
    x = x + torch.tanh(p["gate_mlp"]).to(x.dtype) * y
    return plan.constrain(x, ("batch", "seq", None))


def media_kv_for(p_attn, media, cfg, plan=_SINGLE):
    """A cross block's K/V (B, M, KV, hd) from the projected media
    (B, M, d); k through the block's ``k_norm``.  Under a plan they are
    placed as the reference constrains them, ("batch", "media", "kv",
    None), where "model" divides the KV heads; else their heads stay
    replicated over "model", as the self-attention blocks' K/V do
    (a ``Shard`` of KV heads over more ranks than heads would leave ranks
    empty)."""
    B, M, _ = media.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    kv = "kv" if plan.divides("kv", KV) else None
    k = plan.constrain(media @ p_attn["wk"].to(media.dtype),
                       ("batch", None, kv)).reshape(B, M, KV, hd)
    if "k_norm" in p_attn:
        k = rms_norm(k, p_attn["k_norm"], cfg.norm_eps)
    v = plan.constrain(media @ p_attn["wv"].to(media.dtype),
                       ("batch", None, kv)).reshape(B, M, KV, hd)
    k = plan.constrain(k, ("batch", "media", kv, None))
    v = plan.constrain(v, ("batch", "media", kv, None))
    return k, v


def mamba_block(p, x, cfg, plan=_SINGLE, *, conv_state=None,
                ssm_state=None, decode=False, impl: str = "cuda"):
    """Pre-norm Mamba block: the Mamba1 mixer (its scan through K8 under
    ``impl``) or the Mamba2 mixer (plain torch), by ``cfg.ssm_version``;
    the residual constrained as the dense block's is."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    kw = dict(conv_state=conv_state, ssm_state=ssm_state, decode=decode)
    if cfg.ssm_version == 1:
        y, conv_state, ssm_state = ssm_mod.mamba1_mix(p, h, cfg, plan,
                                                      impl=impl, **kw)
    else:
        y, conv_state, ssm_state = ssm_mod.mamba2_mix(p, h, cfg, plan, **kw)
    return plan.constrain(x + y, ("batch", "seq", None)), conv_state, \
        ssm_state


# ============================ decode sub-blocks ============================ #

def attn_block_decode(p, x, cfg, cache, q_pos, *, window=None,
                      plan=_SINGLE):
    """One-token attention block against a cache slice.

    cache: dict(k: (B,S,KV,hd), v, slot_pos: (B,S)), written in place
    (under a serve plan each rank's slots of a cache sharded along its
    sequence: ``attention.write_cache``, ``attention.decode_attention``).
    Returns (y, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = q_pos[:, None]
    q, k_new, v_new = _qkv(p["attn"], h, cfg, plan, positions)
    ck, cv, sp = attn.write_cache(cache["k"], cache["v"], cache["slot_pos"],
                                  k_new, v_new, positions,
                                  rolling_window=window)
    o = attn.decode_attention(q, ck, cv, q_pos, sp,
                              attn_softcap=cfg.attn_softcap, window=window)
    B = x.shape[0]
    # the reference's plain einsum in the GSPMD form: each rank takes its
    # own heads of the (replicated) output onto its rows of the
    # head-sharded wo, and the partial sums are reduced
    o = plan.constrain(o.reshape(B, 1, cfg.n_heads * cfg.head_dim),
                       ("batch", None, "heads"))
    o = plan.row_parallel_project(o, p["attn"]["wo"], tp_mode="gspmd")
    if cfg.post_norms:
        o = rms_norm(o, p["ln1p"], cfg.norm_eps)
    return o, {"k": ck, "v": cv, "slot_pos": sp}


def dense_block_decode(p, x, cfg, plan, cache, q_pos, *, window=None):
    o, cache = attn_block_decode(p, x, cfg, cache, q_pos, window=window,
                                 plan=plan)
    x = x + o
    return x + ffn_block(p, x, cfg, plan)[0], cache
