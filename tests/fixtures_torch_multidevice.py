"""The worker side of tests/test_torch_multidevice.py: worlds of CPU
processes over gloo, each running the port's multi-device path.

Free of JAX (every spawned process imports this module): the test
computes the reference's numbers with JAX in its own process and passes
inputs and results through ``.npz`` files.  ``spawn`` starts one world
and waits for it; each worker function runs on every rank and writes its
results from rank 0.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from fixtures_torch_media import inputs, open_gates

AXES = ("pod", "data", "model")
LR = 1e-3
STEPS = 3
# test_torch_train.py's tolerances (that file imports JAX; this one may not)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 2e-2 * LR
MOE_PARAM_SHARE = 1e-4
MOE_METRICS = ("lb_loss", "z_loss", "drop_frac")


def spawn(fn, world: int, *args, timeout: float = 300.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one gloo process group (rendezvous through a file, so concurrent
    worlds never share a port); raises if any rank fails."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _entry, args=(fn, world, os.path.join(tmp, "rdzv"), args),
            nprocs=world, start_method="spawn", join=False)
        while not ctx.join(timeout=timeout):
            pass


def _entry(rank, fn, world, init_file, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def unflatten(flat):
    """A nested dict from "a/b/c" keys (the reference's parameter tree as
    ``np.savez`` stores it)."""
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# cases that are an arch's smoke config with config overrides and/or
# batches of their own positions: {name: (arch, config overrides, leading
# pads of the even rows or None)}; a name of VARIANTS stands for the arch
# wherever these fixtures take one
VARIANTS = {"smollm-360m-leftpad": ("smollm-360m", {}, 5),
            "gemma2-9b-leftpad": ("gemma2-9b", {}, 7),
            "zamba2-2.7b-mamba1": ("zamba2-2.7b", {"ssm_version": 1}, None)}


def variant(arch: str):
    """(registry arch, config overrides, leading pads or None) of a name
    of VARIANTS, or of a plain arch."""
    return VARIANTS.get(arch, (arch, {}, None))


def smoke_cfg(arch: str = "smollm-360m", **overrides):
    """``arch``'s smoke config (a variant's, ``VARIANTS``) in float32,
    with ``overrides`` (e.g. ``n_experts=3``)."""
    from repro_torch.configs import REGISTRY
    base, over, _ = variant(arch)
    return dataclasses.replace(REGISTRY[base].smoke(), dtype="float32",
                               **{**over, **overrides})


def with_positions(arch: str, batch):
    """``batch`` with a variant's positions: its leading pads (-1) on the
    even rows, then 0, 1, ...; labels -1 on the pads.  Other archs'
    batches as they are."""
    pads = variant(arch)[2]
    if pads is None:
        return batch
    key = "tokens" if "tokens" in batch else "embeddings"
    B, S = batch[key].shape[:2]
    pos = np.stack([np.r_[np.full(n, -1), np.arange(S - n)]
                    for n in (pads if b % 2 == 0 else 0 for b in range(B))])
    out = dict(batch, positions=pos.astype(np.int32))
    if "labels" in batch:
        out["labels"] = np.where(pos < 0, -1, batch["labels"]).astype(
            batch["labels"].dtype)
    return out


def _model(mesh_shape, params_npz, B, S, seed=0, arch="smollm-360m",
           overrides=None, **plan_kw):
    """The smoke model of ``arch`` (smollm-360m by default, with the
    config ``overrides``) under plan_for's train plan on a mesh of
    ``mesh_shape``, with the parameters in ``params_npz`` (or its own,
    drawn from ``seed``, when None)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import plan_for
    from repro_torch.models.model import build_model
    cfg = smoke_cfg(arch, **(overrides or {}))
    mesh = make_mesh(mesh_shape, AXES)
    plan = plan_for(cfg, ShapeConfig("train", S, B, "train"), mesh,
                    **plan_kw)
    model = build_model(cfg, plan, device="cpu", seed=seed)
    if params_npz is not None:
        with np.load(params_npz) as f:
            model.load_jax_params(unflatten(dict(f)))
    return open_gates(model)


# the sharded paths a world counts (``count_paths``): K7's and K8's
# local_map, the moe FFN's, the conv's and the SSD's over channels, a
# vlm's cross attention's, decode attention and the cache writes on a
# sequence-sharded cache, and the explicit projections of tp_mode=
# "shard_map"
PATHS = (("repro_torch.kernels.ops", "_flash_attention_sharded"),
         ("repro_torch.models.attention", "_cross_attention_sharded"),
         ("repro_torch.models.attention", "_decode_attention_sharded"),
         ("repro_torch.models.attention", "_write_cache_sharded"),
         ("repro_torch.kernels.ops", "_selective_scan_sharded"),
         ("repro_torch.models.moe", "_moe_ffn_sharded"),
         ("repro_torch.models.ssm", "causal_conv1d"),
         ("repro_torch.models.ssm", "ssd_chunked"),
         ("repro_torch.sharding", "explicit_col_project"),
         ("repro_torch.sharding", "explicit_row_project"))
SCHEDULES = ("dense", "causal_skip", "window")


def count_paths():
    """Wrap each of PATHS to count its calls on DTensors: {name: count},
    updated as the model runs; K7's calls with a window and with a
    softcap also as ``<name>/window`` and ``<name>/softcap``, and by
    block schedule as ``<name>/schedule/<schedule>``; cross attention's
    onto media K/V whose heads are split (not replicated) over a mesh dim
    as ``<name>/kv_split``."""
    import importlib
    from torch.distributed.tensor import Shard
    from repro_torch.sharding import is_dtensor
    k7, cross = "_flash_attention_sharded", "_cross_attention_sharded"
    counts = {name: 0 for _, name in PATHS}
    counts.update({f"{k7}/window": 0, f"{k7}/softcap": 0,
                   f"{cross}/kv_split": 0})
    counts.update({f"{k7}/schedule/{s}": 0 for s in SCHEDULES})
    for mod, name in PATHS:
        mod = importlib.import_module(mod)
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            sharded = any(is_dtensor(t) for t in a)
            counts[_name] += sharded
            if _name == k7 and sharded:
                # (q, k, v, causal, window, attn_softcap, schedule, impl)
                counts[f"{k7}/window"] += a[4] is not None
                counts[f"{k7}/softcap"] += a[5] is not None
                counts[f"{k7}/schedule/{a[6]}"] += 1
            if _name == cross and sharded:
                counts[f"{cross}/kv_split"] += Shard(2) in a[1].placements
            return _fn(*a, **kw)

        setattr(mod, name, counted)
    return counts


def explicit_projections(cfg):
    """(column, row) explicit projections in one forward of ``cfg`` under
    tp_mode="shard_map": q and ``wo`` of each self-attention block, the
    gate(s) and ``w2`` of each MLP (a vlm's cross blocks' MLPs and a
    hybrid's shared block's among them); none in a moe FFN, a cross
    block's attention or a Mamba mixer."""
    if cfg.family == "ssm":
        return 0, 0
    attn = cfg.n_layers // (cfg.hybrid_period if cfg.family == "hybrid"
                            else 1)
    mlp = 0 if cfg.is_moe else attn
    if cfg.family == "vlm":
        attn -= cfg.n_layers // cfg.cross_attn_period
    gates = 2 if cfg.activation in ("swiglu", "geglu") else 1
    return attn + gates * mlp, attn + mlp



# the archs whose parameters are held as test_torch_train holds the moe
# model's (``params_agree``'s ``near_zero``); every other arch's within
# PARAM_TOL everywhere.  zamba2 too: on ``batch``'s B=4, S=48 the port's
# single-device path already moves 4 of its elements beyond PARAM_TOL
# against the reference, each where its first gradient is within
# GRAD_TOL x max of zero.  gemma2 on a left-padded batch too: its labels
# -1 on the pads leave fewer tokens, and at (1, 2, 2) one element of a
# w3 (first gradient 0.078 x GRAD_TOL x max) moves 2.47e-5 from the
# reference's.
NEAR_ZERO_RULE = ("qwen3-moe-30b-a3b", "mixtral-8x7b", "zamba2-2.7b",
                  "gemma2-9b-leftpad")


def beyond_tol(got, want, grad0):
    """Each element of parameters ``got`` beyond PARAM_TOL of ``want``:
    [(name, index, difference, its first gradient |g1| over GRAD_TOL x
    max |g1| of its tensor)], and the count of all elements."""
    far, total = [], 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        g = np.abs(grad0[name])
        total += diff.size
        far += [(name, list(map(int, i)), float(diff[i]),
                 float(g[i] / (GRAD_TOL * g.max())))
                for i in map(tuple, np.argwhere(diff > PARAM_TOL))]
    return far, total


def params_agree(got, want, grad0, step: int, near_zero: bool) -> str:
    """'' when parameters ``got`` after ``step`` AdamW steps equal
    ``want``: every element within PARAM_TOL or, with ``near_zero``, as
    test_torch_train holds the moe model's: beyond PARAM_TOL only where
    the first step's gradient ``grad0`` ({name: array}) is within
    GRAD_TOL x max |g| of its tensor of zero (AdamW's first update
    lr g / (|g| + eps) of such an element divides rounding by rounding),
    by at most LR a step, and in at most a share MOE_PARAM_SHARE of all
    elements.  Else what failed, with the elements beyond PARAM_TOL."""
    far, total = beyond_tol(got, want, grad0)
    if not far:
        return ""
    where = "; ".join(f"{n}{i} {d:.3g} (|g1| {r:.3g} x GRAD_TOL max)"
                      for n, i, d, r in far[:10])
    if not near_zero:
        return f"{len(far)} elements beyond PARAM_TOL: {where}"
    if any(r > 1 for *_, r in far):
        return f"beyond PARAM_TOL where the first gradient is not ~0: {where}"
    if any(d > LR * step for _, _, d, _ in far):
        return f"beyond LR x {step}: {where}"
    if len(far) > MOE_PARAM_SHARE * total:
        return f"{len(far)} of {total} elements beyond PARAM_TOL: {where}"
    return ""


def _grads(model, batch, full=lambda t: t):
    """{name: the whole gradient of the model's loss on ``batch``} at its
    parameters as they are (``full`` gathers a DTensor's)."""
    from repro_torch.runtime.steps import make_loss_fn
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss, _ = make_loss_fn(model)(batch)
        g = torch.autograd.grad(loss, list(params.values()),
                                materialize_grads=True)
    return {k: full(v.detach()).numpy().copy() for k, v in zip(params, g)}


def _full_params(state):
    from repro_torch.sharding import full
    return {k: full(p.detach()).numpy().copy()
            for k, p in state.params.items()}


def train_worker(rank, world, mesh_shape, params_npz, batch_npz, out_npz,
                 microbatch=1, arch="smollm-360m", overrides=None,
                 grads=False, replay=(), plan_kw=None, probe=False):
    """STEPS AdamW steps (lr LR) of ``arch``'s smoke model (with the
    config ``overrides``, under plan_for's train plan with the plan
    overrides ``plan_kw``) on the batch in ``batch_npz`` from the
    parameters in ``params_npz`` (drawn from seed 0 when None); rank 0
    writes each step's loss, grad norm and moe metrics, the whole
    parameters after it (with ``grads``, also the whole gradients the
    step takes, ``g<step>/<name>``, from one more forward and backward
    of the loss before it), after the steps the whole gradients at each
    parameter file of ``replay`` in turn (``r<j>/<name>``, j from 1: the
    ops alone, held at another trajectory's parameters), every
    parameter's placements (``placed/<name>``;
    a token model's embedding and first wq also as ``placements``), the
    collectives one ``global_norm`` of the parameters makes, and whether
    every parameter's shard owns its storage (holds no whole tensor
    alive); with ``probe``, also ``projections`` on the model's mesh."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.sharding import full, local
    with np.load(batch_npz) as f:
        batch = dict(f)
    B, S = batch["labels"].shape
    paths = count_paths()
    model = _model(mesh_shape, params_npz, B, S, arch=arch,
                   overrides=overrides, microbatch=microbatch,
                   **(plan_kw or {}))
    opt = AdamW(lr=LR)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    out = {}
    for i in range(1, STEPS + 1):
        if grads:
            out.update({f"g{i}/{k}": v
                        for k, v in _grads(model, batch, full).items()})
        state, m = step(state, batch)
        for k in ("loss", "grad_norm") + MOE_METRICS:
            if k in m:
                out[f"{k}_{i}"] = float(m[k])
        for k, v in _full_params(state).items():
            out[f"p{i}/{k}"] = v
    for k, n in paths.items():
        out[f"path/{k}"] = n
    for j, path in enumerate(replay, 1):
        with np.load(path) as f:
            model.load_jax_params(unflatten(dict(f)))
        out.update({f"r{j}/{k}": v
                    for k, v in _grads(model, batch, full).items()})
    for k, p in state.params.items():
        out[f"placed/{k}"] = np.array(str(tuple(p.placements)))
    if "attn" in model.layers[0] and model.cfg.embed_inputs:
        out["placements"] = np.array([
            str(tuple(model.embed.placements)),
            str(tuple(model.layers[0].attn.wq.placements))])
    with CommDebugMode() as comm:
        global_norm(state.params)
    out["norm_collectives"] = comm.get_total_counts()
    if probe:
        out.update(projections(model.plan.mesh))
    shards = [local(p) for p in state.params.values()]
    out["own_storage"] = all(
        t.untyped_storage().nbytes() == t.numel() * t.element_size()
        for t in shards)
    if rank == 0:
        np.savez(out_npz, **out)


def one_device_grads(batch_np, params_npz, arch: str = "smollm-360m"):
    """The whole gradients of ``arch``'s smoke model's loss on
    ``batch_np`` at the parameters in ``params_npz``, on one CPU device
    (no plan)."""
    from repro_torch.models.model import build_model
    model = build_model(smoke_cfg(arch), None, device="cpu", seed=0)
    with np.load(params_npz) as f:
        model.load_jax_params(unflatten(dict(f)))
    return _grads(open_gates(model), batch_np)


def gpipe_worker(rank, world, mesh_shape, case_npz, out_npz, n_micro):
    """``gpipe_apply`` over the "pod" axis of a ``mesh_shape`` mesh on
    the reference's case (tanh layers); rank 0 writes the output and the
    gradients of its sum."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.pipeline import gpipe_apply
    mesh = make_mesh(mesh_shape, AXES)
    with np.load(case_npz) as f:
        ws, bs, x = (torch.from_numpy(f[k]).requires_grad_()
                     for k in ("ws", "bs", "x"))

    def body(stage_p, h):
        w, b = stage_p
        for i in range(w.shape[0]):
            h = torch.tanh(h @ w[i] + b[i])
        return h

    out = gpipe_apply((ws, bs), x, body, mesh=mesh, stage_axis="pod",
                      n_micro=n_micro)
    out.sum().backward()
    res = {"out": out.detach().numpy(), "gw": ws.grad.numpy(),
           "gb": bs.grad.numpy(), "gx": x.grad.numpy()}
    # every rank holds the same output and gradients
    for k, v in list(res.items()):
        lo, hi = torch.from_numpy(v).clone(), torch.from_numpy(v).clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        res[f"spread_{k}"] = np.float64((hi - lo).abs().max())
    if rank == 0:
        np.savez(out_npz, **res)


# (input's logical axes, weight's, x's shape, w's shape) of each
# tensor-parallel projection as the blocks call it, at B=4, S=8, d=16,
# F=32 (``projections``)
PROJECTIONS = {"col": (("batch", "seq", None), ("embed", "ff"), (4, 8, 16),
                       (16, 32)),
               "row": (("batch", None, "ff"), ("ff", "embed"), (4, 8, 32),
                       (32, 16))}


def projections(mesh):
    """Each of PROJECTIONS on seeded inputs under the train plan on
    ``mesh``, in each ``tp_mode``: x and w distributed as the blocks place
    them, y = the projection, and the gradients of sum(y * c) for a seeded
    c; {``proj/<kind>/<mode>/{y,gx,gw}``: the whole y and x's and w's
    gradients, ``.../placed``: y's placements}.  A collective: every rank
    of the mesh calls it."""
    from repro_torch.sharding import (TP_MODES, active_mesh, distribute,
                                      full, train_plan)
    sub = active_mesh(mesh)
    plan = train_plan(AXES).with_(mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for kind, (x_ax, w_ax, xs, ws) in PROJECTIONS.items():
        x0, w0 = (torch.randn(s, generator=gen) for s in (xs, ws))
        c = torch.randn(xs[:2] + ws[1:], generator=gen)
        for mode in TP_MODES:
            x = distribute(x0, sub, plan.placements(x_ax, sub))
            w = distribute(w0, sub, plan.placements(w_ax, sub))
            x.requires_grad_()
            w.requires_grad_()
            y = getattr(plan.with_(tp_mode=mode),
                        f"{kind}_parallel_project")(x, w)
            yf = full(y)
            (yf * c).sum().backward()
            key = f"proj/{kind}/{mode}"
            out.update({f"{key}/y": yf.detach().numpy(),
                        f"{key}/gx": full(x.grad).numpy(),
                        f"{key}/gw": full(w.grad).numpy(),
                        f"{key}/placed": np.array(str(tuple(y.placements)))})
    return out


def checkpoint_worker(rank, world, mesh_shape, params_npz, batch_npz,
                      ckpt_dir, out_npz):
    """Save the initial state (the parameters of ``params_npz``, zero
    moments), take one step and save again, then restore both into a
    model drawn from another seed; rank 0 writes the whole state after the
    step and after each restore."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.sharding import full
    with np.load(batch_npz) as f:
        batch = dict(f)
    B, S = batch["labels"].shape

    def whole(state):
        return {f"{part}/{k}": full(t.detach()).numpy().copy()
                for part, tree in (("p", state.params),
                                   ("m", state.opt_state.m),
                                   ("v", state.opt_state.v))
                for k, t in tree.items()}

    model = _model(mesh_shape, params_npz, B, S)
    opt = AdamW(lr=LR)
    state = init_train_state(model, opt)
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    ckpt.save(0, state, extras={"data_step": 0})
    state, _ = make_train_step(model, opt)(state, batch)
    ckpt.save(1, state, extras={"data_step": 1})
    out = {f"stepped/{k}": v for k, v in whole(state).items()}
    fresh = _model(mesh_shape, None, B, S, seed=7)
    out.update({f"drawn7/{k}": full(p.detach()).numpy().copy()
                for k, p in fresh.named_parameters()})
    target = init_train_state(fresh, opt)
    for s in (0, 1):
        restored, extras = ckpt.restore(target, step=s)
        assert extras["data_step"] == s
        out.update({f"restored{s}/{k}": v
                    for k, v in whole(restored).items()})
    out["steps"] = np.array(ckpt.steps())
    if rank == 0:
        np.savez(out_npz, **out)


# serving under the serve plans (``serve_worker``): a prompt longer than
# the smoke window of 16 (the rolling caches wrap), 4 decode steps, and a
# cache of 22 slots, which no mesh of 4 splits evenly (over one mesh dim
# 6, 6, 6, 4; over two, nested, 6, 5, 6, 5)
SERVE_PROMPT, SERVE_NEW, SERVE_CACHE = 18, 4, 22


def serve_inputs(arch: str, B: int, seed: int = 5):
    """The prompt batch of a serving case of ``arch`` ((B, SERVE_PROMPT)
    tokens, or the audio family's frame embeddings; a vlm's media; a
    variant's positions, ``with_positions``) and, for the audio family,
    the frames its decode steps feed ((B, SERVE_NEW, media_embed_dim));
    numpy, from ``seed``."""
    cfg = smoke_cfg(arch)
    batch = with_positions(arch, inputs(cfg, seed=seed, B=B,
                                        S=SERVE_PROMPT))
    frames = inputs(cfg, seed=seed + 1, B=B, S=SERVE_NEW).get("embeddings")
    return batch, frames


def next_positions(batch):
    """Each row's position after the prompt ``batch`` (B,): its last
    position + 1, SERVE_PROMPT without positions."""
    if "positions" in batch:
        return (np.asarray(batch["positions"])[:, -1] + 1).astype(np.int32)
    key = "tokens" if "tokens" in batch else "embeddings"
    return np.full((batch[key].shape[0],), SERVE_PROMPT, np.int32)


def serve_plans(cfg, mesh, B: int, plan_kw=None):
    """plan_for's (prefill, decode) plans of ``cfg`` at global batch B on
    ``mesh`` (``plan_kw``: plan_for's overrides, e.g.
    ``serve_weight_mode``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import plan_for
    return tuple(plan_for(cfg, ShapeConfig(kind, SERVE_CACHE, B, kind), mesh,
                          **(plan_kw or {}))
                 for kind in ("prefill", "decode"))


def serve_run(model, decoder, batch, step, record):
    """Prefill of ``batch`` into a cache of SERVE_CACHE slots on
    ``model``, then SERVE_NEW decode steps on ``decoder``, the inputs of
    step t ``step(t, the logits before it)`` ({"tokens": (B, 1)} or
    {"embeddings": (B, 1, E)}); ``record(key, tensor)`` takes the whole
    logits of each (``prefill``, ``decode<t>``), the prefill cache
    (``cache/<name>``) before a step writes it, and each step's inputs
    (``step<t>/<input>``).  Returns the cache."""
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    from repro_torch.sharding import full
    logits, cache = make_prefill_step(model, SERVE_CACHE)(batch)
    logits = full(logits)
    record("prefill", logits)
    for name, leaf in cache.items():
        record(f"cache/{name}", full(leaf))
    decode = make_decode_step(decoder)
    q_pos = next_positions(batch)
    for t in range(SERVE_NEW):
        fed = step(t, logits)
        for k, v in fed.items():
            record(f"step{t}/{k}", torch.as_tensor(v))
        logits, cache = decode(cache, fed, q_pos + t)
        logits = full(logits)
        record(f"decode{t}", logits)
    return cache


def attention_layers(cfg) -> int:
    """Self-attention blocks a forward of ``cfg`` runs (a hybrid's shared
    block once a group, none in an ssm model, a vlm's self blocks)."""
    from repro_torch.models.transformer import layer_stack
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    return math.prod(layer_stack(cfg))


def serve_worker(rank, world, mesh_shape, cases, out_npz):
    """Each case (tag, arch, B, plan overrides, params npz or None,
    inputs npz) on one mesh of ``mesh_shape``: the smoke model (float32,
    the vlm's gates opened) under plan_for's prefill plan with the
    case's parameters, its decode model over the same tensors
    (``Model.with_plan`` of the decode plan), ``serve_run`` of the
    inputs npz's ``prompt/*`` batch and ``step<t>/*`` decode inputs.
    Rank 0 writes under ``<tag>/``: the logits and prefill cache
    ``serve_run`` records, each cache leaf's placements
    (``placed/<name>``) and, over the ranks, the smallest and largest
    local length of ``k`` along its sequence (``k_local``; an ssm model's
    ``ssm`` state along its channels), whether the ranks' shards of it
    sum to the whole and each owns only its own storage (``k_chunks``), whether the decode model holds the prefill
    model's parameter tensors (``shares``), and the sharded paths' counts
    over the prefill and over the decode steps (``prefill_path/*``,
    ``decode_path/*``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding import local
    mesh = make_mesh(mesh_shape, AXES)
    paths = count_paths()
    out = {}
    for tag, arch, B, plan_kw, params_npz, inputs_npz in cases:
        cfg = smoke_cfg(arch)
        prefill_plan, decode_plan = serve_plans(cfg, mesh, B, plan_kw)
        model = build_model(cfg, prefill_plan, device="cpu", seed=0)
        if params_npz is not None:
            with np.load(params_npz) as f:
                model.load_jax_params(unflatten(dict(f)))
        open_gates(model)
        decoder = model.with_plan(decode_plan)
        with np.load(inputs_npz) as f:
            data = dict(f)
        batch = {k[len("prompt/"):]: v for k, v in data.items()
                 if k.startswith("prompt/")}
        steps = [{k.split("/")[1]: v for k, v in data.items()
                  if k.startswith(f"step{t}/")} for t in range(SERVE_NEW)]

        base = dict(paths)

        def record(key, t, _tag=tag, _base=base):
            if key == "prefill":
                for k, n in paths.items():
                    out[f"{_tag}/prefill_path/{k}"] = n - _base[k]
            out[f"{_tag}/{key}"] = t.detach().numpy().copy()

        cache = serve_run(model, decoder, batch, lambda t, _: steps[t],
                          record)
        for k, n in paths.items():
            out[f"{tag}/decode_path/{k}"] = \
                n - base[k] - out[f"{tag}/prefill_path/{k}"]
        for name, leaf in cache.items():
            out[f"{tag}/placed/{name}"] = np.array(str(tuple(leaf.placements)))
        # k along its sequence, or an ssm model's state along its channels
        whole = cache["k" if "k" in cache else "ssm"]
        k = local(whole)
        lens = [None] * world
        dist.all_gather_object(lens, (k.shape[2], k.numel(),
                                      k.untyped_storage().nbytes() ==
                                      k.numel() * k.element_size()))
        out[f"{tag}/k_local"] = np.array([min(n for n, _, _ in lens),
                                          max(n for n, _, _ in lens)])
        out[f"{tag}/k_chunks"] = np.array(
            sum(n for _, n, _ in lens) == whole.numel() and
            all(own for *_, own in lens))
        out[f"{tag}/shares"] = np.array(
            all(a is b for a, b in zip(model.parameters(),
                                       decoder.parameters())) and
            len(list(model.parameters())) ==
            len(list(decoder.parameters())))
    if rank == 0:
        np.savez(out_npz, **out)


def serve_one_device(arch, batch, frames, groups=1, device="cpu",
                     plan_kw=None):
    """``serve_run`` of the smoke model of ``arch`` (seed 0, float32, the
    vlm's gates opened) on one device, its moe groups aimed at ``groups``
    in prefill (a world's size, as plan_for's prefill plan aims them) and
    at 1 in decode (of ``plan_kw``'s ``moe_group_size`` when it names
    one), each step fed the greedy token (the audio family ``frames``,
    (B, SERVE_NEW, E)), on ``device``: {key: array}."""
    from repro_torch.models.model import build_model
    from repro_torch.sharding import single_device_plan
    one = single_device_plan().with_(**{
        k: v for k, v in (plan_kw or {}).items() if k == "moe_group_size"})
    model = open_gates(build_model(smoke_cfg(arch),
                                   one.with_(moe_target_groups=groups),
                                   device=device, seed=0))

    def step(t, logits):
        if frames is not None:
            return {"embeddings": frames[:, t:t + 1]}
        return {"tokens": logits.argmax(-1)[:, None].to(torch.int32)
                .cpu().numpy()}

    out = {}
    serve_run(model, model.with_plan(one), batch, step,
              lambda k, t: out.__setitem__(k, t.detach().cpu().numpy()
                                           .copy()))
    return out


# serve_worker's worlds in ``main``: (mesh, [(arch, B, plan overrides)]),
# test_torch_multidevice_serve{,_families}.py's
SERVE_WORLDS = [
    ((1, 2, 2), [("smollm-360m", 2, None),
                 ("smollm-360m", 16, {"serve_weight_mode": "gathered"}),
                 ("qwen3-moe-30b-a3b", 2, None),
                 ("qwen3-moe-30b-a3b", 16, {"moe_group_size": 25}),
                 ("musicgen-medium", 2, None),
                 ("smollm-360m-leftpad", 2, None),
                 ("zamba2-2.7b-mamba1", 2, None)]),
    ((1, 1, 4), [(arch, 2, None) for arch in (
        "gemma2-9b", "mixtral-8x7b", "falcon-mamba-7b", "zamba2-2.7b",
        "llama-3.2-vision-11b")])]


def serve_main(archs, d) -> int:
    """SERVE_WORLDS (those of ``archs`` when given) against the port's
    one-device path from seed 0 (``serve_one_device``): the logits
    (prefill 1e-4, decode 1e-3), greedy tokens, prefill cache (1e-5),
    the decode model over the prefill model's tensors, K7 under
    ``local_map`` once an attention block in prefill and the decode
    attention on the sharded cache each step.  Prints a line a case;
    returns the count of failed cases."""
    import time
    import fixtures_torch_multidevice as fx
    bad = 0
    for mesh, cases in SERVE_WORLDS:
        cases = [c for c in cases if not archs or c[0] in archs]
        if not cases:
            continue
        t0 = time.perf_counter()
        world, want, worker_cases = int(np.prod(mesh)), {}, []
        for arch, B, plan_kw in cases:
            tag = f"{arch}-B{B}" + "".join(f"-{v}" for v in
                                          (plan_kw or {}).values())
            batch, frames = serve_inputs(arch, B)
            want[tag] = serve_one_device(arch, batch, frames, world,
                                         plan_kw=plan_kw)
            path = os.path.join(d, f"{tag}_inputs.npz")
            np.savez(path, **{f"prompt/{k}": v for k, v in batch.items()},
                     **{k: v for k, v in want[tag].items()
                        if k.startswith("step")})
            worker_cases.append((tag, arch, B, plan_kw, None, path))
        path = os.path.join(d, "served.npz")
        spawn(fx.serve_worker, world, mesh, worker_cases, path)
        with np.load(path) as f:
            got = dict(f)
        secs = time.perf_counter() - t0
        for (arch, B, plan_kw), (tag, one) in zip(cases, want.items()):
            errs, fails = [], []
            for key, tol in [("prefill", 1e-4)] + [
                    (f"decode{t}", 1e-3) for t in range(SERVE_NEW)]:
                a, b = got[f"{tag}/{key}"], one[key]
                errs.append(float(np.abs(a - b).max()))
                if not np.allclose(a, b, atol=tol, rtol=tol) or \
                        not np.array_equal(a.argmax(-1), b.argmax(-1)):
                    fails.append(key)
            fails += [k for k in one if k.startswith("cache/") and not
                      np.allclose(got[f"{tag}/{k}"], one[k], atol=1e-5,
                                  rtol=1e-5)]
            n = attention_layers(smoke_cfg(arch))
            paths = (int(got[f"{tag}/prefill_path/_flash_attention_sharded"]),
                     int(got[f"{tag}/decode_path/_decode_attention_sharded"]))
            if paths != (n, n * SERVE_NEW):
                fails.append(f"paths {paths}")
            if not got[f"{tag}/shares"]:
                fails.append("parameters copied")
            bad += bool(fails)
            print(f"serve {tag} mesh {mesh}: logits max abs "
                  f"{[f'{e:.3g}' for e in errs]} (tol 1e-4 prefill, 1e-3 "
                  f"decode), K7 local_map {paths[0]}, sharded decode "
                  f"attention {paths[1]}, local k lengths "
                  f"{got[f'{tag}/k_local'].tolist()}, {secs:.1f} s the "
                  f"world: {'ok' if not fails else 'MISMATCH ' + str(fails)}",
                  flush=True)
    return bad


def batch(cfg, B: int, S: int, seed: int = 1, pads: int = 3):
    """Tokens and labels with ``pads`` -1s (test_torch_train's batch of a
    dense model); the audio family's frame embeddings in place of the
    tokens, and a vlm's media, drawn after them from the same seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, S - pads:] = -1
    out = {"labels": labels}
    if cfg.embed_inputs:
        out["tokens"] = toks
    else:
        out["embeddings"] = rng.standard_normal(
            (B, S, cfg.media_embed_dim)).astype(np.float32)
    if cfg.family == "vlm":
        out["media"] = rng.standard_normal(
            (B, cfg.n_media_tokens, cfg.media_embed_dim)).astype(np.float32)
    return out


def one_device_trajectory(batch_np, microbatch: int = 1,
                          arch: str = "smollm-360m", overrides=None,
                          groups: int = 1, params_npz=None):
    """STEPS AdamW steps of ``arch``'s smoke model on one CPU device (no
    plan; a moe model's groups aimed at ``groups``, the world's size, as
    ``plan_for`` aims them), from the parameters in ``params_npz`` (drawn
    from seed 0 when None): [(loss, grad norm, {name: parameters}) after
    each], and each step's gradients [{name: array}]."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.sharding import single_device_plan
    plan = single_device_plan().with_(microbatch=microbatch,
                                      moe_target_groups=groups)
    model = build_model(smoke_cfg(arch, **(overrides or {})), plan,
                        device="cpu", seed=0)
    if params_npz is not None:
        with np.load(params_npz) as f:
            model.load_jax_params(unflatten(dict(f)))
    open_gates(model)
    opt = AdamW(lr=LR)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    out, grads = [], []
    for _ in range(STEPS):
        grads.append(_grads(model, batch_np))
        state, m = step(state, batch_np)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: p.detach().numpy().copy()
                     for k, p in state.params.items()}))
    return out, grads


# (arch, config overrides, mesh, microbatch, plan overrides) of ``main``'s
# training worlds
SHARD_MAP = {"tp_mode": "shard_map"}
WORLDS = [("smollm-360m", None, (1, 2, 2), 1, None),
          ("smollm-360m", None, (2, 2, 1), 1, None),
          ("smollm-360m", None, (1, 1, 4), 1, None),
          ("smollm-360m", None, (1, 2, 2), 2, None)] + [
    (arch, None, mesh, 1, None)
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x7b", "falcon-mamba-7b",
                 "zamba2-2.7b") for mesh in ((1, 2, 2), (1, 1, 4))] + [
    ("qwen3-moe-30b-a3b", {"n_experts": 3}, (1, 2, 2), 1, None)] + [
    (arch, None, mesh, 1, None)
    for arch in ("gemma2-9b", "llama-3.2-vision-11b", "musicgen-medium")
    for mesh in ((1, 2, 2), (1, 1, 4))] + [
    # test_torch_multidevice_local_global.py's batch of its own positions
    ("gemma2-9b-leftpad", None, (1, 2, 2), 1, None)] + [
    # test_torch_multidevice_shard_map{,_families}.py's
    ("smollm-360m", None, (1, 2, 2), 1,
     dict(SHARD_MAP, attention_schedule="causal_skip")),
    ("smollm-360m", None, (2, 1, 2), 1, dict(SHARD_MAP, pipeline_stages=2)),
    ("qwen3-moe-30b-a3b", None, (1, 2, 2), 1, SHARD_MAP),
    ("llama-3.2-vision-11b", None, (1, 1, 4), 1, SHARD_MAP),
    ("zamba2-2.7b", None, (1, 1, 4), 1, SHARD_MAP)]


def main(argv=None) -> int:
    """Worlds of CPU processes over gloo against the port's single-device
    path, with no JAX: training at the meshes of test_torch_multidevice*
    from seed 0 (losses, grad norms, parameters at test_torch_train's
    tolerances, those of NEAR_ZERO_RULE's archs as ``params_agree``
    holds them, each element beyond PARAM_TOL printed with its gradients;
    a moe model's single-device groups aimed at the world's size) and
    ``gpipe_apply`` at 2 stages against the sequential layers (1e-5,
    1e-4), then serving under the serve plans (``serve_main``).  Checks
    the DTensor path on whatever torch is installed (the suite's
    reference comparison needs JAX).  Arch names as arguments keep only
    their worlds (and skip GPipe).

        PYTHONPATH=src python tests/fixtures_torch_multidevice.py [arch...]
    """
    import sys
    import time
    import fixtures_torch_multidevice as fx
    archs = sys.argv[1:] if argv is None else argv
    print(f"torch {torch.__version__}", flush=True)
    B, S = 4, 48
    bad = 0
    with tempfile.TemporaryDirectory() as d:
        bpath = os.path.join(d, "batch.npz")
        for arch, over, mesh, mb, plan_kw in WORLDS:
            if archs and arch not in archs:
                continue
            t0 = time.perf_counter()
            b = with_positions(arch, batch(smoke_cfg(arch), B, S))
            np.savez(bpath, **b)
            world = int(np.prod(mesh))
            want, grads = one_device_trajectory(b, mb, arch, over,
                                                groups=world)
            path = os.path.join(d, "out.npz")
            spawn(fx.train_worker, world, mesh, None, bpath, path, mb, arch,
                  over, False, (), plan_kw)
            with np.load(path) as f:
                got = dict(f)
            lrel = max(abs(float(got[f"loss_{i}"]) / want[i - 1][0] - 1)
                       for i in range(1, STEPS + 1))
            grel = max(abs(float(got[f"grad_norm_{i}"]) / want[i - 1][1]
                           - 1) for i in range(1, STEPS + 1))
            diffs = [np.abs(got[f"p{i}/{k}"] - v)
                     for i in range(1, STEPS + 1)
                     for k, v in want[i - 1][2].items()]
            pmax = max(float(x.max()) for x in diffs)
            beyond = sum(int((x > PARAM_TOL).sum()) for x in diffs)
            agree = [params_agree({k: got[f"p{i}/{k}"] for k in want[0][2]},
                                  want[i - 1][2], grads[0], i,
                                  arch in NEAR_ZERO_RULE)
                     for i in range(1, STEPS + 1)]
            ok = lrel <= LOSS_TOL and grel <= GRAD_TOL and not any(agree)
            bad += not ok
            verdict = "ok" if ok else "MISMATCH " + next(filter(None, agree),
                                                         "")
            print(f"{arch}{'' if over is None else f' {over}'} mesh {mesh} "
                  f"microbatch {mb}{'' if plan_kw is None else f' {plan_kw}'}"
                  f": loss max rel {lrel:.3g} (tol "
                  f"{LOSS_TOL}), grad norm max rel {grel:.3g} (tol "
                  f"{GRAD_TOL}), params max abs {pmax:.3g} (tol "
                  f"{PARAM_TOL}; {beyond} elements beyond), global_norm "
                  f"collectives {int(got['norm_collectives'])}, "
                  f"{time.perf_counter() - t0:.1f} s: {verdict}", flush=True)
            # each element beyond PARAM_TOL after the last step, with its
            # gradient at each step over GRAD_TOL x max of its tensor
            last = {k: got[f"p{STEPS}/{k}"] for k in want[0][2]}
            for name, idx, diff, _ in beyond_tol(last, want[-1][2],
                                                 grads[0])[0]:
                rel = [abs(g[name][tuple(idx)]) / (GRAD_TOL *
                                                   np.abs(g[name]).max())
                       for g in grads]
                print(f"  {name}{idx}: {diff:.3g}; |g_s| / (GRAD_TOL max) "
                      + " ".join(f"{r:.3g}" for r in rel), flush=True)
        bad += serve_main(archs, d)
        if archs:
            return 1 if bad else 0
        rng = np.random.default_rng(0)
        case = {"ws": rng.standard_normal((8, 32, 32)).astype(np.float32)
                * 0.2,
                "bs": rng.standard_normal((8, 32)).astype(np.float32) * 0.1,
                "x": rng.standard_normal((8, 16, 32)).astype(np.float32)}
        cpath, path = os.path.join(d, "case.npz"), os.path.join(d, "g.npz")
        np.savez(cpath, **case)
        spawn(fx.gpipe_worker, 2, (2, 1, 1), cpath, path, 4)
        ws, bs, x = (torch.from_numpy(case[k]).requires_grad_()
                     for k in ("ws", "bs", "x"))
        h = x
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i] + bs[i])
        h.sum().backward()
        with np.load(path) as f:
            fe = float(np.abs(f["out"] - h.detach().numpy()).max())
            ge = max(float(np.abs(f[k] - t.grad.numpy()).max())
                     for k, t in (("gw", ws), ("gb", bs), ("gx", x)))
        ok = fe < 1e-5 and ge < 1e-4
        bad += not ok
        print(f"gpipe 2 stages: forward max abs {fe:.3g} (tol 1e-5), "
              f"gradients max abs {ge:.3g} (tol 1e-4): "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
