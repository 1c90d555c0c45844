"""A hybrid of Mamba1 blocks (``family="hybrid"``, ``ssm_version=1``), the
port against the reference, on the CPU.

The reference runs one (its ``mamba_block`` dispatches on
``ssm_version``); the original Zamba (arXiv:2405.16712) is the public
architecture of the kind: Mamba1 blocks with one shared attention block.
Here zamba2-2.7b's smoke config with ``ssm_version=1``: 12 Mamba1 blocks
(d_inner 128, N 16, dt_rank 8) in groups of 2, each group followed by
the shared attention block, float32, the reference's parameters carried
across with ``load_jax_params``; its scan is K8's plain version on the
CPU (``ops.selective_scan``), its shared block's attention K7's.

- the layout: ``layer_defs`` are Mamba1's, the reference's ``(L / k, k,
  ...)`` leaves unstack into layer ``g * k + j``, the cache's ``ssm``
  leaf is Mamba1's (L, B, d_inner, N) and its K/V the shared block's
  (L / k, B, ...), and ``cache_specs`` place them as the reference's
  ``cache_specs`` under plan_for's serve plans (its ``ssm`` leaf as the
  reference's Mamba1 state: the reference's hybrid cache is Mamba2's
  whatever the blocks, a fault pinned here with its serve driver's
  failure, ROADMAP §3);
- serving: forward logits and prefill logits within 1e-4, the prefill
  cache within 1e-5, 4 decode steps within 1e-3, with positions arange
  and with left-padded rows (``test_torch_positions.py``'s checks); and
  ``launch.serve.serve``'s tokens (8 requests, 4 slots) equal to the
  reference's greedy tokens from its Model API, prompt by prompt;
- training: a train step's loss (1e-5 relative) and every gradient
  (GRAD_TOL) with labels -1 on pads, without positions and with them.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREGISTRY
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.launch.specs import plan_for as rplan_for
from repro.models import build_model as rbuild
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.serve import serve
from repro_torch.launch.specs import plan_for
from repro_torch.models import transformer as tf
from repro_torch.models.model import (build_model, cache_layout,
                                      cache_specs, check_supported,
                                      load_jax_params)

from test_torch_positions import (B, S, _batch, _pair, padded, positions,
                                  serve_against_reference)
from test_torch_positions_train import train_against_reference

ARCH = "zamba2-2.7b"
MAMBA1 = {"ssm_version": 1}


def _cfg():
    return dataclasses.replace(REGISTRY[ARCH].smoke(), dtype="float32",
                               **MAMBA1)


def test_mamba1_hybrid_is_supported():
    full = dataclasses.replace(REGISTRY[ARCH], **MAMBA1)
    check_supported(full)
    assert (full.d_inner, full.ssm_state, full.dt_rank) == (5120, 64, 160)
    assert full.n_layers // full.hybrid_period == 9


def test_layout_matches_reference():
    """Mamba1's parameters in (L / k, k) groups, unstacked in order; the
    cache's Mamba1 state and the shared block's K/V."""
    cfg = _cfg()
    assert "x_proj" in tf.layer_defs(cfg) and \
        "in_proj_xz" not in tf.layer_defs(cfg)
    k, L = cfg.hybrid_period, cfg.n_layers
    params = jax.tree_util.tree_map(np.asarray, _pair(ARCH, **MAMBA1)[1])
    state = load_jax_params(params, cfg)
    x_proj = params["layers"]["x_proj"]
    assert x_proj.shape[:2] == (L // k, k)
    for i in range(L):
        assert np.array_equal(state[f"layers.{i}.x_proj"].numpy(),
                              x_proj[divmod(i, k)])
    model = build_model(cfg, device="cpu")
    assert sorted(model.state_dict()) == sorted(state)
    cache = model.init_cache(B, 40)
    assert cache["ssm"].shape == (L, B, cfg.d_inner, cfg.ssm_state)
    assert cache["conv"].shape == (L, B, cfg.ssm_conv - 1, cfg.d_inner)
    assert cache["k"].shape == (L // k, B, 40, cfg.n_kv_heads,
                                cfg.head_dim)
    # the state stays float32 in a bfloat16 cache, as the reference's
    layout = cache_layout(cfg, B, 40, torch.bfloat16)
    assert (layout["ssm"][1], layout["conv"][1]) == (torch.float32,
                                                     torch.bfloat16)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("B_", [2, 32])
def test_cache_specs_match_reference(B_, kind):
    """Each cache leaf's spec under plan_for's serve plans (a (2, 16, 16)
    mesh's stand-in, no devices) as the reference's ``cache_specs``, from
    the layer axis on (``test_torch_serve_plans.py``'s rule)."""
    from test_torch_serve_plans import _flat, _port_name
    axes = ("pod", "data", "model")
    sizes = (2, 16, 16)
    rmesh = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))
    mesh = SimpleNamespace(mesh_dim_names=axes, shape=sizes)
    shape = (kind, 4096, B_, kind)
    full = dataclasses.replace(REGISTRY[ARCH], **MAMBA1)
    rfull = dataclasses.replace(RREGISTRY[ARCH], **MAMBA1)
    rplan = rplan_for(rfull, RShapeConfig(*shape), rmesh)
    plan = plan_for(full, ShapeConfig(*shape), mesh)
    want = {_port_name(k): tuple(v) for k, v in
            _flat(rbuild(rfull, rplan).cache_specs())}
    got = cache_specs(full, plan)
    assert sorted(got) == sorted(want)
    # the reference's hybrid cache holds a Mamba2 state whatever the
    # blocks (its init_cache: ROADMAP §3), so its spec of "ssm" is (..,
    # batch, inner, None, None); the port's Mamba1 state (L, B, d_inner,
    # N) takes the reference's spec of the ssm family's Mamba1 state
    ssm = RREGISTRY["falcon-mamba-7b"]
    rssm = rplan_for(ssm, RShapeConfig(*shape), rmesh)
    mamba1 = dict(_flat(rbuild(ssm, rssm).cache_specs()))["ssm"]
    assert tuple(want["ssm"])[-4:] == tuple(mamba1)[-3:] + (None,)
    assert got["ssm"] == tuple(mamba1)
    assert got["ssm"][2] is not None         # d_inner over the model axis
    for name, spec in got.items():
        if name == "ssm":
            continue
        n = len(spec) - (name != "pos")
        assert spec[len(spec) - n:] == want[name][len(want[name]) - n:], \
            name


@pytest.mark.parametrize("case", ["arange", "left"])
def test_serving_matches_reference(case):
    serve_against_reference(ARCH, _batch(_cfg(), case), **MAMBA1)


@pytest.mark.parametrize("case", ["none", "left"])
def test_train_step_matches_reference(case):
    """A train step without positions and on left-padded rows.  Without
    them the reference takes arange(S), so it is given arange(S) as
    positions: the same numbers, and its compiled step is the padded
    case's."""
    _, _, _, cfg, _ = _pair(ARCH, **MAMBA1)
    batch = _batch(cfg, "left", seed=9)
    labels = np.random.default_rng(10).integers(0, cfg.vocab_size,
                                                (B, S)).astype(np.int32)
    rbatch = None
    if case == "none":
        labels[0, S - 3:] = -1
        rbatch = dict(batch, labels=labels, positions=positions("arange"))
        del batch["positions"]
    else:
        labels[batch["positions"] < 0] = -1
    batch["labels"] = labels
    train_against_reference(ARCH, batch, rbatch, **MAMBA1)


def test_forward_runs_the_mamba1_scan():
    """The model path reaches K8's wrapper once a Mamba1 block (its plain
    version on CPU tensors) and K7's once a group."""
    from repro_torch.kernels import ops
    _, _, model, cfg, _ = _pair(ARCH, **MAMBA1)
    calls = {"scan": 0, "attn": 0}
    orig = ops.selective_scan, ops.flash_attention

    def scan(*a, **k):
        calls["scan"] += 1
        return orig[0](*a, **k)

    def attn(*a, **k):
        calls["attn"] += 1
        return orig[1](*a, **k)
    try:
        ops.selective_scan, ops.flash_attention = scan, attn
        with torch.no_grad():
            model.forward({"tokens": np.zeros((1, 8), np.int64),
                           "positions": padded((3,), 8)})
    finally:
        ops.selective_scan, ops.flash_attention = orig
    assert calls == {"scan": cfg.n_layers,
                     "attn": cfg.n_layers // cfg.hybrid_period}


def test_serve_driver_matches_reference_model_api():
    """``launch.serve.serve`` of the Mamba1 hybrid (8 requests, 4 slots,
    prompts of 24): each request's first 8 tokens equal the reference's
    greedy tokens from its ``prefill`` and ``decode_step`` (two prompts
    at a time, a cache of 40 slots; its serve driver cannot run the
    model: below)."""
    rmodel, params, _, cfg, fns = _pair(ARCH, **MAMBA1)
    got = serve(cfg, load_jax_params(jax.tree_util.tree_map(
        np.asarray, params), cfg), requests=8, slots=4, prompt_len=S,
        max_new=8, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=S).astype(np.int32)
               for _ in range(8)]
    for pair in range(0, 8, B):
        logits, cache = fns["prefill"](
            params, {"tokens": jnp.asarray(np.stack(prompts[pair:pair + B])),
                     "positions": jnp.asarray(padded((0,) * B))})
        want = [np.argmax(logits[:, -1], -1)]
        for t in range(7):
            logits, cache = fns["decode"](
                params, cache, {"tokens": jnp.asarray(want[-1][:, None],
                                                      jnp.int32)},
                jnp.full((B,), S + t, jnp.int32))
            want.append(np.argmax(logits, -1))
        for b in range(B):
            assert got["tokens"][pair + b][:8] == \
                [int(w[b]) for w in want], pair + b


def test_reference_serve_driver_cannot_run_a_mamba1_hybrid():
    """The reference's fault, pinned: its ``init_cache`` gives every
    hybrid a Mamba2 state (g, k, B, H, P, N), while its prefill of a
    Mamba1 hybrid returns the Mamba1 state (g, k, B, d_inner, N), so its
    serve driver's merge of the one into the other fails to broadcast
    (shapes from ``jax.eval_shape``, nothing run)."""
    rmodel, params, _, cfg, _ = _pair(ARCH, **MAMBA1)
    g, k = cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period
    slots = rmodel.init_cache(4, 40)["ssm"].shape
    assert slots == (g, k, 4, cfg.n_ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state)
    wave = jax.eval_shape(lambda p, b: rmodel.prefill(p, b, cache_len=40),
                          params, {"tokens": jnp.zeros((4, S), jnp.int32)}
                          )[1]["ssm"].shape
    assert wave == (g, k, 4, cfg.d_inner, cfg.ssm_state)
    with pytest.raises(ValueError, match="broadcast"):
        jnp.broadcast_to(jnp.zeros(wave), slots)
