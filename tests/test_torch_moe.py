"""The port's MoE FFN against the reference's ``repro.models.moe``, on the
CPU, at smoke width (d 64, 4 experts, top-2, d_ff 32 an expert).

The same numpy-drawn weights and tokens go through both, in float32:
``y`` within 1e-5, ``lb_loss`` and ``z_loss`` within 1e-6 relative (the
two sum in other orders), ``drop_frac`` exactly (both count the kept
slots exactly and scale by the float32 reciprocal of the slot count).
The cases cover capacity factors with no drop, some and many drops, a
``valid`` mask, and token counts that are not a multiple of the group
size (zero-padded groups).  Also: the top-k order among tied
probabilities (``jax.lax.top_k``'s: the lower expert first), the
capacity formula, the gradients against ``jax.grad``, and the ports of
``tests/test_ssm_moe.py``'s four MoE cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREGISTRY
from repro.models.moe import _capacity as rcapacity
from repro.models.moe import moe_aux_total as rmoe_aux_total
from repro.models.moe import moe_ffn as rmoe_ffn
from repro.sharding import single_device_plan as rsingle_device_plan
from repro_torch.configs import REGISTRY
from repro_torch.models.moe import _capacity, moe_aux_total, moe_ffn, route
from repro_torch.models.transformer import model_defs
from repro_torch.sharding import init_from_defs, single_device_plan
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

ARCH = "qwen3-moe-30b-a3b"
Y_TOL = 1e-5
AUX_TOL = 1e-6
B, S = 3, 37                  # T = 111 tokens


def _cfgs(cf=1.25, arch=ARCH):
    rcfg = dataclasses.replace(RREGISTRY[arch].smoke(), dtype="float32",
                               capacity_factor=cf)
    cfg = dataclasses.replace(REGISTRY[arch].smoke(), dtype="float32",
                              capacity_factor=cf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    return rcfg, cfg


def _weights(cfg, seed=0, router_scale=0.5):
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {"router": rng.standard_normal((d, E)) * router_scale,
            "w1": rng.standard_normal((E, d, f)) * d ** -0.5,
            "w3": rng.standard_normal((E, d, f)) * d ** -0.5,
            "w2": rng.standard_normal((E, f, d)) * f ** -0.5}


def _inputs(cfg, seed=1, valid=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mask = rng.random((B, S)) > 0.25 if valid else None
    return x, mask


def _run_both(rcfg, cfg, w, x, mask, group):
    w32 = {k: v.astype(np.float32) for k, v in w.items()}
    ry, raux = rmoe_ffn({k: jnp.asarray(v) for k, v in w32.items()},
                        jnp.asarray(x), rcfg,
                        rsingle_device_plan().with_(moe_group_size=group),
                        valid=None if mask is None else jnp.asarray(mask))
    y, aux = moe_ffn({k: torch.from_numpy(v) for k, v in w32.items()},
                     torch.from_numpy(x), cfg,
                     single_device_plan().with_(moe_group_size=group),
                     valid=None if mask is None else torch.from_numpy(mask))
    return (y, aux), (ry, raux)


def _assert_aux(aux, raux):
    assert sorted(aux) == sorted(raux) == ["drop_frac", "lb_loss", "z_loss"]
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(raux[k]),
                                   rtol=AUX_TOL, atol=0, err_msg=k)
    assert float(aux["drop_frac"]) == float(raux["drop_frac"])


@pytest.mark.parametrize("group", [16, 2048])
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_ffn_matches_reference(cf, valid, group):
    """group 16: seven groups of 16, the last nine tokens padding; 2048:
    one group of all 111 tokens."""
    rcfg, cfg = _cfgs(cf)
    x, mask = _inputs(cfg, valid=valid)
    (y, aux), (ry, raux) = _run_both(rcfg, cfg, _weights(cfg), x, mask,
                                     group)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=Y_TOL,
                               rtol=Y_TOL)
    _assert_aux(aux, raux)
    if cf == 0.25:
        assert float(aux["drop_frac"]) > 0.3
    if cf == 8.0 and not valid:
        assert float(aux["drop_frac"]) < 0.1     # the padding's slots only
    total = moe_aux_total(aux, cfg)
    assert float(total) == pytest.approx(
        float(rmoe_aux_total(raux, rcfg)), rel=AUX_TOL)


def test_top_k_tie_break_is_jax_lax_top_k():
    """Rows of float32 logits drawn from four values, so most rows tie:
    the port's top-k ids and gates equal jax.lax.top_k's on the same
    probabilities, lower expert first among equals."""
    rng = np.random.default_rng(3)
    logits = rng.integers(0, 4, (500, 8)).astype(np.float32) * 0.5
    for k in (1, 2, 3, 8):
        probs, gates, ids = route(torch.from_numpy(logits), k)
        rprobs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
        rvals, rids = jax.lax.top_k(rprobs, k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
        rg = np.asarray(rvals / jnp.maximum(rvals.sum(-1, keepdims=True),
                                            1e-9))
        np.testing.assert_allclose(gates.numpy(), rg, rtol=1e-6, atol=0)
        np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs),
                                   rtol=1e-6, atol=0)
    # ties really occur and resolve lowest id first
    ids = route(torch.tensor([[0.0, 1.0, 1.0, 1.0]]), 2)[2]
    assert ids.tolist() == [[1, 2]]


def test_moe_ffn_with_tied_router_columns_matches_reference():
    """Experts 1, 2 and 3 share one router column, so every token's
    probabilities tie among them; their FFNs differ, so a tie broken
    another way than the reference's would change y."""
    rcfg, cfg = _cfgs(8.0)
    w = _weights(cfg, seed=4)
    w["router"][:, 2] = w["router"][:, 1]
    w["router"][:, 3] = w["router"][:, 1]
    x, _ = _inputs(cfg, seed=5)
    logits = torch.from_numpy(x).reshape(-1, cfg.d_model) @ \
        torch.from_numpy(w["router"].astype(np.float32))
    assert torch.equal(logits[:, 1], logits[:, 2])
    assert torch.equal(logits[:, 1], logits[:, 3])
    (y, aux), (ry, raux) = _run_both(rcfg, cfg, w, x, None, 2048)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=Y_TOL,
                               rtol=Y_TOL)
    _assert_aux(aux, raux)


@pytest.mark.parametrize("sg", [1, 3, 16, 100, 2048])
def test_capacity_matches_reference(sg):
    for k in (1, 2, 8):
        for e in (4, 8, 128):
            for cf in (0.25, 1.0, 1.25, 8.0):
                assert _capacity(sg, k, e, cf) == rcapacity(sg, k, e, cf)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_ffn_grads_match_jax_grad(cf, valid):
    """d(sum(y * r) + the aux total)/d(x, router, w1, w3, w2) against
    jax.grad of the reference's; max |diff| over max |g| per tensor."""
    rcfg, cfg = _cfgs(cf)
    w = {k: v.astype(np.float32) for k, v in _weights(cfg, seed=6).items()}
    x, mask = _inputs(cfg, seed=7, valid=valid)
    r = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    plan, rplan = single_device_plan().with_(moe_group_size=16), \
        rsingle_device_plan().with_(moe_group_size=16)

    def rloss(p, xx):
        y, aux = rmoe_ffn(p, xx, rcfg, rplan,
                          valid=None if mask is None else jnp.asarray(mask))
        return jnp.sum(y * r) + rmoe_aux_total(aux, rcfg)
    rgp, rgx = jax.grad(rloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe_ffn(p, xt, cfg, plan,
                     valid=None if mask is None else torch.from_numpy(mask))
    loss = (y * torch.from_numpy(r)).sum() + moe_aux_total(aux, cfg)
    grads = torch.autograd.grad(loss, [xt] + [p[k] for k in sorted(p)])
    wants = [rgx] + [rgp[k] for k in sorted(p)]
    for name, g, want in zip(["x"] + sorted(p), grads, wants):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= Y_TOL, (name, err)


# ---------------- ports of tests/test_ssm_moe.py's MoE cases -------------- #

def _moe_setup(cf=8.0, E=4, K=2):
    cfg = dataclasses.replace(REGISTRY["mixtral-8x7b"].smoke(),
                              dtype="float32", capacity_factor=cf,
                              n_experts=E, top_k=K)
    defs = model_defs(cfg)["layers"]
    params = init_from_defs(defs, torch.Generator().manual_seed(0),
                            torch.float32)
    return cfg, {k: v[0] for k, v in params["moe"].items()}


def _normal(shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_moe_no_drop_equals_dense_mixture():
    """With ample capacity, grouped-scatter dispatch must equal the dense
    'run every expert on every token and mix' computation."""
    cfg, p = _moe_setup(cf=8.0)
    x = _normal((2, 16, cfg.d_model))
    y, aux = moe_ffn(p, x, cfg, single_device_plan())
    assert float(aux["drop_frac"]) < 1e-6

    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, -1)
    vals, idx = torch.topk(probs, cfg.top_k)
    vals = vals / vals.sum(-1, keepdim=True)
    dense = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        g = torch.nn.functional.silu(x @ p["w1"][e])
        u = x @ p["w3"][e]
        oe = (g * u) @ p["w2"][e]
        w_e = torch.where(idx == e, vals, 0.0).sum(-1)
        dense += oe * w_e[..., None]
    np.testing.assert_allclose(y.numpy(), dense.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_moe_capacity_drops_accounted():
    cfg, p = _moe_setup(cf=0.25)
    x = _normal((2, 32, cfg.d_model))
    y, aux = moe_ffn(p, x, cfg, single_device_plan())
    assert float(aux["drop_frac"]) > 0.0
    assert bool(torch.isfinite(y).all())


def test_moe_aux_losses_sane():
    cfg, p = _moe_setup()
    x = _normal((2, 64, cfg.d_model))
    _, aux = moe_ffn(p, x, cfg, single_device_plan())
    # lb loss >= 1 with equality iff perfectly balanced
    assert float(aux["lb_loss"]) >= 1.0 - 1e-3
    assert float(aux["z_loss"]) >= 0.0


def test_capacity_formula():
    assert _capacity(1, 8, 128, 1.25) == 8      # >= top_k
    assert _capacity(2048, 8, 128, 1.25) == 160
    assert _capacity(2048, 8, 128, 1.25) % 4 == 0
