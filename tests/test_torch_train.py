"""The port's training path against the reference's, on the CPU.

The reference's smoke smollm-360m (dense, GQA, attention through K7's
``FlashAttention``), qwen3-moe-30b-a3b (moe: attention through K7, the
MoE FFN with its load-balance and router-z losses in the loss),
falcon-mamba-7b (ssm, Mamba1, the scan through K8's ``SelectiveScan``),
zamba2-2.7b (hybrid: Mamba2 blocks in plain torch, the one shared
attention block through K7 six times, its gradients summed),
mixtral-8x7b (moe, every layer's attention windowed to 16 over S = 48)
gemma2-9b (dense, (local, global) pairs, the local layers windowed,
attention and final softcaps), llama-3.2-vision-11b (vlm: self blocks
through K7, gated cross blocks onto projected media in plain torch; the
cross gates set to the same non-zero values in both packages, so the
cross blocks and the projector learn) and musicgen-medium (audio: frame
embeddings through the projector, no embed) in float32, their
parameters carried across with ``load_jax_params``, one batch of
numpy-drawn tokens (frame embeddings, media) and labels (a few pads,
-1):

- the loss equals ``make_loss_fn``'s to 1e-5 relative, and so do the
  moe model's metrics ``ce``, ``lb_loss``, ``z_loss`` and ``drop_frac``;
- every parameter's gradient equals ``jax.grad``'s to GRAD_TOL, measured
  as max |diff| over max |g| per tensor (measured ~9e-7: the two sum in
  other orders);
- the parameters after 1 and 3 AdamW steps of ``make_train_step`` equal
  the reference's to PARAM_TOL absolute (2% of the learning rate: a first
  Adam step moves each parameter by about lr * g / |g|, so a gradient
  element near zero whose float32 rounding differs moves by another
  fraction of lr; measured 1.1e-5).  The moe model's experts see few
  tokens at smoke size, so such elements occur there: an element of its
  parameters may differ by more than PARAM_TOL only where its first
  gradient is within the gradient check's tolerance of zero (|g| <=
  GRAD_TOL x max |g| of its tensor; measured: 1 element of 107,392, its
  gradient 4.8e-9 against -1.0e-9, 3.4e-5 apart), by at most lr a step,
  and at most MOE_PARAM_SHARE of all elements; every other element is
  held to PARAM_TOL.

Also: the analytic backwards of K7 and K8 against autograd through
``kernels/ref.py`` (causal, window, softcap, GQA, non-causal; h0 and the
scan's time chunks), microbatch 2 against 1 and against the reference's,
and remat none / nothing_saveable / dots_saveable giving the same
gradients.  The loss falling over 20 steps is in test_torch_train_loss.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import REGISTRY as RREGISTRY
from repro.models import build_model as rbuild
from repro.optim import AdamW as RAdamW
from repro.runtime.steps import TrainState as RTrainState
from repro.runtime.steps import make_loss_fn as rmake_loss_fn
from repro.runtime.steps import make_train_step as rmake_train_step
from repro.sharding import single_device_plan as rsingle_device_plan
from repro_torch.configs import REGISTRY
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.mamba_scan import SelectiveScan
from repro_torch.models.model import build_model, load_jax_params
from repro_torch.optim import AdamW
from repro_torch.runtime.steps import (init_train_state, make_loss_fn,
                                       make_train_step)
from repro_torch.sharding import single_device_plan
from test_torch_models import _open_gates, inputs, open_gates
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
         "zamba2-2.7b", "mixtral-8x7b", "gemma2-9b", "llama-3.2-vision-11b",
         "musicgen-medium"]
MOE_METRICS = ("ce", "drop_frac", "lb_loss", "z_loss")
B, S = 2, 48
LR = 1e-3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 2e-2 * LR
MOE_PARAM_SHARE = 1e-4


def _cfgs(arch):
    rcfg = dataclasses.replace(RREGISTRY[arch].smoke(), dtype="float32")
    cfg = dataclasses.replace(REGISTRY[arch].smoke(), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    return rcfg, cfg


def _batch(cfg, seed=1, B=B, S=S, pads=3):
    """Tokens and labels with ``pads`` -1s; the audio family's frame
    embeddings in place of the tokens and a vlm's media from ``inputs``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, S - pads:] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.embed_inputs and cfg.family != "vlm":
        return out
    extra = inputs(cfg, seed=seed + 100, B=B, S=S)
    if not cfg.embed_inputs:
        del out["tokens"]
    return dict(out, **{k: v for k, v in extra.items() if k != "tokens"})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's loss, grads and params after 1 and 3 steps, as
    numpy state dicts in the port's names, and its parameter trees before
    each of the 3 steps."""
    rcfg, cfg = _cfgs(arch)
    rmodel = rbuild(rcfg)
    params = _open_gates(rmodel.init(jax.random.PRNGKey(0)), cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    (loss, metrics), grads = jax.value_and_grad(
        rmake_loss_fn(rmodel), has_aux=True)(params, batch)
    opt = RAdamW(lr=LR)
    state = RTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(rmake_train_step(rmodel, opt))
    after, trees = {}, []
    for i in range(1, 4):
        trees.append(_np_tree(state.params))
        state, m = step(state, batch)
        if i in (1, 3):
            after[i] = (load_jax_params(_np_tree(state.params), cfg),
                        float(m["loss"]), float(m["grad_norm"]))
    return (_np_tree(params), float(loss),
            {k: float(v) for k, v in metrics.items()},
            load_jax_params(_np_tree(grads), cfg), after, trees)


def _port(arch, plan=None):
    params = _reference(arch)[0]
    _, cfg = _cfgs(arch)
    return build_model(cfg, plan, device="cpu").load_jax_params(params), cfg


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    rloss, rmetrics = _reference(arch)[1:3]
    model, cfg = _port(arch)
    with torch.no_grad():
        loss, metrics = make_loss_fn(model)(_batch(cfg))
    assert sorted(metrics) == sorted(rmetrics)
    assert float(metrics["tokens"]) == rmetrics["tokens"] == B * S - 3
    assert abs(float(loss) / rloss - 1) <= LOSS_TOL
    assert float(metrics["loss"]) == float(loss)
    if not cfg.is_moe:
        assert float(metrics["ce"]) == float(loss)
        return
    for k in MOE_METRICS:
        assert abs(float(metrics[k]) / rmetrics[k] - 1) <= LOSS_TOL, k
    aux = cfg.router_aux_coef * metrics["lb_loss"] + \
        cfg.router_z_coef * metrics["z_loss"]
    assert float(loss) == float(metrics["ce"] + aux) > float(metrics["ce"])


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    rgrads = _reference(arch)[3]
    model, cfg = _port(arch)
    loss, _ = make_loss_fn(model)(_batch(cfg))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    assert sorted(names) == sorted(rgrads)
    for name, g in zip(names, grads):
        want = rgrads[name].numpy()
        assert np.abs(want).max() > 0, name   # every parameter learns
        assert _rel_err(g.numpy(), want) <= GRAD_TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_steps_match_reference(arch):
    rgrads, after = _reference(arch)[3:5]
    model, cfg = _port(arch)
    opt = AdamW(lr=LR)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    batch = _batch(cfg)
    for i in range(1, 4):
        state, m = step(state, batch)
        assert sorted(m) == sorted(["grad_norm", "loss", "lr", "tokens"] +
                                   (list(MOE_METRICS) if cfg.is_moe else
                                    ["ce"]))
        if i not in after:
            continue
        rparams, rloss, rgnorm = after[i]
        assert int(state.step) == i
        assert abs(float(m["loss"]) / rloss - 1) <= LOSS_TOL
        assert abs(float(m["grad_norm"]) / rgnorm - 1) <= GRAD_TOL
        beyond, total = 0, 0
        for name, p in state.params.items():
            assert p is dict(model.named_parameters())[name]
            got, want = p.detach().numpy(), rparams[name].numpy()
            total += got.size
            if not cfg.is_moe:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=PARAM_TOL, err_msg=name)
                continue
            diff = np.abs(got - want)
            g0 = np.abs(rgrads[name].numpy())
            far = diff > PARAM_TOL
            assert (g0[far] <= GRAD_TOL * g0.max()).all(), name
            assert (diff <= LR * i).all(), name
            beyond += int(far.sum())
        assert beyond <= MOE_PARAM_SHARE * total, (beyond, total)


@pytest.mark.parametrize("arch", ["zamba2-2.7b"])
def test_step_gradients_match_reference(arch):
    """Beside the update check: the gradients each AdamW step takes, at
    the reference's parameters before that step, equal ``jax.grad``'s to
    GRAD_TOL, tensor by tensor.  On its own trajectory the hybrid's
    parameters part from the reference's beyond PARAM_TOL where AdamW's
    first update of a near-zero gradient divides rounding by rounding, and
    its later gradients follow them; at the same parameters its ops
    agree."""
    rcfg, cfg = _cfgs(arch)
    rmodel = rbuild(rcfg)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rgrad = jax.jit(jax.grad(
        lambda p: rmake_loss_fn(rmodel)(p, jbatch)[0]))
    for i, tree in enumerate(_reference(arch)[5], 1):
        want = load_jax_params(_np_tree(rgrad(tree)), cfg)
        model = build_model(cfg, None, device="cpu").load_jax_params(tree)
        loss, _ = make_loss_fn(model)(batch)
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
        assert sorted(n for n, _ in named) == sorted(want)
        for (name, _), g in zip(named, grads):
            assert _rel_err(g.numpy(), want[name].numpy()) <= GRAD_TOL, \
                (i, name)


def test_microbatch_grad_accumulation_matches():
    """plan.microbatch=2 gives the same update as 1, and as the
    reference's microbatch=2 step (no pads: the step averages the
    microbatches' mean losses, as the reference does)."""
    arch = "smollm-360m"
    rcfg, cfg = _cfgs(arch)
    params = _reference(arch)[0]
    batch = _batch(cfg, seed=5, B=4, S=32, pads=0)
    out = {}
    for mb in (1, 2):
        model, _ = _port(arch, single_device_plan().with_(microbatch=mb))
        opt = AdamW(lr=LR)
        state, m = make_train_step(model, opt)(init_train_state(model, opt),
                                               batch)
        out[mb] = (float(m["loss"]), {k: v.detach().clone()
                                      for k, v in state.params.items()})
    assert out[1][0] == pytest.approx(out[2][0], rel=1e-5)
    for k in out[1][1]:
        torch.testing.assert_close(out[1][1][k], out[2][1][k], rtol=0,
                                   atol=PARAM_TOL)
    rmodel = rbuild(rcfg, rsingle_device_plan().with_(microbatch=2))
    ropt = RAdamW(lr=LR)
    rstate = RTrainState(params, ropt.init(params), jnp.zeros((), jnp.int32))
    rstate, rm = jax.jit(rmake_train_step(rmodel, ropt))(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(out[2][0] / float(rm["loss"]) - 1) <= LOSS_TOL
    rp = load_jax_params(_np_tree(rstate.params), cfg)
    for k, v in out[2][1].items():
        np.testing.assert_allclose(v.numpy(), rp[k].numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_grads(arch):
    cfg = REGISTRY[arch].smoke()
    batch = _batch(cfg, seed=3)
    grads = {}
    for remat in ("none", "nothing_saveable", "dots_saveable"):
        model = open_gates(build_model(
            cfg, single_device_plan().with_(remat=remat), device="cpu",
            seed=1))
        loss, _ = make_loss_fn(model)(batch)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for remat in ("nothing_saveable", "dots_saveable"):
        for a, b in zip(grads["none"], grads[remat]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        model = build_model(cfg, single_device_plan().with_(remat="all"),
                            device="cpu")
        make_loss_fn(model)(batch)


# ----------------------- the kernels' custom backwards --------------------- #

def _attn_grads(fn, q, k, v, do):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    return (out,) + torch.autograd.grad(out, (q, k, v), do)


def _attn_case(B, S, H, KV, hd, dtype, opts, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, n, hd), generator=g).to(dtype)
                   for n in (H, KV, KV, H))
    got = _attn_grads(lambda *a: FlashAttention.apply(
        *a, opts.get("causal", True), opts.get("window"),
        opts.get("attn_softcap")), q, k, v, do)
    want = _attn_grads(lambda *a: ref.attention_ref(*a, **opts), q, k, v, do)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,opts", [
    (2, 33, 4, 2, 16, {}),
    (1, 64, 6, 2, 32, dict(window=9)),
    (2, 40, 4, 4, 16, dict(attn_softcap=5.0)),
    (1, 50, 8, 1, 16, dict(window=17, attn_softcap=20.0)),
    (2, 30, 4, 2, 16, dict(causal=False)),
    (1, 1, 2, 1, 64, {}),
    (1, 45, 4, 4, 80, dict(window=20))])          # zamba2's head dim
def test_attention_backward_matches_autograd_through_ref(B, S, H, KV, hd,
                                                         opts, dtype):
    _attn_case(B, S, H, KV, hd, dtype, opts, seed=S)


@settings(max_examples=15, deadline=None)
@given(S=st.integers(1, 40), groups=st.sampled_from([(2, 1), (4, 2), (3, 3)]),
       window=st.one_of(st.none(), st.integers(1, 20)),
       cap=st.one_of(st.none(), st.floats(1.0, 50.0)),
       causal=st.booleans(), seed=st.integers(0, 1000))
def test_hypothesis_attention_backward(S, groups, window, cap, causal, seed):
    _attn_case(1, S, groups[0], groups[1], 16, torch.float32,
               dict(causal=causal, window=window, attn_softcap=cap), seed)


def _scan_inputs(Bz, S, D, N, with_h0, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn((Bz, S, D), generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((Bz, S, D), generator=g)
                                      - 1)
    A = -torch.exp(torch.randn((D, N), generator=g) * 0.3)
    Bm = torch.randn((Bz, S, N), generator=g).to(dtype)
    Cm = torch.randn((Bz, S, N), generator=g).to(dtype)
    h0 = torch.randn((Bz, D, N), generator=g) if with_h0 else None
    dy = torch.randn((Bz, S, D), generator=g)
    dh = torch.randn((Bz, D, N), generator=g)
    return [u, dt, A, Bm, Cm, h0], dy, dh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bz,S,D,N,with_h0,chunk", [
    (2, 37, 12, 8, False, 256), (2, 37, 12, 8, True, 8),
    (1, 64, 16, 16, True, 32), (3, 5, 7, 4, True, 1),
    (1, 1, 4, 4, False, 4), (2, 20, 6, 16, True, 7)])
def test_scan_backward_matches_autograd_through_ref(Bz, S, D, N, with_h0,
                                                    chunk, dtype):
    ins, dy, dh = _scan_inputs(Bz, S, D, N, with_h0, seed=S + D, dtype=dtype)
    out = {}
    for name, fn in (("custom", lambda *a: SelectiveScan.apply(*a, chunk)),
                     ("autograd", ref.selective_scan_ref)):
        xs = [None if t is None else t.detach().clone().requires_grad_()
              for t in ins]
        y, h = fn(*xs)
        live = [t for t in xs if t is not None]
        out[name] = (y, h) + torch.autograd.grad((y, h), live, (dy, dh))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(out["custom"], out["autograd"]):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


def test_ops_route_through_the_autograd_functions():
    """ops' impl="cuda" path is differentiable (the Functions) and leaves
    the launch counters alone on the CPU; impl="ref" differentiates
    through the plain versions."""
    ins, dy, _ = _scan_inputs(1, 9, 4, 4, False, seed=0)
    ins = [t if t is None else t.requires_grad_() for t in ins]
    for impl in ("cuda", "ref"):
        y, _ = ops.selective_scan(*ins, impl=impl)
        assert y.requires_grad
        q = torch.randn(1, 5, 2, 16, requires_grad=True)
        k = torch.randn(1, 5, 1, 16, requires_grad=True)
        o = ops.flash_attention(q, k, k, impl=impl)
        assert o.requires_grad
        if impl == "cuda":
            assert o.grad_fn.name().startswith("FlashAttention")
            assert y.grad_fn.name().startswith("SelectiveScan")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    assert fa.flash_attention.launches == 0
    assert ms.selective_scan.launches == 0
