"""The port's Mamba2 (SSD) against the reference's ``repro.models.ssm``.

``ssd_chunked``, ``ssd_step`` and ``mamba2_mix`` are plain jnp in the
reference (no Pallas kernel) and plain torch in the port, term for term;
the same numpy-drawn float32 inputs go through both.  The chunked form
is held over chunk sizes that divide S and ones that do not (zero
padding), with and without an initial state, to SSD_TOL (1e-5 absolute
and relative: the two sum their einsums in other orders; measured below
1e-6 relative to the outputs).  The port's chunked form against its own
step loop is ``test_ssm_moe.py::test_ssd_chunked_vs_step``'s check, at
its 1e-4.  ``mamba2_mix`` runs a prefill and then decode steps with the
conv and SSM states threaded, at the zamba2 smoke config's widths; its
gradients (and the SSD's) against ``jax.grad`` to GRAD_TOL of max |g|
per tensor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREGISTRY
from repro.models import ssm as rssm
from repro.models.transformer import mamba_defs as rmamba_defs
from repro.sharding import init_from_defs as rinit_from_defs
from repro.sharding import single_device_plan as rsingle_device_plan
from repro_torch.configs import REGISTRY
from repro_torch.models import ssm
from repro_torch.sharding import single_device_plan

SSD_TOL = 1e-5
STEP_TOL = 1e-4
GRAD_TOL = 1e-5
ARCH = "zamba2-2.7b"


def _inputs(Bz, S, H, P, N, with_h0, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    xh = f(Bz, S, H, P)
    dt = np.log1p(np.exp(f(Bz, S, H) - 1)).astype(np.float32)   # softplus
    A = -np.exp(f(H) * 0.3).astype(np.float32)
    Bm, Cm = f(Bz, S, N), f(Bz, S, N)
    h0 = f(Bz, H, P, N) if with_h0 else None
    return xh, dt, A, Bm, Cm, h0


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=tol, rtol=tol,
        err_msg=what)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("Bz,S,H,P,N,chunk", [
    (2, 48, 4, 8, 8, 16),      # chunks divide S
    (2, 50, 4, 8, 8, 16),      # the last chunk padded
    (1, 37, 3, 4, 16, 8),      # padded, N != P
    (2, 20, 4, 8, 8, 128),     # one chunk: min(chunk, S)
    (1, 1, 2, 4, 4, 16)])      # a single step
def test_ssd_chunked_matches_reference(Bz, S, H, P, N, chunk, with_h0):
    ins = _inputs(Bz, S, H, P, N, with_h0, seed=S * 7 + N)
    y, h = ssm.ssd_chunked(*map(_t, ins[:5]), chunk=chunk, h0=_t(ins[5]))
    ry, rh = rssm.ssd_chunked(*map(_j, ins[:5]), chunk=chunk, h0=_j(ins[5]))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (Bz, S, H, P) and h.shape == (Bz, H, P, N)
    _close(y, ry, SSD_TOL, "y")
    _close(h, rh, SSD_TOL, "h_last")


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_step_matches_reference(with_h0):
    xh, dt, A, Bm, Cm, h0 = _inputs(3, 4, 4, 8, 8, with_h0, seed=5)
    h = np.zeros((3, 4, 8, 8), np.float32) if h0 is None else h0
    th, rh = _t(h), _j(h)
    for t in range(4):
        th, y = ssm.ssd_step(th, _t(xh[:, t]), _t(dt[:, t]), _t(A),
                             _t(Bm[:, t]), _t(Cm[:, t]))
        rh, ry = rssm.ssd_step(rh, _j(xh[:, t]), _j(dt[:, t]), _j(A),
                               _j(Bm[:, t]), _j(Cm[:, t]))
        _close(y, ry, SSD_TOL, f"y t={t}")
        _close(th, rh, SSD_TOL, f"h t={t}")


@pytest.mark.parametrize("S,chunk", [(48, 16), (45, 16)])
def test_ssd_chunked_vs_step(S, chunk):
    """test_ssm_moe.py::test_ssd_chunked_vs_step on the port alone."""
    xh, dt, A, Bm, Cm, _ = map(_t, _inputs(1, S, 4, 8, 8, False, seed=0))
    y_all, h_all = ssm.ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk)
    h = torch.zeros((1, 4, 8, 8))
    ys = []
    for t in range(S):
        h, y = ssm.ssd_step(h, xh[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(y)
    torch.testing.assert_close(h, h_all, atol=STEP_TOL, rtol=STEP_TOL)
    torch.testing.assert_close(torch.stack(ys, 1), y_all, atol=STEP_TOL,
                               rtol=STEP_TOL)


def test_ssd_state_threading():
    """Two chunked halves with the state carried equal one pass."""
    xh, dt, A, Bm, Cm, _ = map(_t, _inputs(2, 40, 4, 8, 8, False, seed=3))
    y, h = ssm.ssd_chunked(xh, dt, A, Bm, Cm, chunk=16)
    y1, h1 = ssm.ssd_chunked(xh[:, :24], dt[:, :24], A, Bm[:, :24],
                             Cm[:, :24], chunk=16)
    y2, h2 = ssm.ssd_chunked(xh[:, 24:], dt[:, 24:], A, Bm[:, 24:],
                             Cm[:, 24:], chunk=16, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=STEP_TOL,
                               rtol=STEP_TOL)
    torch.testing.assert_close(h2, h, atol=STEP_TOL, rtol=STEP_TOL)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("S,chunk,with_h0", [(48, 16, True), (37, 8, False),
                                             (30, 128, True)])
def test_ssd_grads_match_jax(S, chunk, with_h0):
    ins = _inputs(2, S, 4, 8, 8, with_h0, seed=S)
    rng = np.random.default_rng(S + 1)
    wy = rng.standard_normal((2, S, 4, 8)).astype(np.float32)
    wh = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    live = [i for i, x in enumerate(ins) if x is not None]

    def rloss(*xs):
        args = list(ins)
        for i, x in zip(live, xs):
            args[i] = x
        y, h = rssm.ssd_chunked(*args[:5], chunk=chunk, h0=args[5])
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(rloss, argnums=tuple(range(len(live))))(
        *[jnp.asarray(ins[i]) for i in live])
    xs = [_t(ins[i]).requires_grad_() for i in live]
    args = [None] * 6
    for i, x in zip(live, xs):
        args[i] = x
    y, h = ssm.ssd_chunked(*args[:5], chunk=chunk, h0=args[5])
    loss = (y * _t(wy)).sum() + (h * _t(wh)).sum()
    got = torch.autograd.grad(loss, xs)
    names = ["xh", "dt", "A", "B", "C", "h0"]
    for i, g, w in zip(live, got, want):
        assert np.isfinite(g.numpy()).all(), names[i]
        assert _rel_err(g.numpy(), w) <= GRAD_TOL, names[i]


def _mix_setup(seed=0):
    rcfg = dataclasses.replace(RREGISTRY[ARCH].smoke(), dtype="float32")
    cfg = dataclasses.replace(REGISTRY[ARCH].smoke(), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    rp = rinit_from_defs(rmamba_defs(rcfg), jax.random.PRNGKey(seed),
                         jnp.float32)
    # non-trivial dt_bias, A_log, D and norm, so every term moves
    rng = np.random.default_rng(seed)
    rp = {k: jnp.asarray(np.asarray(v) + 0.1 * rng.standard_normal(
        v.shape).astype(np.float32)) for k, v in rp.items()}
    p = {k: _t(np.asarray(v)) for k, v in rp.items()}
    return rcfg, cfg, rp, p


def test_mamba2_mix_prefill_decode_match_reference():
    """A 20-token prefill (chunk 8: padded) then 5 decode steps, the conv
    and SSM states threaded through both packages."""
    rcfg, cfg, rp, p = _mix_setup()
    rplan = rsingle_device_plan().with_(ssm_chunk=8)
    x = np.random.default_rng(1).standard_normal(
        (2, 25, cfg.d_model)).astype(np.float32)
    P = 20
    ry, rconv, rstate = rssm.mamba2_mix(rp, jnp.asarray(x[:, :P]), rcfg,
                                        rplan)
    y, conv, state = ssm.mamba2_mix(p, _t(x[:, :P]), cfg, ssm_chunk=8)
    assert state.shape == (2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state)
    _close(y, ry, SSD_TOL, "prefill y")
    _close(conv, rconv, SSD_TOL, "prefill conv state")
    _close(state, rstate, SSD_TOL, "prefill ssm state")
    for t in range(P, 25):
        ry, rconv, rstate = rssm.mamba2_mix(
            rp, jnp.asarray(x[:, t:t + 1]), rcfg, rplan, conv_state=rconv,
            ssm_state=rstate, decode=True)
        y, conv, state = ssm.mamba2_mix(p, _t(x[:, t:t + 1]), cfg,
                                        conv_state=conv, ssm_state=state,
                                        decode=True)
        _close(y, ry, SSD_TOL, f"decode y t={t}")
        _close(state, rstate, SSD_TOL, f"decode ssm state t={t}")


def test_mamba2_mix_prefill_with_state_matches_decode_loop():
    """The port's prefill from a carried state equals decoding the same
    tokens one at a time (the serving invariant at the mixer)."""
    _, cfg, _, p = _mix_setup(seed=2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 14, cfg.d_model)).astype(np.float32))
    _, conv, state = ssm.mamba2_mix(p, x[:, :6], cfg, ssm_chunk=4)
    y_pre, _, s_pre = ssm.mamba2_mix(p, x[:, 6:], cfg, conv_state=conv,
                                     ssm_state=state, ssm_chunk=4)
    ys = []
    for t in range(6, 14):
        y, conv, state = ssm.mamba2_mix(p, x[:, t:t + 1], cfg,
                                        conv_state=conv, ssm_state=state,
                                        decode=True)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_pre, atol=STEP_TOL,
                               rtol=STEP_TOL)
    torch.testing.assert_close(state, s_pre, atol=STEP_TOL, rtol=STEP_TOL)


def test_mamba2_mix_grads_match_jax():
    rcfg, cfg, rp, p = _mix_setup(seed=4)
    rplan = rsingle_device_plan().with_(ssm_chunk=8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)

    def rloss(params, xx):
        return jnp.sum(rssm.mamba2_mix(params, xx, rcfg, rplan)[0] * w)

    rg, rgx = jax.grad(rloss, argnums=(0, 1))(rp, jnp.asarray(x))
    # the block's pre-norm "ln" is mamba_block's, not the mixer's
    params = {k: v.clone().requires_grad_() for k, v in p.items()
              if k != "ln"}
    xt = _t(x).requires_grad_()
    y = ssm.mamba2_mix(params, xt, cfg, ssm_chunk=8)[0]
    grads = torch.autograd.grad((y * _t(w)).sum(),
                                [xt] + list(params.values()))
    assert _rel_err(grads[0].numpy(), rgx) <= GRAD_TOL, "x"
    for name, g in zip(params, grads[1:]):
        assert np.abs(np.asarray(rg[name])).max() > 0, name
        assert _rel_err(g.numpy(), rg[name]) <= GRAD_TOL, name


def test_mamba2_chunk_follows_the_plan():
    """The SSD's chunk is min(128, plan.ssm_chunk), as in the reference:
    any chunk gives the same outputs to STEP_TOL."""
    _, cfg, _, p = _mix_setup(seed=6)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 33, cfg.d_model)).astype(np.float32))
    outs = [ssm.mamba2_mix(p, x, cfg, ssm_chunk=c)
            for c in (single_device_plan().ssm_chunk, 128, 16, 5)]
    for y, _, h in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], atol=STEP_TOL,
                                   rtol=STEP_TOL)
        torch.testing.assert_close(h, outs[0][2], atol=STEP_TOL,
                                   rtol=STEP_TOL)
