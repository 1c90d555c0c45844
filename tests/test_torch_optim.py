"""The port's optimizer substrate (``repro_torch.optim``): the
counterparts of the AdamW, clipping, global-norm and schedule tests of
``tests/test_checkpoint_data_optim.py`` and of ``tests/test_compression.py``
(except its checkpoint case, which is in test_torch_checkpoint_data.py),
and parity with the reference: the same random grads, params and step give
the same new params, moments and metrics to 1e-6 relative in float32, and
the int8 quantizer and error-feedback buffers are bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import AdamW as RAdamW
from repro.optim import GradCompression as RGradCompression
from repro.optim import cosine_schedule as rcosine
from repro.optim import linear_warmup as rwarmup
from repro.optim.adamw import global_norm as rglobal_norm
from repro_torch.optim import (AdamW, GradCompression, cosine_schedule,
                               global_norm, linear_warmup)


def _t(*xs):
    return torch.tensor(np.array(xs, np.float32))


# ------------------------------ optimizer ---------------------------------- #

def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"x": _t(5.0, -3.0)}
    state = opt.init(params)
    for _ in range(200):
        g = {"x": 2 * (params["x"] - _t(1.0, 2.0))}
        params, state, _ = opt.update(g, state, params)
    np.testing.assert_allclose(params["x"].numpy(), [1.0, 2.0], atol=0.05)


def test_grad_clipping():
    opt = AdamW(lr=0.0, clip_norm=1.0)
    params = {"x": torch.zeros(3)}
    state = opt.init(params)
    _, _, m = opt.update({"x": _t(100.0, 0.0, 0.0)}, state, params)
    assert float(m["grad_norm"]) == pytest.approx(100.0)


def test_global_norm():
    assert float(global_norm({"a": _t(3.0), "b": _t(4.0)})) == \
        pytest.approx(5.0)


def test_schedules():
    f = cosine_schedule(1.0, 10, 100)
    assert float(f(0)) == 0.0
    assert float(f(torch.tensor(10, dtype=torch.int32))) == \
        pytest.approx(1.0)
    assert float(f(100)) == pytest.approx(0.1, abs=1e-6)
    g = linear_warmup(2.0, 4)
    assert float(g(2)) == pytest.approx(1.0)
    assert float(g(50)) == pytest.approx(2.0)


# ------------------------------ compression -------------------------------- #

def _train(compression, steps=300, lr=0.05):
    opt = AdamW(lr=lr, weight_decay=0.0, clip_norm=None,
                compression=compression)
    params = {"x": _t(5.0, -3.0, 0.7)}
    target = _t(1.0, 2.0, -0.5)
    state = opt.init(params)
    for _ in range(steps):
        g = {"x": 2 * (params["x"] - target)}
        params, state, _ = opt.update(g, state, params)
    return params["x"].numpy(), target.numpy()


def test_bf16_compression_converges():
    x, t = _train(GradCompression("bf16"))
    np.testing.assert_allclose(x, t, atol=0.05)


def test_int8_with_error_feedback_converges():
    x, t = _train(GradCompression("int8", error_feedback=True))
    np.testing.assert_allclose(x, t, atol=0.05)


def test_none_mode_is_identity():
    c = GradCompression("none")
    g = {"x": _t(1.234567)}
    out, err = c.apply(g, None)
    assert out is g and err is None


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_hypothesis_error_feedback_is_lossless_in_total(seed):
    """EF invariant: sum(compressed) + final_error == sum(true grads)."""
    rng = np.random.default_rng(seed)
    c = GradCompression("int8", error_feedback=True)
    err = {"g": torch.zeros(8)}
    total_true = np.zeros(8)
    total_comp = np.zeros(8)
    for _ in range(12):
        g = {"g": torch.tensor(
            (rng.standard_normal(8) * 10 ** rng.uniform(-3, 2))
            .astype(np.float32))}
        total_true += g["g"].numpy()
        comp, err = c.apply(g, err)
        total_comp += comp["g"].numpy()
    np.testing.assert_allclose(total_comp + err["g"].numpy(), total_true,
                               rtol=1e-4, atol=1e-5)


def test_int8_quantization_error_bounded():
    c = GradCompression("int8", error_feedback=False)
    g = {"g": torch.linspace(-7.0, 7.0, 64)}
    out, _ = c.apply(g, None)
    assert float((out["g"] - g["g"]).abs().max()) <= 7.0 / 127.0 / 2 + 1e-6


# ------------------------------ parity ------------------------------------ #

SHAPES = {"a": (7, 5), "b": (33,), "c": (4, 3, 2)}


def _random_tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _assert_rel(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1e-30, np.abs(want).max()))


@pytest.mark.parametrize("compression", [None, "bf16", "int8", "int8-noef"])
@pytest.mark.parametrize("clip", [1.0, None, 1e3])
def test_adamw_steps_match_reference(compression, clip):
    """Three updates with random grads (the first two large enough to
    clip at clip_norm 1.0) from random params and a cosine schedule."""
    rng = np.random.default_rng(11)
    kw = dict(lr=cosine_schedule(3e-3, 2, 10), clip_norm=clip)
    rkw = dict(lr=rcosine(3e-3, 2, 10), clip_norm=clip)
    if compression:
        ef = compression != "int8-noef"
        mode = compression.split("-")[0]
        kw["compression"] = GradCompression(mode, error_feedback=ef)
        rkw["compression"] = RGradCompression(mode, error_feedback=ef)
    opt, ropt = AdamW(**kw), RAdamW(**rkw)
    p0 = _random_tree(rng)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, rstate = opt.init(params), ropt.init(rparams)
    for step in range(3):
        g = _random_tree(rng, scale=(3.0, 0.5, 1e-3)[step])
        params, state, m = opt.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, params)
        rparams, rstate, rm = ropt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, rstate, rparams)
        assert int(state.step) == int(rstate.step) == step + 1
        for k in SHAPES:
            _assert_rel(params[k].numpy(), rparams[k])
            _assert_rel(state.m[k].numpy(), rstate.m[k])
            _assert_rel(state.v[k].numpy(), rstate.v[k])
        for name in ("grad_norm", "lr"):
            _assert_rel(m[name].numpy(), rm[name])
        if rstate.err is None:
            assert state.err is None
        else:
            for k in SHAPES:
                np.testing.assert_array_equal(state.err[k].numpy(),
                                              np.asarray(rstate.err[k]))


@pytest.mark.parametrize("limit", [1, 60, 70])
def test_grouped_update_bit_equal_to_one_group(monkeypatch, limit):
    """The update a few tensors at a time (GROUP_ELEMENTS 1: one tensor a
    group; 60 and 70: a group of two) leaves parameters and moments bit
    for bit where one group of every tensor leaves them."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(5)
    p0 = _random_tree(rng)
    grads = [_random_tree(rng, scale=s) for s in (3.0, 0.5)]
    out = {}
    for lim in (1 << 28, limit):
        monkeypatch.setattr(adamw, "GROUP_ELEMENTS", lim)
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        assert len(list(adamw._groups(list(SHAPES), params))) == \
            {1 << 28: 1, 1: 3, 60: 2, 70: 2}[lim]
        opt = AdamW(lr=3e-3)
        state = opt.init(params)
        for g in grads:
            params, state, _ = opt.update(
                {k: torch.from_numpy(v) for k, v in g.items()}, state,
                params)
        out[lim] = (params, state.m, state.v)
    for a, b in zip(out[1 << 28], out[limit]):
        for k in SHAPES:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizer_and_error_feedback_bit_equal(mode, seed):
    """The quantizer on gradients over ten decades, ties at half a step
    (round half to even) and an all-zero tensor, then twelve rounds of
    error feedback: bit-equal to the reference."""
    rng = np.random.default_rng(seed)
    c, rc = GradCompression(mode), RGradCompression(mode)
    g = {"wide": (rng.standard_normal(4096) *
                  10.0 ** rng.uniform(-6, 4, 4096)).astype(np.float32),
         "ties": (np.arange(-20, 21) * 0.5).astype(np.float32),
         "zero": np.zeros(16, np.float32)}
    g["ties"][0] = 127.0 * 4                 # scale 4: ties at k + 0.5
    out, _ = c.apply({k: torch.from_numpy(v) for k, v in g.items()}, None)
    rout, _ = rc.apply({k: jnp.asarray(v) for k, v in g.items()}, None)
    for k in g:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(rout[k]))
    err = c.init({k: torch.from_numpy(v) for k, v in g.items()})
    rerr = rc.init({k: jnp.asarray(v) for k, v in g.items()})
    for _ in range(12):
        gi = {k: (rng.standard_normal(v.shape) *
                  10.0 ** rng.uniform(-3, 2)).astype(np.float32)
              for k, v in g.items()}
        comp, err = c.apply({k: torch.from_numpy(v) for k, v in gi.items()},
                            err)
        rcomp, rerr = rc.apply({k: jnp.asarray(v) for k, v in gi.items()},
                               rerr)
        for k in g:
            np.testing.assert_array_equal(comp[k].numpy(),
                                          np.asarray(rcomp[k]))
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(rerr[k]))


def test_global_norm_and_schedules_match_reference():
    rng = np.random.default_rng(3)
    tree = _random_tree(rng, 10.0)
    _assert_rel(global_norm({k: torch.from_numpy(v)
                             for k, v in tree.items()}).numpy(),
                rglobal_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    for f, rf in ((cosine_schedule(2e-3, 7, 50), rcosine(2e-3, 7, 50)),
                  (cosine_schedule(1.0, 0, 10, 0.0), rcosine(1.0, 0, 10, 0.0)),
                  (linear_warmup(0.5, 9), rwarmup(0.5, 9))):
        for s in range(0, 60):
            _assert_rel(f(torch.tensor(s, dtype=torch.int32)).numpy(),
                        rf(jnp.int32(s)))
