"""The port's attention pieces of the swa and local_global schedules,
and the vlm's cross attention, against the reference's, on the CPU.

``tests/test_attention_jnp.py``'s window, softcap, decode and rolling
``write_cache`` cases, with the same numpy-drawn inputs through the
reference's blocked jnp ``flash_attention`` (its ``window`` schedule) and
``decode_attention`` and through the port's ``kernels.ref.attention_ref``
(K7's plain version, what ``ops.flash_attention`` takes for CPU tensors),
``models.attention.decode_attention`` and ``write_cache`` (float32, 2e-5,
the reference test's tolerance).  Then
``tests/test_decode_consistency.py::test_rolling_window_cache_smaller_than_
context`` across the packages: mixtral's smoke model with a window of 8,
a prompt of 16 and 32 positions, the port's prefill and decode against
the reference's full forward (1e-3), its rolling cache exactly ``window``
slots.  The reference's ``dense`` / ``causal_skip`` block schedules belong
to its jnp dry-run path and have no counterpart in the port.
``models.attention.cross_attention`` against the reference's (plain jnp
in both: unmasked attention onto M media positions, optionally masked by
``media_valid``) over query groups G of 1, 2 and 4, one or 16 query
positions and M of 8 and 37, in float32 (2e-5) and bfloat16 (2e-2: the
probabilities round to bfloat16 before the second product, where the
packages' float32 exponentials may differ by an ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREGISTRY
from repro.kernels.ref import attention_ref as rattention_ref
from repro.models import attention as RA
from repro.models import build_model as rbuild
from repro_torch.configs import REGISTRY
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import attention as A
from repro_torch.models.model import build_model

TOL = 2e-5


def _qkv(B=2, S=192, H=4, KV=2, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd)).astype(np.float32)
                 for n in (H, KV, KV))


def _pos(B, S):
    return jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("S,W,cap", [(256, 64, None), (128, None, 50.0),
                                     (200, 48, 50.0), (100, 1, None)])
def test_window_and_softcap_match_reference(S, W, cap):
    """The reference's window schedule (and its softcap) against the port's
    plain K7 and ``ops.flash_attention`` on CPU tensors."""
    q, k, v = _qkv(S=S, seed=S)
    B = q.shape[0]
    want = RA.flash_attention(*map(jnp.asarray, (q, k, v)), _pos(B, S),
                              _pos(B, S), causal=True, window=W,
                              attn_softcap=cap, block_q=64, block_kv=64,
                              schedule="window" if W else None)
    _close(rattention_ref(*map(jnp.asarray, (q, k, v)), causal=True,
                          window=W, attn_softcap=cap), want)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    _close(attention_ref(qt, kt, vt, causal=True, window=W,
                         attn_softcap=cap), want)
    _close(ops.flash_attention(qt, kt, vt, causal=True, window=W,
                               attn_softcap=cap), want)


@pytest.mark.parametrize("window,cap", [(None, None), (None, 50.0),
                                        (16, None), (16, 30.0)])
def test_decode_attention_matches_reference(window, cap):
    """One query at the last position over a full cache: the reference's
    decode_attention, the port's, and the last row of full attention."""
    q, k, v = _qkv(S=64, seed=1)
    B, S = q.shape[:2]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = RA.decode_attention(jq[:, -1:], jk, jv,
                               q_pos=jnp.full((B,), S - 1, jnp.int32),
                               slot_pos=_pos(B, S), attn_softcap=cap,
                               window=window)
    got = A.decode_attention(torch.from_numpy(q[:, -1:]),
                             torch.from_numpy(k), torch.from_numpy(v),
                             torch.full((B,), S - 1),
                             torch.arange(S).expand(B, S),
                             attn_softcap=cap, window=window)
    _close(got, want)
    full = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                         window=window, attn_softcap=cap)
    _close(got[:, 0], full[:, -1])


def test_decode_attention_over_rolling_cache():
    """A window of W over a rolling cache of W slots (slot = position mod
    W, some slots still empty for one batch row): equal to the reference's
    and to full windowed attention's row at that position."""
    q, k, v = _qkv(B=2, S=40, seed=2)
    W, t = 16, 39
    B = q.shape[0]
    ck = np.zeros((B, W) + k.shape[2:], np.float32)
    cv = np.zeros_like(ck)
    sp = np.full((B, W), -1, np.int64)
    for s in range(t + 1):
        ck[:, s % W], cv[:, s % W], sp[:, s % W] = k[:, s], v[:, s], s
    sp[1, 3] = -1                       # an empty slot in row 1
    want = RA.decode_attention(jnp.asarray(q[:, t:t + 1]), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.full((B,), t, jnp.int32),
                               jnp.asarray(sp, jnp.int32), window=W)
    got = A.decode_attention(torch.from_numpy(q[:, t:t + 1]),
                             torch.from_numpy(ck), torch.from_numpy(cv),
                             torch.full((B,), t), torch.from_numpy(sp),
                             window=W)
    _close(got, want)
    full = attention_ref(*map(torch.from_numpy, (q, k, v)), window=W)
    _close(got[0, 0], full[0, t])


def test_write_cache_rolling_semantics():
    """8 one-token writes into a rolling cache of 4 slots, in place: the
    slots hold positions 4..7, each in slot position % 4, as the
    reference's copies do."""
    B, S, KV, hd, W = 1, 8, 1, 4, 4
    ck, cv = torch.zeros((B, W, KV, hd)), torch.zeros((B, W, KV, hd))
    sp = torch.full((B, W), -1, dtype=torch.int64)
    rk, rv = jnp.zeros((B, W, KV, hd)), jnp.zeros((B, W, KV, hd))
    rsp = jnp.full((B, W), -1, jnp.int32)
    for t in range(S):
        kt = np.full((B, 1, KV, hd), float(t), np.float32)
        out = A.write_cache(ck, cv, sp, torch.from_numpy(kt),
                            torch.from_numpy(kt), torch.full((B, 1), t),
                            rolling_window=W)
        assert all(a is b for a, b in zip(out, (ck, cv, sp)))
        rk, rv, rsp = RA.write_cache(rk, rv, rsp, jnp.asarray(kt),
                                     jnp.asarray(kt),
                                     jnp.full((B, 1), t, jnp.int32),
                                     rolling_window=W)
    assert sorted(sp[0].tolist()) == [4, 5, 6, 7]
    assert float(ck[0, sp[0].tolist().index(7), 0, 0]) == 7.0
    assert sp.tolist() == np.asarray(rsp).tolist()
    assert np.array_equal(ck.numpy(), np.asarray(rk))
    assert np.array_equal(cv.numpy(), np.asarray(rv))


def test_prefill_tail_then_rolling_write_matches_reference():
    """A prefill of 21 positions into a rolling cache of 8: the last 8
    rows kept (``prefill_tail``) and scattered to position % 8, as the
    reference's."""
    k, v, _ = _qkv(B=2, S=21, H=2, KV=2, hd=4, seed=3)
    B, S, W = 2, 21, 8
    pos = np.broadcast_to(np.arange(S), (B, S))
    tk, tv, tp = A.prefill_tail(torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(pos.copy()), W)
    rk, rv, rp = RA.prefill_tail(jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos, jnp.int32), W)
    assert tp.tolist() == np.asarray(rp).tolist()
    ck, cv = torch.zeros((B, W, 2, 4)), torch.zeros((B, W, 2, 4))
    sp = torch.full((B, W), -1, dtype=torch.int64)
    A.write_cache(ck, cv, sp, tk, tv, tp, rolling_window=W)
    rck, rcv, rsp = RA.write_cache(
        jnp.zeros((B, W, 2, 4)), jnp.zeros((B, W, 2, 4)),
        jnp.full((B, W), -1, jnp.int32), rk, rv, rp, rolling_window=W)
    assert sp.tolist() == np.asarray(rsp).tolist()
    assert sorted(sp[0].tolist()) == list(range(S - W, S))
    assert np.array_equal(ck.numpy(), np.asarray(rck))
    assert np.array_equal(cv.numpy(), np.asarray(rcv))


def test_rolling_window_cache_smaller_than_context():
    """SWA decode with a cache of window slots (mixtral semantics, window
    8, prompt 16, 32 positions): the port's prefill and decode logits
    within 1e-3 of the reference's full forward, its cache ``window``
    slots long."""
    kw = dict(dtype="float32", capacity_factor=8.0, window=8)
    rcfg = dataclasses.replace(RREGISTRY["mixtral-8x7b"].smoke(), **kw)
    cfg = dataclasses.replace(REGISTRY["mixtral-8x7b"].smoke(), **kw)
    rmodel = rbuild(rcfg)
    key = jax.random.PRNGKey(1)
    params = rmodel.init(key)
    B, S, P = 1, 32, 16
    toks = jax.random.randint(key, (B, S), 0, cfg.vocab_size)
    hidden, _, _ = rmodel.forward(params, {"tokens": toks})
    ref = np.asarray(rmodel.logits(params, hidden))
    model = build_model(cfg, device="cpu").load_jax_params(
        jax.tree_util.tree_map(np.asarray, params))
    toks = np.array(toks)
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": toks[:, :P]}, cache_len=S)
        assert cache["k"].shape[2] == cfg.window
        assert cache["k"].shape == model.init_cache(B, S)["k"].shape
        assert np.abs(logits.numpy() - ref[:, P - 1]).max() < 1e-4
        for t in range(P, S):
            logits, cache = model.decode_step(
                cache, {"tokens": toks[:, t:t + 1]}, np.full((B,), t))
            assert np.abs(logits.numpy() - ref[:, t]).max() < 1e-3, f"t={t}"
            assert cache["k"].shape[2] == cfg.window
            assert sorted(cache["slot_pos"][0, 0].tolist()) == \
                list(range(t + 1 - cfg.window, t + 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("Sq,M", [(1, 8), (16, 37), (1, 37), (16, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_matches_reference(dtype, G, Sq, M, masked):
    rng = np.random.default_rng(G * 100 + Sq * 10 + M)
    B, KV, hd = 2, 2, 16
    q = rng.standard_normal((B, Sq, KV * G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, M, KV, hd)).astype(np.float32)
            for _ in range(2))
    valid = None
    if masked:
        valid = rng.random((B, M)) < 0.7
        valid[:, 0] = True              # every row attends somewhere
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = RA.cross_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                              None if valid is None else jnp.asarray(valid))
    got = A.cross_attention(*(torch.from_numpy(x).to(tdt)
                              for x in (q, k, v)),
                            None if valid is None else
                            torch.from_numpy(valid))
    assert got.dtype == tdt and got.shape == (B, Sq, KV * G, hd)
    tol = TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    if masked:
        # a masked media position changes nothing
        k2 = k.copy()
        k2[~valid] = 100.0
        again = A.cross_attention(*(torch.from_numpy(x).to(tdt)
                                    for x in (q, k2, v)),
                                  torch.from_numpy(valid))
        assert torch.equal(again, got)
