"""Batches with their own positions, the port against the reference, on
the CPU.

The reference's ``Model.forward`` takes a batch's ``"positions"`` (B, S),
-1 an invalid slot, and its jnp ``flash_attention`` masks by them
(``kv_pos >= 0``, ``0 <= q_pos - kv_pos < window``).  The port's K7 and
its plain version (``kernels.ref.attention_ref``, what the wrappers take
for CPU tensors) mask by them too when given, and its backward
(``attention_backward``) masks by them as ``jax.grad`` of the
reference's ``jnp.where`` does.

- **Attention**: ``attention_ref`` and ``attention_backward`` with
  positions (left pads, offsets, a window, a softcap, rows with no valid
  key) against ``repro.models.attention.flash_attention`` and its
  ``jax.grad``, float32, 2e-5 (``test_torch_attention.py``'s).
- **Models**, four cases of positions (B=2, S=24): ``left`` (5 and 2
  leading pads), ``offset`` (3 + arange, 11 + arange), ``past_window``
  (18 and 9 leading pads, more than the smoke window of 16, so the
  rolling caches hold pads) and ``arange`` (where the port's forward also
  equals its forward without positions, exactly), each on smollm-360m,
  mixtral-8x7b (swa moe: the pads route tokens and take capacity),
  gemma2-9b (local_global, softcaps), zamba2-2.7b (hybrid), the vlm and
  musicgen, float32 at smoke size, the reference's parameters carried
  across with ``load_jax_params``: forward logits within 1e-4, prefill
  logits within 1e-4 and its cache (a cache of 40 slots, in the port's
  flat names) within 1e-5, then 4 teacher-forced decode steps from each
  row's next position within 1e-3 (``test_torch_models.py``'s).  A train
  step on the same cases is ``test_torch_positions_train.py``.  The
  reference's functions are jitted once an arch (the positions are
  inputs), so the four cases share its compiles.
- **The cache writes**: a pad clamps onto slot 0 (a rolling cache's
  slot W - 1), where a left-padded row's position 0 also writes; the
  port keeps the valid entry whatever the scatter's order.  The
  reference's scatter keeps the last write on the CPU, so a right-padded
  row loses its position 0 there (pinned: ROADMAP §3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREGISTRY
from repro.models import attention as RA
from repro.models import build_model as rbuild
from repro.runtime.steps import make_loss_fn as rmake_loss_fn
from repro_torch.configs import REGISTRY
from repro_torch.kernels.flash_attention import attention_backward
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import attention as A
from repro_torch.models.model import build_model

from fixtures_torch_media import inputs
from fixtures_torch_multidevice_ref import flat_cache
from test_torch_models import _open_gates
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
ARCHS = ["smollm-360m", "mixtral-8x7b", "gemma2-9b", "zamba2-2.7b", VLM,
         AUDIO]
CASES = ["left", "offset", "past_window", "arange"]
B, S, CACHE, STEPS = 2, 24, 40, 4
TOL = 2e-5


def padded(pads, S=S):
    """Positions of rows with ``pads`` leading -1s each (int32)."""
    return np.stack([np.r_[np.full(n, -1), np.arange(S - n)]
                     for n in pads]).astype(np.int32)


def positions(case):
    """(B, S) int32 positions of a case."""
    if case == "left":
        return padded((5, 2))
    if case == "offset":
        return (np.arange(S)[None] + np.array([[3], [11]])).astype(np.int32)
    if case == "past_window":
        return padded((18, 9))
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


# ------------------------------ attention ------------------------------- #

def _attn_inputs(B_=2, S_=40, H=4, KV=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B_, S_, n, hd)).astype(np.float32)
                 for n in (H, KV, KV))


ATTN_CASES = {
    "left": (padded((7, 0), 40), dict()),
    "offset": (padded((0, 0), 40) + np.array([[5], [40]], np.int32), {}),
    "window_softcap": (padded((9, 3), 40), dict(window=8,
                                                attn_softcap=20.0)),
    "all_pads": (padded((40, 12), 40), dict(window=8)),
    "non_causal": (padded((6, 0), 40), dict(causal=False)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_with_positions_matches_reference(case):
    """Forward and gradients (dq, dk, dv of a random cotangent) of the
    port's plain attention with positions against the reference's jnp
    flash attention and ``jax.grad`` (Skv = 40, within its one kv block:
    a row with no valid key averages V over all 40 keys in both)."""
    pos, kw = ATTN_CASES[case]
    q, k, v = _attn_inputs()
    do = np.random.default_rng(1).standard_normal(q.shape).astype(
        np.float32)

    @jax.jit
    def reference(q_, k_, v_, p, dout):
        out, vjp = jax.vjp(
            lambda a, b, c: RA.flash_attention(a, b, c, p, p, **kw),
            q_, k_, v_)
        return out, vjp(dout)
    want, rgrads = reference(q, k, v, pos, do)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tpos = torch.from_numpy(pos).long()
    got = attention_ref(tq, tk, tv, q_positions=tpos, kv_positions=tpos,
                        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert bool(got.isfinite().all())
    grads = attention_backward(tq, tk, tv, got, torch.from_numpy(do),
                               q_positions=tpos, kv_positions=tpos, **kw)
    for g, w, name in zip(grads, rgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")


def test_rows_without_a_valid_key_average_v():
    """A query at -1 (or a row whose keys are all -1) averages V over all
    Skv keys, as the reference's online softmax gives within its block."""
    q, k, v = (torch.from_numpy(t) for t in _attn_inputs(S_=12))
    pos = torch.from_numpy(padded((12, 4), 12)).long()
    out = attention_ref(q, k, v, q_positions=pos, kv_positions=pos)
    G = q.shape[2] // k.shape[2]
    mean = v.mean(dim=1).repeat_interleave(G, dim=1)       # (B, H, hd)
    torch.testing.assert_close(out[0], mean[0].expand(12, -1, -1))
    torch.testing.assert_close(out[1, :4], mean[1].expand(4, -1, -1))


def test_reference_fully_masked_rows_beyond_one_block():
    """The reference's quirk, pinned (ROADMAP §3): beyond one kv block
    (Skv = 520 > its block_kv of 512) its online softmax gives a row with
    no valid key p = 1 on every slot of both blocks, the padded block's
    zero rows too, so the row is V's sum over Skv divided by the padded
    length 1024; the port's row stays V's mean over Skv.  Rows with a
    valid key agree."""
    Skv = 520
    q, k, v = _attn_inputs(S_=Skv, H=2, KV=1, hd=8)
    pos = padded((Skv, 10), Skv)
    want = np.asarray(RA.flash_attention(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(pos),
        jnp.asarray(pos)))
    tpos = torch.from_numpy(pos).long()
    got = attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                        q_positions=tpos, kv_positions=tpos).numpy()
    mean = np.repeat(v.mean(axis=1), 2, axis=1)            # (B, H, hd)
    for b, rows in ((0, slice(None)), (1, slice(0, 10))):
        np.testing.assert_allclose(got[b, rows], np.broadcast_to(
            mean[b], got[b, rows].shape), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(want[b, rows], got[b, rows] * Skv / 1024,
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1, 10:], want[1, 10:], atol=TOL, rtol=TOL)


def test_arange_positions_equal_the_index_mask():
    """Positions ``arange(S)`` mask as the index path does: the plain
    attention and its backward give exactly the same numbers."""
    q, k, v = (torch.from_numpy(t) for t in _attn_inputs())
    pos = torch.arange(40).expand(2, 40).contiguous()
    for kw in (dict(), dict(window=8, attn_softcap=20.0)):
        a = attention_ref(q, k, v, **kw)
        b = attention_ref(q, k, v, q_positions=pos, kv_positions=pos, **kw)
        assert torch.equal(a, b)
        for ga, gb in zip(attention_backward(q, k, v, a, a, **kw),
                          attention_backward(q, k, v, b, b, q_positions=pos,
                                             kv_positions=pos, **kw)):
            assert torch.equal(ga, gb)


def test_positions_are_checked():
    q, k, v = (torch.from_numpy(t) for t in _attn_inputs(S_=8))
    pos = torch.arange(8).expand(2, 8).contiguous()
    from repro_torch.kernels.flash_attention import flash_attention
    for qp, kp in ((pos, None), (pos.int(), pos.int()), (pos[:, :4], pos),
                   (pos, pos[:1])):
        with pytest.raises(ValueError, match="positions"):
            flash_attention(q, k, v, q_positions=qp, kv_positions=kp)


# ------------------------------ cache writes ---------------------------- #

def _write_inputs(pos, size=8):
    Bw, T = pos.shape
    k = np.arange(1, 1 + Bw * T * 2, dtype=np.float32).reshape(Bw, T, 1, 2)
    cache = (np.zeros((Bw, size, 1, 2), np.float32),
             np.zeros((Bw, size, 1, 2), np.float32),
             np.full((Bw, size), -1, np.int32))
    return cache, k


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("pads", ["left", "right"])
def test_write_cache_keeps_valid_entries(pads, window):
    """Pads clamp onto a slot a valid entry also writes; the port keeps the
    valid entry (left and right padding alike, full and rolling caches):
    each valid position's K/V in its slot, every other slot untouched.
    The reference agrees under left padding (its last write is the valid
    one); under right padding, on a full cache, its CPU scatter writes the
    pads' stale slot 0 last (ROADMAP §3)."""
    pos = padded((3, 0), 6) if pads == "left" else padded((0, 0), 6)
    if pads == "right":
        pos[0, 3:] = -1
    (ck, cv, sp), k = _write_inputs(pos)
    got = A.write_cache(*(torch.from_numpy(t.copy()) for t in (ck, cv, sp)),
                        torch.from_numpy(k), torch.from_numpy(k),
                        torch.from_numpy(pos).long(), rolling_window=window)
    want_k, want_sp = ck.copy(), sp.copy()
    for b, t in zip(*np.nonzero(pos >= 0)):
        slot = pos[b, t] % window if window else pos[b, t]
        want_k[b, slot], want_sp[b, slot] = k[b, t], pos[b, t]
    np.testing.assert_array_equal(got[0].numpy(), want_k)
    np.testing.assert_array_equal(got[1].numpy(), want_k)
    np.testing.assert_array_equal(got[2].numpy(), want_sp)
    ref = RA.write_cache(*(jnp.asarray(t) for t in (ck, cv, sp)),
                         jnp.asarray(k), jnp.asarray(k), jnp.asarray(pos),
                         rolling_window=window)
    if pads == "left" or window:
        np.testing.assert_array_equal(np.asarray(ref[2]), want_sp)
        np.testing.assert_array_equal(np.asarray(ref[0]), want_k)


def test_reference_right_padding_loses_slot_zero():
    """The reference's fault, pinned: under right padding its scatter's
    last write to slot 0 is a pad's (the slot's old contents), so position
    0 of the padded row is lost from the cache (slot_pos -1, K zeros);
    the port keeps it."""
    pos = padded((0, 0), 6)
    pos[0, 4:] = -1
    (ck, cv, sp), k = _write_inputs(pos)
    ref = RA.write_cache(*(jnp.asarray(t) for t in (ck, cv, sp)),
                         jnp.asarray(k), jnp.asarray(k), jnp.asarray(pos))
    got = A.write_cache(*(torch.from_numpy(t.copy()) for t in (ck, cv, sp)),
                        torch.from_numpy(k), torch.from_numpy(k),
                        torch.from_numpy(pos).long())
    assert int(np.asarray(ref[2])[0, 0]) == -1
    assert not np.asarray(ref[0])[0, 0].any()
    assert int(got[2][0, 0]) == 0
    assert torch.equal(got[0][0, 0], torch.from_numpy(k[0, 0]))
    # the unpadded row agrees
    np.testing.assert_array_equal(got[2][1].numpy(), np.asarray(ref[2])[1])


# -------------------------------- models -------------------------------- #

@functools.lru_cache(maxsize=None)
def _pair(arch, **over):
    """(reference model, its params, the port's model, cfg, the
    reference's jitted prefill (with every position's logits), decode step
    and loss with gradients)."""
    rcfg = dataclasses.replace(RREGISTRY[arch].smoke(), dtype="float32",
                               **over)
    cfg = dataclasses.replace(REGISTRY[arch].smoke(), dtype="float32",
                              **over)
    rmodel = rbuild(rcfg)
    params = _open_gates(jax.jit(rmodel.init)(jax.random.PRNGKey(0)), cfg)
    model = build_model(cfg, device="cpu").load_jax_params(
        jax.tree_util.tree_map(np.asarray, params))
    def prefill(p, b):
        # every position's logits and the cache of one forward: the
        # prefill's logits are the last position's
        h, _, cache = rmodel.forward(p, b, build_cache=True, cache_len=CACHE)
        return rmodel.logits(p, h), cache

    fns = dict(
        prefill=jax.jit(prefill), decode=jax.jit(rmodel.decode_step),
        grad=jax.jit(jax.value_and_grad(rmake_loss_fn(rmodel),
                                        has_aux=True)))
    return rmodel, params, model, cfg, fns


def _batch(cfg, case, seed=7):
    return dict(inputs(cfg, seed=seed, B=B, S=S), positions=positions(case))


def _jx(batch):
    return {k: jnp.asarray(v, jnp.float32 if k in ("embeddings", "media")
                           else jnp.int32) for k, v in batch.items()}


def _steps(cfg, seed=8):
    """The STEPS decode inputs: a token, or an audio frame, a step."""
    out = inputs(cfg, seed=seed, B=B, S=STEPS)
    key = "tokens" if cfg.embed_inputs else "embeddings"
    return [{key: out[key][:, t:t + 1]} for t in range(STEPS)]


def serve_against_reference(arch, batch, **over):
    """The port's forward, prefill (cache of CACHE slots) and STEPS decode
    steps of ``batch`` against the reference's; the decode steps from
    each row's next position."""
    rmodel, params, model, cfg, fns = _pair(arch, **over)
    jb = _jx(batch)
    with torch.no_grad():
        rlogits, rcache = fns["prefill"](params, jb)
        h, _, _ = model.forward(batch)
        np.testing.assert_allclose(model.logits(h).numpy(),
                                   np.asarray(rlogits), atol=1e-4, rtol=1e-4)
        tl, cache = model.prefill(batch, cache_len=CACHE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rlogits)[:, -1],
                                   atol=1e-4, rtol=1e-4)
        want = flat_cache(rcache, cfg)
        assert sorted(want) == sorted(cache)
        for name, leaf in cache.items():
            np.testing.assert_allclose(leaf.float().numpy(), want[name],
                                       atol=1e-5, rtol=1e-5, err_msg=name)
        q_pos = batch["positions"][:, -1] + 1
        assert np.array_equal(cache["pos"].numpy(), q_pos)
        for t, step in enumerate(_steps(cfg)):
            rl, rcache = fns["decode"](params, rcache, _jx(step),
                                       jnp.asarray(q_pos + t))
            tl, cache = model.decode_step(cache, step, q_pos + t)
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                       atol=1e-3, rtol=1e-3,
                                       err_msg=f"step {t}")
    return model


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_with_positions_matches_reference(arch, case):
    _, _, model, cfg, _ = _pair(arch)
    batch = _batch(cfg, case)
    serve_against_reference(arch, batch)
    if case == "arange":
        plain = {k: v for k, v in batch.items() if k != "positions"}
        with torch.no_grad():
            assert torch.equal(model.forward(batch)[0],
                               model.forward(plain)[0])
