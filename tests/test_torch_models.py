"""The port's model stack against the reference's ``Model`` at smoke size.

For ``smollm-360m`` (dense, GQA, prefill attention through K7),
``qwen3-moe-30b-a3b`` (moe, QK-norm, 4 experts top-2 at smoke size),
``falcon-mamba-7b`` (ssm, Mamba1, prefill scan through K8) and
``zamba2-2.7b`` (hybrid: 12 Mamba2 blocks in groups of 2, each group
followed by the one shared attention block, K7 at smoke size),
``mixtral-8x7b`` (moe with sliding-window attention: every layer
windowed, rolling caches) and ``gemma2-9b`` (dense, local_global: (local,
global) layer pairs, attention and final softcaps, geglu, post-norms;
also at 4 layers, two pairs, so a pair unstacked in the wrong order
shows) configs,
the reference's parameters are carried across with ``load_jax_params`` and
the same numpy-drawn tokens go through both.  In float32: full-forward
logits and prefill logits within 1e-4, and 8 teacher-forced decode steps
within 1e-3 (the tolerances of ``tests/test_decode_consistency.py``; the
port's attention and scan sum in other orders than the reference's jnp
twins).  The moe model's aux losses and drop fraction (each the mean
over its layers) agree within 1e-6 relative (the reference's compiled
layer scan rounds the drop fraction's mean its own way).  In bfloat16
(the configs' own dtype) the two packages round at other places (silu,
softplus, the residual adds), so logits of magnitude up to ~1.5 agree to
2e-2, the tolerance of the bfloat16 kernel tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREGISTRY
from repro.models import build_model as rbuild
from repro.models.transformer import model_defs as rmodel_defs
from repro.sharding import ParamDef as RParamDef
from repro_torch.configs import REGISTRY, get_config
from repro_torch.models.model import (_flatten, build_model, check_supported,
                                      load_jax_params)
from repro_torch.models.transformer import model_defs

ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
         "zamba2-2.7b", "mixtral-8x7b", "gemma2-9b"]
# (arch, n_layers or None for the smoke depth): gemma2 also at two pairs
CASES = [(a, None) for a in ARCHS] + [("gemma2-9b", 4)]
CASE_IDS = [a if n is None else f"{a}-{n}L" for a, n in CASES]
B, S, P = 2, 24, 16


def _smoke(registry, arch, n_layers=None, **kw):
    cfg = registry[arch].smoke()
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, **kw)


def _pair(arch, dtype="float32", n_layers=None):
    rcfg = _smoke(RREGISTRY, arch, n_layers, dtype=dtype)
    cfg = _smoke(REGISTRY, arch, n_layers, dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    rmodel = rbuild(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu").load_jax_params(
        jax.tree_util.tree_map(np.asarray, params))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    return rmodel, params, model, toks


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("arch,n_layers", CASES, ids=CASE_IDS)
def test_forward_prefill_decode_match_reference(arch, n_layers):
    rmodel, params, model, toks = _pair(arch, n_layers=n_layers)
    jt = jnp.asarray(toks, jnp.int32)
    with torch.no_grad():
        rh, raux, _ = rmodel.forward(params, {"tokens": jt})
        rlog = np.asarray(rmodel.logits(params, rh))
        h, aux, _ = model.forward({"tokens": toks})
        np.testing.assert_allclose(_np(model.logits(h)), rlog, atol=1e-4,
                                   rtol=1e-4)
        assert sorted(aux) == sorted(raux)
        for k in raux:
            assert float(aux[k]) == pytest.approx(float(raux[k]),
                                                  rel=1e-6), k
        assert bool(aux) == model.cfg.is_moe

        rl, rcache = rmodel.prefill(params, {"tokens": jt[:, :P]},
                                    cache_len=S)
        tl, cache = model.prefill({"tokens": toks[:, :P]}, cache_len=S)
        np.testing.assert_allclose(_np(tl), np.asarray(rl), atol=1e-4,
                                   rtol=1e-4)
        for t in range(P, P + 8):
            q_pos = np.full((B,), t, np.int32)
            rl, rcache = rmodel.decode_step(
                params, rcache, {"tokens": jt[:, t:t + 1]},
                jnp.asarray(q_pos))
            tl, cache = model.decode_step(cache, {"tokens": toks[:, t:t + 1]},
                                          q_pos)
            np.testing.assert_allclose(_np(tl), np.asarray(rl), atol=1e-3,
                                       rtol=1e-3, err_msg=f"t={t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_own_forward(arch):
    """The serving invariant on the port alone: prefill + step-by-step
    decode reproduce its full forward's logits (float32; for the moe
    model with ample capacity, as tests/test_decode_consistency.py runs
    it: a shorter prefill drops other slots than the full forward)."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32",
                              capacity_factor=8.0)
    model = build_model(cfg, device="cpu", seed=3)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    with torch.no_grad():
        h, _, _ = model.forward({"tokens": toks})
        ref = model.logits(h)
        logits, cache = model.prefill({"tokens": toks[:, :P]}, cache_len=S)
        assert float((logits - ref[:, P - 1]).abs().max()) < 1e-4
        for t in range(P, S):
            logits, cache = model.decode_step(
                cache, {"tokens": toks[:, t:t + 1]}, np.full((B,), t))
            assert float((logits - ref[:, t]).abs().max()) < 1e-3, f"t={t}"


# zamba2's whole bfloat16 forward is held block by block instead
# (test_bf16_hybrid_blocks_match_reference): at smoke size it is 12 Mamba2
# and 6 attention blocks deep, and the packages' one-ulp rounding
# differences a block (measured: silu, the mixer's output) add up past
# 2e-2 by the logits.  So is mixtral's (test_bf16_moe_blocks_match_
# reference): its router's product rounds to bfloat16 in both packages,
# and on these tokens two of layer 0's (token 34: logits 0.1426 and
# 0.1416 for experts 0 and 1, one bfloat16 ulp apart; token 3) are the
# batch's nearest ties between the 2nd and 3rd expert (probability gaps
# 2.5e-4 and 3.7e-4), which a one-ulp difference upstream flips: those
# tokens' logits differ by up to 0.22, and the later tokens that attend
# to them by ~0.06
BF16_WHOLE = [a for a in ARCHS if a not in ("zamba2-2.7b", "mixtral-8x7b")]


@pytest.mark.parametrize("arch", BF16_WHOLE)
def test_bf16_forward_matches_reference(arch):
    rmodel, params, model, toks = _pair(arch, dtype="bfloat16")
    with torch.no_grad():
        rh, _, _ = rmodel.forward(params, {"tokens": jnp.asarray(toks)})
        h, _, _ = model.forward({"tokens": toks})
        assert h.dtype == torch.bfloat16
        got, want = _np(model.logits(h)), np.asarray(rmodel.logits(params, rh))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_bf16_hybrid_blocks_match_reference():
    """zamba2's blocks in bfloat16: a Mamba2 block, then the shared
    attention block, each on the same bfloat16 input as the reference's,
    to the bfloat16 tolerance above."""
    from repro.models import transformer as rtf
    from repro.sharding import single_device_plan as rplan
    from repro_torch.models import transformer as tf
    rmodel, params, model, _ = _pair("zamba2-2.7b", dtype="bfloat16")
    cfg = model.cfg
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    p0 = jax.tree_util.tree_map(lambda a: a[0, 0], params["layers"])
    with torch.no_grad():
        want = rtf.mamba_block(p0, xj, rmodel.cfg, rplan())[0]
        got = tf.mamba_block(model.layers[0], xt, cfg)[0]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)
        want = rtf.dense_block(params["shared_attn"], xj, rmodel.cfg,
                               rplan(), pos)[0]
        got = tf.dense_block(model.shared_attn, xt, cfg, model.plan,
                             torch.arange(S).expand(B, S))[0]
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)


def test_bf16_moe_blocks_match_reference():
    """mixtral's layer 0 in bfloat16, each half on the same bfloat16 input
    as the reference's: the windowed attention sub-block (S = 24 over a
    window of 16, so the window masks) and the MoE FFN, to the bfloat16
    tolerance above."""
    from repro.models import moe as rmoe
    from repro.models import transformer as rtf
    from repro.models.common import rms_norm
    from repro.sharding import single_device_plan as rplan
    from repro_torch.models import transformer as tf
    rmodel, params, model, _ = _pair("mixtral-8x7b", dtype="bfloat16")
    cfg = model.cfg
    assert cfg.attention == "swa" and cfg.window < S
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    p0 = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    with torch.no_grad():
        want = rtf.self_attention_block(p0, xj, rmodel.cfg, rplan(), pos,
                                        window=cfg.window)[0]
        got = tf.self_attention_block(model.layers[0], xt, cfg,
                                      torch.arange(S).expand(B, S),
                                      window=cfg.window)[0]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)
        want = rmoe.moe_ffn(p0["moe"], rms_norm(xj, p0["ln2"], cfg.norm_eps),
                            rmodel.cfg, rplan())[0]
        got = tf.ffn_block(model.layers[0], xt, cfg, model.plan)[0]
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)


def test_moe_prefill_decode_matches_reference_forward():
    """tests/test_decode_consistency.py's qwen3-moe-30b-a3b case across
    the packages: the port's prefill and decode steps reproduce the
    reference's full-forward logits (float32, capacity factor 8, so no
    slot drops)."""
    arch = "qwen3-moe-30b-a3b"
    rcfg = dataclasses.replace(RREGISTRY[arch].smoke(), dtype="float32",
                               capacity_factor=8.0)
    cfg = dataclasses.replace(REGISTRY[arch].smoke(), dtype="float32",
                              capacity_factor=8.0)
    rmodel = rbuild(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu").load_jax_params(
        jax.tree_util.tree_map(np.asarray, params))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (B, S), 0,
                                         cfg.vocab_size))
    rh, _, _ = rmodel.forward(params, {"tokens": jnp.asarray(toks)})
    ref = np.asarray(rmodel.logits(params, rh))
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": toks[:, :P]}, cache_len=S)
        assert np.abs(_np(logits) - ref[:, P - 1]).max() < 1e-4
        for t in range(P, S):
            logits, cache = model.decode_step(
                cache, {"tokens": toks[:, t:t + 1]}, np.full((B,), t))
            assert np.abs(_np(logits) - ref[:, t]).max() < 1e-3, f"t={t}"


def test_load_jax_params_names_and_shapes():
    for arch, n_layers in CASES:
        cfg = _smoke(REGISTRY, arch, n_layers)
        # the port's parameter definitions are the reference's
        rdefs = jax.tree_util.tree_flatten_with_path(
            rmodel_defs(cfg), is_leaf=lambda x: isinstance(x, RParamDef))[0]
        want = {".".join(k.key for k in path): (d.shape, d.logical, d.init)
                for path, d in rdefs}
        got = {name: (d.shape, d.logical, d.init)
               for name, d in _flatten(model_defs(cfg))}
        assert got == want
        params = rbuild(cfg).init(jax.random.PRNGKey(1))
        state = load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                cfg)
        model = build_model(cfg, device="cpu")
        own = model.state_dict()
        assert sorted(state) == sorted(own)
        assert all(state[k].shape == own[k].shape for k in own)
        leaves = {"ssm": ["in_proj"], "dense": ["attn.wq"],
                  "moe": ["attn.wq", "moe.router", "moe.w1", "moe.w2",
                          "moe.w3"],
                  "hybrid": ["in_proj_xz", "in_proj_dt", "norm"]}[cfg.family]
        if cfg.attention == "local_global":
            leaves += ["ln1p", "mlp.w3"]
        # a hybrid's (g, k, ...) leaves: group g's j-th block is layer
        # g * k + j; local_global's (L / 2, 2, ...): pair g's local block
        # is layer 2g, its global block 2g + 1
        k = cfg.hybrid_period if cfg.family == "hybrid" else \
            2 if cfg.attention == "local_global" else 1
        for name in leaves:
            stacked = params["layers"]
            for key in name.split("."):
                stacked = stacked[key]
            stacked = np.asarray(stacked)
            assert stacked.shape[:2 if k > 1 else 1] == \
                ((cfg.n_layers // k, k) if k > 1 else (cfg.n_layers,))
            for i in range(cfg.n_layers):
                want = stacked[divmod(i, k)] if k > 1 else stacked[i]
                assert np.array_equal(state[f"layers.{i}.{name}"].numpy(),
                                      want)
        shared = [n for n in state if n.startswith("shared_attn.")]
        assert bool(shared) == (cfg.family == "hybrid")
        for name in shared:
            leaf = params
            for key in name.split("."):
                leaf = leaf[key]
            assert np.array_equal(state[name].numpy(), np.asarray(leaf))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError):
        check_supported(get_config(arch))
    with pytest.raises(NotImplementedError):
        build_model(get_config(arch).smoke(), device="cpu")


def test_hybrid_unported_combinations_raise():
    """The port's hybrid runs Mamba2 blocks: zamba2-2.7b builds, a hybrid
    of Mamba1 blocks raises."""
    zamba = get_config("zamba2-2.7b")
    check_supported(zamba)
    with pytest.raises(NotImplementedError, match="ssm_version=1"):
        check_supported(dataclasses.replace(zamba, ssm_version=1))
    with pytest.raises(NotImplementedError, match="ssm_version=1"):
        build_model(dataclasses.replace(zamba.smoke(), ssm_version=1),
                    device="cpu")


def test_ssm_version_2_matches_reference():
    """The ssm family at ssm_version=2 (falcon-mamba-7b's smoke config
    with Mamba2 blocks), which the reference runs through the same
    mamba_block dispatch: forward logits within 1e-4, and its cache's
    Mamba2 state (L, B, H, P, N) decodes as the reference's does."""
    arch = "falcon-mamba-7b"
    rcfg = dataclasses.replace(RREGISTRY[arch].smoke(), dtype="float32",
                               ssm_version=2)
    cfg = dataclasses.replace(REGISTRY[arch].smoke(), dtype="float32",
                              ssm_version=2)
    rmodel = rbuild(rcfg)
    params = rmodel.init(jax.random.PRNGKey(2))
    model = build_model(cfg, device="cpu").load_jax_params(
        jax.tree_util.tree_map(np.asarray, params))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))
    jt = jnp.asarray(toks, jnp.int32)
    rh, _, _ = rmodel.forward(params, {"tokens": jt})
    with torch.no_grad():
        h, _, _ = model.forward({"tokens": toks})
        np.testing.assert_allclose(
            _np(model.logits(h)), np.asarray(rmodel.logits(params, rh)),
            atol=1e-4, rtol=1e-4)
        rl, rcache = rmodel.prefill(params, {"tokens": jt[:, :P]},
                                    cache_len=S)
        tl, cache = model.prefill({"tokens": toks[:, :P]}, cache_len=S)
        assert cache["ssm"].shape == model.init_cache(B, S)["ssm"].shape == \
            (cfg.n_layers, B, cfg.n_ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state)
        for t in range(P, P + 4):
            q_pos = np.full((B,), t, np.int32)
            rl, rcache = rmodel.decode_step(
                params, rcache, {"tokens": jt[:, t:t + 1]},
                jnp.asarray(q_pos))
            tl, cache = model.decode_step(cache, {"tokens": toks[:, t:t + 1]},
                                          q_pos)
            np.testing.assert_allclose(_np(tl), np.asarray(rl), atol=1e-3,
                                       rtol=1e-3, err_msg=f"t={t}")


def test_moe_with_unported_attention_raises():
    """The moe family runs every attention schedule (full, swa,
    local_global): mixtral-8x7b and qwen3-moe-30b-a3b under each pass
    ``check_supported`` and build.  What still raises is not the schedule:
    a moe model given the vlm or audio family, or embedding inputs."""
    for arch in ("mixtral-8x7b", "qwen3-moe-30b-a3b"):
        moe = get_config(arch)
        check_supported(moe)
        for attention in ("full", "swa", "local_global"):
            build_model(dataclasses.replace(moe.smoke(), attention=attention),
                        device="cpu")
        for family in ("vlm", "audio"):
            with pytest.raises(NotImplementedError, match=family):
                check_supported(dataclasses.replace(moe, family=family))
        with pytest.raises(NotImplementedError, match="embedding inputs"):
            build_model(dataclasses.replace(moe.smoke(), embed_inputs=False),
                        device="cpu")


@pytest.mark.parametrize("arch,attention", [
    ("smollm-360m", "swa"), ("qwen3-moe-30b-a3b", "local_global"),
    ("qwen3-moe-30b-a3b", "swa")])
def test_schedules_on_other_archs_match_reference(arch, attention):
    """The swa and local_global schedules on models that publish another
    (a dense model with sliding windows; a moe model in local/global pairs,
    whose aux losses the reference's local_global branch does not collect,
    so neither package reports them): forward logits within 1e-4 and the
    aux as the reference's, prefill then 8 decode steps within 1e-3."""
    kw = dict(dtype="float32", attention=attention)
    rcfg = dataclasses.replace(RREGISTRY[arch].smoke(), **kw)
    cfg = dataclasses.replace(REGISTRY[arch].smoke(), **kw)
    rmodel = rbuild(rcfg)
    params = rmodel.init(jax.random.PRNGKey(5))
    model = build_model(cfg, device="cpu").load_jax_params(
        jax.tree_util.tree_map(np.asarray, params))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    jt = jnp.asarray(toks, jnp.int32)
    with torch.no_grad():
        rh, raux, _ = rmodel.forward(params, {"tokens": jt})
        h, aux, _ = model.forward({"tokens": toks})
        np.testing.assert_allclose(_np(model.logits(h)),
                                   np.asarray(rmodel.logits(params, rh)),
                                   atol=1e-4, rtol=1e-4)
        assert sorted(aux) == sorted(raux)
        assert bool(aux) == (cfg.is_moe and attention == "swa")
        for k in raux:
            assert float(aux[k]) == pytest.approx(float(raux[k]), rel=1e-6)
        rl, rcache = rmodel.prefill(params, {"tokens": jt[:, :P]},
                                    cache_len=S)
        tl, cache = model.prefill({"tokens": toks[:, :P]}, cache_len=S)
        np.testing.assert_allclose(_np(tl), np.asarray(rl), atol=1e-4,
                                   rtol=1e-4)
        for t in range(P, P + 8):
            q_pos = np.full((B,), t, np.int32)
            rl, rcache = rmodel.decode_step(
                params, rcache, {"tokens": jt[:, t:t + 1]},
                jnp.asarray(q_pos))
            tl, cache = model.decode_step(cache, {"tokens": toks[:, t:t + 1]},
                                          q_pos)
            np.testing.assert_allclose(_np(tl), np.asarray(rl), atol=1e-3,
                                       rtol=1e-3, err_msg=f"t={t}")


def test_forward_refuses_positions():
    cfg = get_config("smollm-360m").smoke()
    model = build_model(cfg, device="cpu")
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(NotImplementedError, match="positions"):
        model.forward({"tokens": toks, "positions": toks})
