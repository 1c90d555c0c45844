"""The port's serving loop against the reference's, at smoke size.

``repro.launch.serve.main`` runs with its ``get_config`` patched to a
float32 copy of the config (nothing in ``repro`` changes); its printed
first 8 tokens per request are parsed.  The port's ``serve`` gets the
same parameters through ``load_jax_params``, on the CPU, and must produce
the same tokens for every request.  At smoke size greedy decode mostly
repeats one token per request, so these tests check the plumbing of
slots, admission waves and cache merges; ``test_torch_models.py`` holds
the numerics.

The serving loop feeds tokens only, in both packages: the vlm
(llama-3.2-vision-11b, media beside its tokens) and the audio family
(musicgen-medium, frame embeddings) cannot be served by it (the
reference's fails with a ``KeyError``, the port's raises
``NotImplementedError``).  Their serving path is the Model API driven
directly: one prefill of 4 prompts, then 4 decode steps (the vlm fed
each step's greedy token, musicgen seeded random frames), the port's
logits against the reference's ``prefill`` and ``decode_step`` within
1e-4 and 1e-3 (float32; the vlm's cross gates opened).
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as rserve
from repro.configs import get_config as rget_config
from repro.models import build_model as rbuild
from repro_torch.configs import get_config
from repro_torch.launch.serve import merge_cache, serve
from repro_torch.models.model import (CACHE_BATCH_AXIS, build_model,
                                      load_jax_params)
from repro_torch.runtime.steps import make_decode_step, make_prefill_step
from test_torch_models import _open_gates, inputs, jx, open_gates, prefix
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
         "zamba2-2.7b", "mixtral-8x7b", "gemma2-9b"]
DONE = re.compile(r"\[serve\] rid=(\d+) done: \[([0-9, ]*)\]")


def _f32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference_run(arch, slots):
    """{rid: first 8 tokens} printed by the reference's serve.main."""
    import contextlib
    import io
    buf = io.StringIO()
    orig = rserve.get_config
    rserve.get_config = _f32(rget_config)
    try:
        with contextlib.redirect_stdout(buf):
            rserve.main(["--arch", arch, "--smoke", "--requests", "8",
                         "--slots", str(slots)])
    finally:
        rserve.get_config = orig
    out = {int(m.group(1)): [int(t) for t in m.group(2).split(",")]
           for m in DONE.finditer(buf.getvalue())}
    assert sorted(out) == list(range(8)), buf.getvalue()
    return out


def _port_run(arch, slots):
    cfg = _f32(get_config)(arch).smoke()
    params = rbuild(_f32(rget_config)(arch).smoke()).init(
        jax.random.PRNGKey(0))
    return serve(cfg, load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             params), cfg),
                 requests=8, slots=slots, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    want = _reference_run(arch, 4)
    got = _port_run(arch, 4)
    assert got["served"] == 8 and got["steps"] > 0
    assert {rid: toks[:8] for rid, toks in got["tokens"].items()} == want
    assert all(len(t) == 32 for t in got["tokens"].values())
    assert got["prefill_waves"] >= 2 and got["first_logits"].shape[0] == 4


@pytest.mark.parametrize("arch", ["smollm-360m", "falcon-mamba-7b",
                                  "gemma2-9b"])
def test_serve_with_slots_equal_to_layers(arch):
    """slots == n_layers (2 at smoke size): the reference's merge would
    scatter along the layer axis; the port merges along the batch axis,
    so every request decodes as it does with 4 slots (gemma2: its flat
    local and global leaves, (1, B, ...) over its one pair, and a prompt
    of 16 rolling through a window of 16 while it decodes 32 tokens).
    (Not the moe models: their experts' capacity depends on the batch, so
    a request's tokens with 2 slots are not its tokens with 4, in either
    package.)"""
    assert get_config(arch).smoke().n_layers == 2
    got = _port_run(arch, 2)
    want = _reference_run(arch, 4)
    assert {rid: toks[:8] for rid, toks in got["tokens"].items()} == want


def test_hybrid_merge_cache_uses_batch_axis():
    """zamba2 with 2 slots: its smoke model groups its 12 Mamba2 blocks in
    k = 2, so a merge along the reference's group-inner axis (the first
    of size == slots in its (g, k, B, ...) layout) would corrupt the
    cache; the port's flat (L, B, ...) and (g, B, ...) leaves merge along
    axis 1, and every request decodes as it does with 4 slots (whose
    tokens equal the reference's)."""
    arch = "zamba2-2.7b"
    cfg = get_config(arch).smoke()
    assert cfg.hybrid_period == 2
    got, four = _port_run(arch, 2), _port_run(arch, 4)
    assert got["prefill_waves"] == 4 and four["prefill_waves"] == 2
    assert got["tokens"] == four["tokens"]
    want = _reference_run(arch, 4)
    assert {rid: toks[:8] for rid, toks in got["tokens"].items()} == want


def test_merge_cache_scatters_along_batch_axis():
    L = B = 2
    live = {"k": torch.zeros((L, B, 3, 1, 2)),
            "slot_pos": torch.full((L, B, 3), -1),
            "ssm": torch.zeros((L, B, 4, 2)), "pos": torch.zeros(B)}
    wave = {"k": torch.arange(L * 2 * 3 * 2.).reshape(L, 2, 3, 1, 2),
            "slot_pos": torch.arange(3).expand(L, 2, 3).clone(),
            "ssm": torch.arange(L * 2 * 8.).reshape(L, 2, 4, 2),
            "pos": torch.tensor([3., 3.])}
    merge_cache(live, wave, [1, 0])
    for name in ("k", "slot_pos", "ssm"):
        assert torch.equal(live[name][:, 1], wave[name][:, 0])
        assert torch.equal(live[name][:, 0], wave[name][:, 1])
    assert torch.equal(live["pos"], torch.tensor([3., 3.]))
    # a hybrid's cache: Mamba2 leaves over its 12 blocks, (L, B, K-1, di)
    # and (L, B, H, P, N), and the shared block's over its 6 groups; a
    # one-request wave lands in slot 2 of 3 and nowhere else
    model = build_model(dataclasses.replace(
        get_config("zamba2-2.7b").smoke(), dtype="float32"), device="cpu")
    live = model.init_cache(3, 8)
    assert live["ssm"].ndim == 5 and live["k"].shape[0] == 6
    with torch.no_grad():
        _, wave = model.prefill({"tokens": np.array([[5, 6, 7]])},
                                cache_len=8)
    assert sorted(wave) == sorted(live)
    merge_cache(live, wave, [2])
    for name, new in wave.items():
        if name == "pos":
            assert live["pos"].tolist() == [0, 0, 3]
            continue
        assert live[name].shape[1] == 3 and new.shape[1] == 1, name
        assert torch.equal(live[name][:, 2], new[:, 0]), name
        fresh = model.init_cache(3, 8)[name]
        assert torch.equal(live[name][:, :2], fresh[:, :2]), name


def test_local_global_merge_cache_uses_batch_axis():
    """gemma2's flat cache: its local layers' rolling leaves (L / 2, B,
    min(cache_len, W), ...) and its global layers' (L / 2, B, cache_len,
    ...), every one merged along axis 1; a one-request wave lands in slot
    2 of 3 and nowhere else."""
    cfg = dataclasses.replace(get_config("gemma2-9b").smoke(),
                              dtype="float32", n_layers=4)
    model = build_model(cfg, device="cpu")
    cache_len = 3 * cfg.window
    live = model.init_cache(3, cache_len)
    assert sorted(live) == ["k", "k_local", "pos", "slot_pos",
                            "slot_pos_local", "v", "v_local"]
    assert live["k_local"].shape[:3] == (2, 3, cfg.window)
    assert live["k"].shape[:3] == (2, 3, cache_len)
    prompt = np.arange(cfg.window + 5)[None] % cfg.vocab_size
    with torch.no_grad():
        _, wave = model.prefill({"tokens": prompt}, cache_len=cache_len)
    assert sorted(wave) == sorted(live)
    # the rolling cache holds the prompt's last W positions, each in slot
    # position % W
    want = torch.arange(5, cfg.window + 5)
    assert sorted(wave["slot_pos_local"][0, 0].tolist()) == want.tolist()
    assert (wave["slot_pos_local"][0, 0] % cfg.window ==
            torch.arange(cfg.window)).all()
    merge_cache(live, wave, [2])
    for name, new in wave.items():
        if name == "pos":
            assert live["pos"].tolist() == [0, 0, cfg.window + 5]
            continue
        assert live[name].shape[1] == 3 and new.shape[1] == 1, name
        assert torch.equal(live[name][:, 2], new[:, 0]), name
        fresh = model.init_cache(3, cache_len)[name]
        assert torch.equal(live[name][:, :2], fresh[:, :2]), name


def test_vlm_merge_cache_uses_batch_axis():
    """The vlm's flat cache at 10 layers with a period of 5 (8 self
    blocks, 2 cross blocks): ``init_cache``'s leaves are prefill's in
    name, shape past the batch axis and dtype (self ``k``/``v``/
    ``slot_pos`` (8, B, ...), ``media_k``/``media_v`` (2, B, M, KV,
    hd)); a one-request wave merged along axis 1 lands in slot 2 of 3 and
    nowhere else, and a decode step from the merged cache gives that
    request the logits it gets from the wave's own cache."""
    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b").smoke(),
                              dtype="float32", n_layers=10,
                              cross_attn_period=5)
    model = open_gates(build_model(cfg, device="cpu", seed=4))
    live = model.init_cache(3, 8)
    assert sorted(live) == ["k", "media_k", "media_v", "pos", "slot_pos",
                            "v"]
    assert live["k"].shape[:2] == (8, 3)
    assert live["media_k"].shape == (2, 3, cfg.n_media_tokens,
                                     cfg.n_kv_heads, cfg.head_dim)
    wave_in = inputs(cfg, seed=3, B=1, S=3)
    with torch.no_grad():
        _, wave = model.prefill(wave_in, cache_len=8)
    assert sorted(wave) == sorted(live)
    for name, new in wave.items():
        assert new.dtype == live[name].dtype, name
        axis = CACHE_BATCH_AXIS[name]
        assert new.shape[:axis] + new.shape[axis + 1:] == \
            live[name].shape[:axis] + live[name].shape[axis + 1:], name
    merge_cache(live, wave, [2])
    for name, new in wave.items():
        if name == "pos":
            assert live["pos"].tolist() == [0, 0, 3]
            continue
        assert live[name].shape[1] == 3 and new.shape[1] == 1, name
        assert torch.equal(live[name][:, 2], new[:, 0]), name
        fresh = model.init_cache(3, 8)[name]
        assert torch.equal(live[name][:, :2], fresh[:, :2]), name
    token = np.array([[11]])
    with torch.no_grad():
        want, _ = model.decode_step(wave, {"tokens": token},
                                    torch.tensor([3]))
        got, _ = model.decode_step(live, {"tokens": np.full((3, 1), 11)},
                                   torch.tensor([0, 0, 3]))
    torch.testing.assert_close(got[2], want[0], atol=1e-5, rtol=1e-5)


MEDIA_ARCHS = ["llama-3.2-vision-11b", "musicgen-medium"]


@pytest.mark.parametrize("arch", MEDIA_ARCHS)
def test_serve_refuses_media_and_embedding_families(arch):
    """Both serving loops feed token prompts only: the reference's fails
    on these families with a KeyError (its batches lack "media" or
    "embeddings"), the port's raises NotImplementedError saying why."""
    cfg = _f32(get_config)(arch).smoke()
    with pytest.raises(NotImplementedError, match="tokens only"):
        serve(cfg, requests=2, slots=2, device="cpu")
    orig = rserve.get_config
    rserve.get_config = _f32(rget_config)
    try:
        with pytest.raises(KeyError):
            rserve.main(["--arch", arch, "--smoke", "--requests", "2",
                         "--slots", "2", "--max-new", "2"])
    finally:
        rserve.get_config = orig


@pytest.mark.parametrize("arch", MEDIA_ARCHS)
def test_model_api_serving_matches_reference(arch):
    """A serving wave through the Model API: prefill of 4 prompts of 16
    (a cache of 24 slots), then 4 decode steps; the vlm decodes each
    step's greedy token (the same in both packages), musicgen seeded
    random frames."""
    rcfg = _f32(rget_config)(arch).smoke()
    cfg = _f32(get_config)(arch).smoke()
    rmodel = rbuild(rcfg)
    params = _open_gates(rmodel.init(jax.random.PRNGKey(0)), cfg)
    model = build_model(cfg, device="cpu").load_jax_params(
        jax.tree_util.tree_map(np.asarray, params))
    B, P, new = 4, 16, 4
    batch = prefix(inputs(cfg, seed=11, B=B, S=P + new), P)
    frames = inputs(cfg, seed=12, B=B, S=new).get("embeddings")
    rl, rcache = rmodel.prefill(params, jx(batch), cache_len=P + new)
    logits, cache = make_prefill_step(model, cache_len=P + new)(batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), atol=1e-4,
                               rtol=1e-4)
    decode = make_decode_step(model)
    for t in range(new):
        if frames is None:
            tok = np.argmax(np.asarray(rl), -1)
            assert np.array_equal(tok, logits.argmax(-1).numpy())
            step = {"tokens": tok[:, None].astype(np.int32)}
        else:
            step = {"embeddings": frames[:, t:t + 1]}
        q_pos = np.full((B,), P + t, np.int32)
        rl, rcache = rmodel.decode_step(params, rcache, jx(step),
                                        jnp.asarray(q_pos))
        logits, cache = decode(cache, step, q_pos)
        assert logits.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rl),
                                   atol=1e-3, rtol=1e-3, err_msg=f"t={t}")
    assert cache["pos"].tolist() == [P + new] * B
