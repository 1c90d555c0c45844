"""The port's data pipeline and checkpoint manager
(``repro_torch.data``, ``repro_torch.checkpoint``): the counterparts of
the pipeline and checkpoint tests of ``tests/test_checkpoint_data_optim.py``
and of ``tests/test_compression.py``'s error-feedback checkpoint case;
batches bit-equal to the reference's for the same (seed, step, host); a
train state saved by the port restores into a fresh one."""
import os

import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREGISTRY
from repro.data import SyntheticPipeline as RSyntheticPipeline
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import REGISTRY
from repro_torch.data import SyntheticPipeline, make_batch_fn
from repro_torch.optim import AdamW, GradCompression


# ------------------------------ checkpoint --------------------------------- #

def _state():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"m": torch.ones((3, 4)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*[_zeros_like(v) for v in tree])
    return None if tree is None else torch.zeros_like(tree)


def _leaves(tree):
    from repro_torch.checkpoint.manager import _flatten
    return _flatten(tree)


def test_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    s = _state()
    cm.save(10, s, extras={"data_step": 10})
    restored, extras = cm.restore(_zeros_like(s))
    assert extras["data_step"] == 10
    for a, b in zip(_leaves(s), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_k_gc(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        cm.save(step, _state())
    assert cm.steps() == [3, 4]


def test_atomicity_no_tmp_left(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3)
    cm.save(1, _state())
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]


def test_restore_specific_step_and_mismatch(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _state())
    cm.save(2, {"w": torch.zeros((3, 4)),
                "opt": {"m": torch.zeros((3, 4)),
                        "step": torch.tensor(0, dtype=torch.int32)}})
    r, _ = cm.restore(_state(), step=1)
    assert float(_leaves(r)[0][0, 1]) == 1.0
    with pytest.raises(ValueError, match="leaves"):
        cm.restore({"only": torch.zeros(())})
    bad = _state()
    bad["w"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="shape"):
        cm.restore(bad)


def test_async_save(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(5, _state(), async_=True)
    cm.wait()
    assert cm.latest_step() == 5


def test_checkpoint_roundtrip_with_err_state(tmp_path):
    opt = AdamW(lr=1e-3, compression=GradCompression("int8"))
    params = {"x": torch.ones(4)}
    state = opt.init(params)
    params, state, _ = opt.update({"x": torch.full((4,), 0.3)}, state,
                                  params)
    cm = CheckpointManager(tmp_path)
    cm.save(1, state)
    restored, _ = cm.restore(_zeros_like(state))
    assert len(_leaves(state)) == 4          # step, m, v, err
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert torch.equal(a, b)


def test_bfloat16_leaves_roundtrip(tmp_path):
    s = {"h": torch.randn(5, 3).to(torch.bfloat16), "f": torch.randn(2)}
    cm = CheckpointManager(tmp_path)
    cm.save(3, s)
    r, _ = cm.restore(_zeros_like(s))
    assert r["h"].dtype == torch.bfloat16 and torch.equal(r["h"], s["h"])


def test_train_state_restores_in_place(tmp_path):
    """A TrainState over a model's parameters: restore writes into the
    model's own tensors, and a step after restore equals one without."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime.steps import init_train_state, make_train_step
    cfg = REGISTRY["smollm-360m"].smoke()
    batch = SyntheticPipeline(cfg, 2, 16, seed=1).batch_at(0)
    runs = []
    for restore in (False, True):
        model = build_model(cfg, device="cpu", seed=4)
        opt = AdamW(lr=1e-3)
        step = make_train_step(model, opt)
        state = init_train_state(model, opt)
        state, _ = step(state, batch)
        if restore:
            cm = CheckpointManager(tmp_path)
            cm.save(1, state)
            model = build_model(cfg, device="cpu", seed=9)
            step = make_train_step(model, opt)
            fresh = init_train_state(model, opt)
            state, _ = cm.restore(fresh)
            assert state.params["embed"] is model.embed
            assert int(state.step) == 1 and int(state.opt_state.step) == 1
        state, m = step(state, batch)
        runs.append((float(m["loss"]),
                     {k: v.detach().clone() for k, v in state.params.items()}))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


# ------------------------------ data pipeline ------------------------------ #

def test_pipeline_deterministic():
    cfg = REGISTRY["smollm-360m"].smoke()
    p = SyntheticPipeline(cfg, 4, 64, seed=3)
    a, b = p.batch_at(17), p.batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = p.batch_at(18)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_pipeline_label_shift():
    cfg = REGISTRY["smollm-360m"].smoke()
    b = SyntheticPipeline(cfg, 2, 32, seed=0).batch_at(0)
    assert b["tokens"].shape == (2, 32) and b["labels"].shape == (2, 32)
    assert (b["tokens"] < cfg.vocab_size).all()
    assert (b["labels"] >= 0).all()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_host_sharding():
    cfg = REGISTRY["smollm-360m"].smoke()
    h0 = SyntheticPipeline(cfg, 8, 32, seed=0, host_id=0, host_count=2)
    h1 = SyntheticPipeline(cfg, 8, 32, seed=0, host_id=1, host_count=2)
    a, b = h0.batch_at(0), h1.batch_at(0)
    assert a["tokens"].shape == (4, 32)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_pipeline_families():
    for arch in ("musicgen-medium", "llama-3.2-vision-11b"):
        cfg = REGISTRY[arch].smoke()
        b = SyntheticPipeline(cfg, 2, 16, seed=0).batch_at(0)
        if not cfg.embed_inputs:
            assert b["embeddings"].shape == (2, 16, cfg.media_embed_dim)
        if cfg.family == "vlm":
            assert b["media"].shape == (2, cfg.n_media_tokens,
                                        cfg.media_embed_dim)


def test_pipeline_prefetch_iterator():
    cfg = REGISTRY["smollm-360m"].smoke()
    p = SyntheticPipeline(cfg, 2, 16, seed=0)
    it = p.iterate(start_step=5)
    first = next(it)
    np.testing.assert_array_equal(first["tokens"], p.batch_at(5)["tokens"])


@pytest.mark.parametrize("arch,B,S,seed,host", [
    ("smollm-360m", 4, 64, 3, (0, 1)), ("smollm-360m", 8, 512, 0, (1, 2)),
    ("falcon-mamba-7b", 2, 100, 7, (0, 1)),
    ("musicgen-medium", 2, 16, 1, (0, 1)),
    ("llama-3.2-vision-11b", 4, 16, 2, (1, 2))])
def test_batches_bit_equal_to_reference(arch, B, S, seed, host):
    for smoke in (True, False):
        cfg, rcfg = REGISTRY[arch], RREGISTRY[arch]
        if smoke:
            cfg, rcfg = cfg.smoke(), rcfg.smoke()
        p = SyntheticPipeline(cfg, B, S, seed=seed, host_id=host[0],
                              host_count=host[1])
        rp = RSyntheticPipeline(rcfg, B, S, seed=seed, host_id=host[0],
                                host_count=host[1])
        for step in (0, 1, 17, 1000):
            got, want = p.batch_at(step), rp.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        make_batch_fn(cfg, B, S, seed)(3)["labels"],
        RSyntheticPipeline(rcfg, B, S, seed).batch_at(3)["labels"])
