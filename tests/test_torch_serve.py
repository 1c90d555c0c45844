"""The port's serving loop against the reference's, at smoke size.

``repro.launch.serve.main`` runs with its ``get_config`` patched to a
float32 copy of the config (nothing in ``repro`` changes); its printed
first 8 tokens per request are parsed.  The port's ``serve`` gets the
same parameters through ``load_jax_params``, on the CPU, and must produce
the same tokens for every request.  At smoke size greedy decode mostly
repeats one token per request, so these tests check the plumbing of
slots, admission waves and cache merges; ``test_torch_models.py`` holds
the numerics.
"""
import dataclasses
import functools
import re

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as rserve
from repro.configs import get_config as rget_config
from repro.models import build_model as rbuild
from repro_torch.configs import get_config
from repro_torch.launch.serve import merge_cache, serve
from repro_torch.models.model import load_jax_params

ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b"]
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
                                                             params)),
                 requests=8, slots=slots, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    want = _reference_run(arch, 4)
    got = _port_run(arch, 4)
    assert got["served"] == 8 and got["steps"] > 0
    assert {rid: toks[:8] for rid, toks in got["tokens"].items()} == want
    assert all(len(t) == 32 for t in got["tokens"].values())
    assert got["prefill_waves"] >= 2 and got["first_logits"].shape[0] == 4


@pytest.mark.parametrize("arch", ["smollm-360m", "falcon-mamba-7b"])
def test_serve_with_slots_equal_to_layers(arch):
    """slots == n_layers (2 at smoke size): the reference's merge would
    scatter along the layer axis; the port merges along the batch axis,
    so every request decodes as it does with 4 slots.  (Not the moe
    model: its experts' capacity depends on the batch, so a request's
    tokens with 2 slots are not its tokens with 4, in either package.)"""
    assert get_config(arch).smoke().n_layers == 2
    got = _port_run(arch, 2)
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
