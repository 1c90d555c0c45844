"""tp_mode="shard_map" (the reference's explicit Megatron projections),
the causal_skip block schedule and pipeline_stages on the CPU: worlds of
processes over gloo (``fixtures_torch_multidevice``), held against the
reference (``fixtures_torch_multidevice_ref``).

- **Training**: three AdamW steps (float32, lr 1e-3) under ``plan_for``'s
  train plan on one batch of B=4, S=48 with 3 pads, from the reference's
  parameters, of the smoke smollm-360m at mesh (pod, data, model)
  (1, 2, 2) under ``tp_mode="shard_map"`` and
  ``attention_schedule="causal_skip"``, and at (2, 1, 2) under
  ``tp_mode="shard_map"`` and ``pipeline_stages=2`` (the batch over
  "pod", each weight replicated there and its gradient summed over it;
  the reference reads ``pipeline_stages`` nowhere, so every rank trains
  the whole model).  Each step's loss and grad norm, and every parameter
  after it, equal the reference's single-device JAX trajectory at
  test_torch_train.py's LOSS_TOL, GRAD_TOL and PARAM_TOL.
- **Placements**: every parameter as the reference's PartitionSpec says.
- **The explicit projections ran**: q, ``wo`` and the MLP's three in
  every layer, counted (remat runs each forward twice), and K7 under the
  plan's schedule.
- **The explicit projections equal the GSPMD ones**, forward and both
  gradients, on seeded DTensors at (1, 2, 2) and (2, 1, 2) (in each
  world, after its training).
- **causal_skip past one block**: the reference's flash attention
  works in blocks of 512, so at S=48 its causal_skip is the dense loop.
  At S=1100 (3 blocks, 6 of 9 pairs) the smoke smollm and gemma2 under
  ``single_device_plan().with_(attention_schedule="causal_skip")`` give
  the loss and gradients of the reference's causal_skip model; gemma2's
  global layer takes the schedule, its local layer keeps "window".

The card's twin (a world of one over NCCL) is
``test_torch_cuda.py::test_kernels_launch_through_local_map_on_the_card``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures_torch_multidevice as fx
import fixtures_torch_multidevice_ref as ref
from repro.configs import REGISTRY as RREGISTRY
from repro.models import build_model as rbuild
from repro.runtime.steps import make_loss_fn as rmake_loss_fn
from repro.sharding import single_device_plan as rsingle_device_plan
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.runtime.steps import make_loss_fn
from repro_torch.sharding import single_device_plan

SMOLLM = "smollm-360m"
SHARD_MAP = {"tp_mode": "shard_map"}
RUNS = [(SMOLLM, None, (1, 2, 2),
         dict(SHARD_MAP, attention_schedule="causal_skip")),
        (SMOLLM, None, (2, 1, 2), dict(SHARD_MAP, pipeline_stages=2))]
IDS = [ref.run_id(r) for r in RUNS]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ref.trained(tmp_path_factory.mktemp("multidevice_shard_map"),
                       RUNS, probe=True)


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_training_matches_reference(trained, run, step):
    assert run[0] not in fx.NEAR_ZERO_RULE
    ref.check_step(run[0], *trained[ref.run_id(run)], step)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_parameters_are_placed_as_the_reference_specs(trained, run):
    arch, over, mesh, _ = run
    got = trained[ref.run_id(run)][1]
    ref.check_placements(arch, over, mesh, got)
    # wq: d over "data" (FSDP), the heads over "model"; replicated over
    # "pod", where its gradient is summed
    assert str(got["placed/layers.1.attn.wq"]) == {
        (1, 2, 2): "(Shard(dim=0), Shard(dim=1))",
        (2, 1, 2): "(Replicate(), Shard(dim=1))"}[mesh]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_the_explicit_projections_ran(trained, run):
    got = trained[ref.run_id(run)][1]
    cfg = fx.smoke_cfg(run[0])
    twice = 2 * fx.STEPS
    col, row = fx.explicit_projections(cfg)
    assert (col, row) == (3 * cfg.n_layers, 2 * cfg.n_layers)
    assert int(got["path/explicit_col_project"]) == twice * col
    assert int(got["path/explicit_row_project"]) == twice * row
    k7 = "path/_flash_attention_sharded"
    schedule = run[3].get("attention_schedule", "dense")
    assert int(got[k7]) == int(got[f"{k7}/schedule/{schedule}"]) == \
        twice * cfg.n_layers


@pytest.mark.parametrize("run", RUNS, ids=["1x2x2", "2x1x2"])
def test_explicit_projections_match_gspmd(trained, run):
    """On each world's mesh (after its training, ``fx.projections``): each
    projection's output and its input's and weight's gradients under
    shard_map within 1e-6 of the largest of GSPMD's; the explicit outputs
    placed as the reference's out_specs say."""
    got = trained[ref.run_id(run)][1]
    for kind in fx.PROJECTIONS:
        for part in ("y", "gx", "gw"):
            want = got[f"proj/{kind}/gspmd/{part}"]
            rel = np.abs(got[f"proj/{kind}/shard_map/{part}"] - want).max() \
                / np.abs(want).max()
            assert rel <= 1e-6, (kind, part, rel)
    # (batch, None, "model") out of g, (batch, "model", None) out of g-bar,
    # on the (data, model) or (pod, model) submesh
    assert str(got["proj/col/shard_map/placed"]) == \
        "(Shard(dim=0), Shard(dim=2))"
    assert str(got["proj/row/shard_map/placed"]) == \
        "(Shard(dim=0), Shard(dim=1))"


@pytest.mark.parametrize("arch", [SMOLLM, "gemma2-9b"])
def test_causal_skip_past_one_block_matches_reference(monkeypatch, arch):
    B, S = 1, 1100
    cfg = fx.smoke_cfg(arch)
    rcfg = dataclasses.replace(RREGISTRY[arch].smoke(), dtype="float32")
    batch = fx.batch(cfg, B, S)
    rmodel = rbuild(rcfg, rsingle_device_plan().with_(
        attention_schedule="causal_skip"))
    params = rmodel.init(jax.random.PRNGKey(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: rmake_loss_fn(rmodel)(p, jbatch)[0]))(params)
    want = ref._numpy(rgrads, cfg)

    schedules = []
    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: (
        schedules.append(kw["schedule"]), flash(*a, **kw))[1])
    model = build_model(cfg, single_device_plan().with_(
        attention_schedule="causal_skip"), device="cpu", seed=0)
    model.load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    named = dict(model.named_parameters())
    loss, _ = make_loss_fn(model)(batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    assert abs(float(loss.detach()) / float(rloss) - 1) <= fx.LOSS_TOL
    far, worst = ref.grads_agree(
        {k: g.numpy() for k, g in zip(named, grads)}, want)
    assert not far, (worst, far[:5])
    assert schedules == {SMOLLM: ["causal_skip"] * 2,
                         "gemma2-9b": ["window", "causal_skip"]}[arch]
