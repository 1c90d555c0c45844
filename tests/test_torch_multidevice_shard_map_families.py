"""tp_mode="shard_map" (the reference's explicit Megatron projections)
in the moe, vlm and hybrid families on the CPU: worlds of processes over
gloo (``fixtures_torch_multidevice``), held against the reference
(``fixtures_torch_multidevice_ref``).

- **Training**: three AdamW steps (float32, lr 1e-3) under ``plan_for``'s
  train plan with ``tp_mode="shard_map"`` on one batch of B=4, S=48 with
  3 pads, from the reference's parameters, of the smoke
  qwen3-moe-30b-a3b at mesh (pod, data, model) (1, 2, 2) (its groups
  under the moe FFN's local_maps, which the reference takes under
  shard_map and the port in both modes), the smoke llama-3.2-vision-11b
  at (1, 1, 4) (its gates opened on both sides) and the smoke
  zamba2-2.7b at (1, 1, 4).  Each step's loss and grad norm, and every
  parameter after it, equal the reference's single-device JAX trajectory
  at test_torch_train.py's LOSS_TOL, GRAD_TOL and PARAM_TOL (qwen3's and
  zamba2's parameters by ``fx.NEAR_ZERO_RULE``, as in their gspmd
  tests).
- **Placements**: every parameter as the reference's PartitionSpec says.
- **Which projections are explicit**: the self-attention blocks' q and
  ``wo`` and every MLP's (the vlm's cross blocks' MLPs and zamba2's
  shared block's among them), counted; none in qwen3's moe FFN, the vlm
  cross blocks' q and ``wo`` (plain einsums in the reference) or
  zamba2's Mamba2 mixers.  The vlm's 2 media KV heads stay replicated
  over a model axis of 4.
"""
import numpy as np
import pytest

import fixtures_torch_multidevice as fx
import fixtures_torch_multidevice_ref as ref

MOE, VLM, ZAMBA = "qwen3-moe-30b-a3b", "llama-3.2-vision-11b", "zamba2-2.7b"
SHARD_MAP = {"tp_mode": "shard_map"}
RUNS = [(MOE, None, (1, 2, 2), SHARD_MAP), (VLM, None, (1, 1, 4), SHARD_MAP),
        (ZAMBA, None, (1, 1, 4), SHARD_MAP)]
IDS = [ref.run_id(r) for r in RUNS]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ref.trained(
        tmp_path_factory.mktemp("multidevice_shard_map_families"), RUNS)


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_training_matches_reference(trained, run, step):
    ref.check_step(run[0], *trained[ref.run_id(run)], step)


@pytest.mark.parametrize("step", ref.STEPS)
def test_aux_losses_match_reference(trained, step):
    (traj, _), got = trained[ref.run_id(RUNS[0])]
    for k in fx.MOE_METRICS:
        np.testing.assert_allclose(float(got[f"{k}_{step}"]),
                                   traj[step - 1][k], rtol=fx.LOSS_TOL,
                                   atol=0, err_msg=k)
    assert traj[step - 1]["drop_frac"] > 0   # capacity drops slots


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_parameters_are_placed_as_the_reference_specs(trained, run):
    arch, over, mesh, _ = run
    ref.check_placements(arch, over, mesh, trained[ref.run_id(run)][1])


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_which_projections_are_explicit(trained, run):
    """Remat runs each layer's (a vlm's and a hybrid's each group's)
    forward again in the backward: twice a step."""
    got = trained[ref.run_id(run)][1]
    cfg = fx.smoke_cfg(run[0])
    twice = 2 * fx.STEPS
    col, row = fx.explicit_projections(cfg)
    k7 = "path/_flash_attention_sharded"
    cross = "path/_cross_attention_sharded"
    assert int(got[k7]) == int(got[f"{k7}/schedule/dense"]) > 0
    if run[0] == MOE:       # q and wo a layer; the moe FFN is no projection
        assert (col, row) == (cfg.n_layers, cfg.n_layers)
        assert int(got["path/_moe_ffn_sharded"]) == twice * cfg.n_layers
    elif run[0] == VLM:
        # a group: the self block's q, wo and MLP (3, 2), the cross
        # block's MLP (2, 1), its q and wo in the GSPMD form
        groups = cfg.n_layers // cfg.cross_attn_period
        assert (col, row) == (5 * groups, 3 * groups)
        assert int(got[cross]) == twice * groups
        assert int(got[f"{cross}/kv_split"]) == 0
    else:                   # the shared block a group; no Mamba2 mixer's
        groups = cfg.n_layers // cfg.hybrid_period
        assert (col, row) == (3 * groups, 2 * groups)
        assert int(got["path/ssd_chunked"]) == twice * cfg.n_layers
    assert int(got["path/explicit_col_project"]) == twice * col
    assert int(got["path/explicit_row_project"]) == twice * row
