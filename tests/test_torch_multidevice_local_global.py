"""Multi-device training of gemma2's local_global schedule on the CPU:
worlds of processes over gloo (``fixtures_torch_multidevice``), held
against the reference (``fixtures_torch_multidevice_ref``).

- **Training**: three AdamW steps (float32, lr 1e-3) under ``plan_for``'s
  train plan on one batch of B=4, S=48 with 3 pads, from the reference's
  parameters (``load_jax_params``), of the smoke gemma2-9b (one (local,
  global) pair: 4 heads over 2 KV heads, the attention softcap of 50 and
  the final softcap of 30, post-norms, scaled and tied embeddings; the
  local layer's window of 16 engages at S=48) at meshes (pod, data,
  model) (1, 2, 2) and (1, 1, 4).  Each step's loss and grad norm, and
  every parameter after it, equal the reference's single-device JAX
  trajectory at test_torch_train.py's LOSS_TOL, GRAD_TOL and PARAM_TOL,
  every parameter within PARAM_TOL.
- **Positions**: the same at (1, 2, 2) on a batch of its own positions
  (``fx.VARIANTS``: rows 0 and 2 left-padded by 7, their labels -1
  there), K7 masking by them under ``local_map``; its parameters by
  ``fx.params_agree``'s near-zero rule (an element beyond PARAM_TOL only
  where its first gradient is within GRAD_TOL x max of zero).
- **Placements**: every parameter is placed as the reference's
  PartitionSpec of its leaf says.
- **The sharded paths ran**: K7's ``local_map`` on both layers of the
  pair, the local one with its window, both with the softcap.

The card's twin (a world of one over NCCL, the window engaged at S=64)
is ``test_torch_cuda.py::test_kernels_launch_through_local_map_on_the_card``.
"""
import pytest

import fixtures_torch_multidevice as fx
import fixtures_torch_multidevice_ref as ref

GEMMA = "gemma2-9b"
MESHES = [(1, 2, 2), (1, 1, 4)]
RUNS = [(GEMMA, None, mesh) for mesh in MESHES] + \
    [("gemma2-9b-leftpad", None, (1, 2, 2))]
IDS = [ref.run_id(r) for r in RUNS]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ref.trained(tmp_path_factory.mktemp("multidevice_local_global"),
                       RUNS)


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_training_matches_reference(trained, run, step):
    # the unpadded batch's parameters all within PARAM_TOL; the
    # left-padded one's by the near-zero rule (fx.NEAR_ZERO_RULE)
    assert (run[0] in fx.NEAR_ZERO_RULE) == (run[0] in fx.VARIANTS)
    ref.check_step(run[0], *trained[ref.run_id(run)], step)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_parameters_are_placed_as_the_reference_specs(trained, run):
    arch, over, mesh = run
    got = trained[ref.run_id(run)][1]
    ref.check_placements(arch, over, mesh, got)
    # wq: d over "data" (FSDP), the heads over "model"
    assert str(got["placed/layers.1.attn.wq"]) == {
        (1, 2, 2): "(Shard(dim=0), Shard(dim=1))",
        (1, 1, 4): "(Shard(dim=1),)"}[mesh]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_the_sharded_paths_ran(trained, run):
    """Remat nothing_saveable runs each pair's forward again in the
    backward: each layer's K7 twice a step, the local layer's with its
    window, both with the softcap."""
    got = trained[ref.run_id(run)][1]
    cfg = fx.smoke_cfg(run[0])
    assert cfg.window < ref.S and cfg.attn_softcap
    twice = 2 * fx.STEPS
    k7 = "path/_flash_attention_sharded"
    assert int(got[k7]) == twice * cfg.n_layers
    assert int(got[f"{k7}/window"]) == twice * cfg.n_layers // 2
    assert int(got[f"{k7}/softcap"]) == twice * cfg.n_layers
    assert int(got["path/_cross_attention_sharded"]) == 0
