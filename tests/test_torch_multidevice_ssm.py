"""Multi-device training of the ssm and hybrid families on the CPU: worlds
of processes over gloo (``fixtures_torch_multidevice``), held against the
reference (``fixtures_torch_multidevice_ref``).

- **Training**: three AdamW steps (float32, lr 1e-3) under ``plan_for``'s
  train plan on one batch of B=4, S=48 with 3 pads, from the reference's
  parameters (``load_jax_params``), of the smoke falcon-mamba-7b (Mamba1:
  K8's plain version through its new ``local_map`` on each rank's
  channels) and the smoke zamba2-2.7b (12 Mamba2 blocks in 6 groups of 2,
  each followed by the one shared attention block) at meshes (pod, data,
  model) (1, 2, 2) and (1, 1, 4): d_inner, and Mamba2's heads, over
  "model".  Each step's loss and grad norm, and every parameter after it,
  equal the reference's single-device JAX trajectory at
  test_torch_train.py's LOSS_TOL, GRAD_TOL and PARAM_TOL: falcon's
  parameters each within PARAM_TOL, zamba2's as test_torch_train holds
  the moe model's (``fx.NEAR_ZERO_RULE``: on this batch its one-device
  path already moves 4 elements beyond PARAM_TOL, each where the first
  gradient is ~0, and each mesh moves 2 such).  Beside that update
  check, zamba2's gradients at the reference's parameters before each
  step (the world replays them after its steps) equal the reference's
  tensor by tensor within GRAD_TOL: the ops agree, and the drift is
  AdamW's first updates of near-zero gradients.
- **Placements**: every parameter is placed as the reference's
  PartitionSpec of its leaf says (``in_proj`` whole over "model" on its
  2 d_inner columns, the per-channel parameters on d_inner).
- **The sharded paths ran**: K8's ``local_map`` (falcon), the SSD's and
  the conv's over channels, K7's for zamba2's shared block.
- **Refusals**: a model axis that does not divide d_inner or Mamba2's
  heads raises, naming them.  ``tp_mode="shard_map"``, pipeline stages
  and the causal_skip schedule, which the port once refused, are now
  admitted for every family that trains under a plan (the moe, ssm and
  hybrid families here, gemma2's local_global schedule and the vlm and
  audio families of ``test_torch_multidevice_{local_global,media}.py``;
  trained in ``test_torch_multidevice_shard_map{,_families}.py``).

The card's twin (K8 launching through its ``local_map``, and K7 through
its own at hd 80 and under a window, in a world of one over NCCL) is
``test_torch_cuda.py::test_kernels_launch_through_local_map_on_the_card``:
card tests import no JAX.
"""
from types import SimpleNamespace

import numpy as np
import pytest

import fixtures_torch_multidevice as fx
import fixtures_torch_multidevice_ref as ref
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.specs import plan_for
from repro_torch.models.model import build_model, check_supported

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-2.7b"
MESHES = [(1, 2, 2), (1, 1, 4)]
RUNS = [(arch, None, mesh) for arch in (FALCON, ZAMBA) for mesh in MESHES]
IDS = [ref.run_id(r) for r in RUNS]
SHAPE = ShapeConfig("train", 32, 8, "train")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ref.trained(tmp_path_factory.mktemp("multidevice_ssm"), RUNS,
                       replay=(ZAMBA,))


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_training_matches_reference(trained, run, step):
    ref.check_step(run[0], *trained[ref.run_id(run)], step)


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS[2:], ids=IDS[2:])
def test_hybrid_gradients_match_reference(trained, run, step):
    """zamba2's gradients at the reference's parameters before each step,
    tensor by tensor within GRAD_TOL: the ops agree, so its parameters'
    drift beyond PARAM_TOL is AdamW's first updates of near-zero
    gradients (``fx.NEAR_ZERO_RULE``)."""
    assert run[0] == ZAMBA
    ref.check_step_grads(trained[ref.run_id(run)][0],
                         trained[ref.run_id(run)][1], step)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_parameters_are_placed_as_the_reference_specs(trained, run):
    arch, over, mesh = run
    got = trained[ref.run_id(run)][1]
    ref.check_placements(arch, over, mesh, got)
    proj = "in_proj" if arch == FALCON else "in_proj_xz"
    assert str(got[f"placed/layers.0.{proj}"]) == {
        (1, 2, 2): "(Shard(dim=0), Shard(dim=1))",
        (1, 1, 4): "(Shard(dim=1),)"}[mesh]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_the_sharded_paths_ran(trained, run):
    """Remat nothing_saveable runs each layer's (a hybrid's each group's)
    forward again in the backward: twice a step."""
    got = trained[ref.run_id(run)][1]
    cfg = fx.smoke_cfg(run[0])
    twice = 2 * fx.STEPS
    assert int(got["path/causal_conv1d"]) == twice * cfg.n_layers
    if run[0] == FALCON:
        assert int(got["path/_selective_scan_sharded"]) == \
            twice * cfg.n_layers
        assert int(got["path/_flash_attention_sharded"]) == 0
    else:
        assert int(got["path/ssd_chunked"]) == twice * cfg.n_layers
        assert int(got["path/_flash_attention_sharded"]) == \
            twice * cfg.n_layers // cfg.hybrid_period


def _stand_in(shape):
    return SimpleNamespace(mesh_dim_names=fx.AXES, shape=shape,
                           size=lambda dim=None: int(np.prod(shape))
                           if dim is None else shape[dim])


@pytest.mark.parametrize("arch,over,mesh,match", [
    (FALCON, {}, (1, 1, 3),
     r"128 Mamba channels \(d_inner\) over a model axis of 3"),
    # the 4 attention heads are cut as DTensor cuts a dim (2, 2, 0), so
    # zamba2 at 3 is refused for its Mamba channels (the case keeps its id)
    pytest.param(ZAMBA, {}, (1, 1, 3),
                 r"128 Mamba channels \(d_inner\) over a model axis of 3",
                 id="zamba2-2.7b-over1-mesh1-4 attention heads over a model "
                    "axis of 3"),
    # 128 / 64 = 2 Mamba2 heads; the 4 attention heads and d_inner split
    (ZAMBA, {"ssm_head_dim": 64}, (1, 1, 4),
     r"2 Mamba2 heads over a model axis of 4")])
def test_what_does_not_split_over_the_model_axis_refuses(arch, over, mesh,
                                                         match):
    cfg = fx.smoke_cfg(arch, **over)
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg, plan_for(cfg, SHAPE, _stand_in(mesh)),
                    device="cpu")


@pytest.mark.parametrize("kw", [dict(tp_mode="shard_map"),
                                dict(pipeline_stages=2),
                                dict(attention_schedule="causal_skip")],
                         ids=["shard_map", "pipeline", "causal_skip"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b",
                                  FALCON, ZAMBA, "gemma2-9b",
                                  "llama-3.2-vision-11b", "musicgen-medium"])
def test_admitted_families_refuse_what_is_not_ported(arch, kw):
    """Nothing of these three is left unported: each plan variant is
    admitted (``check_supported`` raises nothing)."""
    cfg = REGISTRY[arch].smoke()
    plan = plan_for(cfg, SHAPE, _stand_in((1, 2, 2))).with_(**kw)
    check_supported(cfg, plan)
    assert getattr(plan, next(iter(kw))) == next(iter(kw.values()))
