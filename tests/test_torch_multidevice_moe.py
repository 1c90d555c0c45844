"""Multi-device training of the moe family on the CPU: worlds of processes
over gloo (``fixtures_torch_multidevice``), held against the reference
(``fixtures_torch_multidevice_ref``).

- **Training**: three AdamW steps (float32, lr 1e-3) under ``plan_for``'s
  train plan on one batch of B=4, S=48 with 3 pads, from the reference's
  parameters (``load_jax_params``), of the smoke qwen3-moe-30b-a3b (4
  experts, top 2: expert parallelism over "model") at meshes (pod, data,
  model) (1, 2, 2) and (1, 1, 4); of the same with 3 experts at (1, 2,
  2), which ``moe_rules_for`` turns to TP-within-expert (the experts' FFN
  dim over "model"); and of the smoke mixtral-8x7b (swa: the window of 16
  engages at S=48, so K7 runs its window under ``local_map``) at both
  meshes.  Each step's loss and grad norm, and every parameter after it,
  equal the reference's single-device JAX trajectory at
  test_torch_train.py's LOSS_TOL, GRAD_TOL and PARAM_TOL, the parameters
  held as test_torch_train holds the moe model's (``params_agree``).
  **The oracle**: the capacity, so which slots drop, depends on the group
  size ``min(moe_group_size, T // moe_target_groups)``, and ``plan_for``
  sets ``moe_target_groups`` to the world's size: a world of 4 is held
  against the reference's single device under
  ``single_device_plan().with_(moe_target_groups=4)``, not the bare
  single-device plan.
- **The aux losses**: ``lb_loss``, ``z_loss`` and ``drop_frac`` of each
  step equal the reference's under that plan (``lb_loss`` is a product
  of two means over every group: each rank's own would be another
  number).
- **Placements**: every parameter is placed as the reference's
  PartitionSpec of its leaf says, and an expert's w1 as EP or TP needs.
- **The sharded paths ran**: the moe FFN's (``_moe_ffn_sharded``) once a
  layer a forward, K7's ``local_map``.
- **torchrun** at world 2 trains the smoke qwen3-moe: its loss falls and
  its ``[raqo]`` line names 2 chips.
- **Refusals**: a model axis that divides neither the experts nor their
  FFN dim raises, naming both.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import fixtures_torch_multidevice as fx
import fixtures_torch_multidevice_ref as ref
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.specs import plan_for

ROOT = Path(__file__).resolve().parents[1]
QWEN, MIXTRAL = "qwen3-moe-30b-a3b", "mixtral-8x7b"
MESHES = [(1, 2, 2), (1, 1, 4)]
RUNS = [(arch, None, mesh) for arch in (QWEN, MIXTRAL) for mesh in MESHES] \
    + [(QWEN, {"n_experts": 3}, (1, 2, 2))]
IDS = [ref.run_id(r) for r in RUNS]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ref.trained(tmp_path_factory.mktemp("multidevice_moe"), RUNS)


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_training_matches_reference(trained, run, step):
    ref.check_step(run[0], *trained[ref.run_id(run)], step)


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_aux_losses_match_reference(trained, run, step):
    (traj, _), got = trained[ref.run_id(run)]
    for k in fx.MOE_METRICS:
        np.testing.assert_allclose(float(got[f"{k}_{step}"]),
                                   traj[step - 1][k], rtol=fx.LOSS_TOL,
                                   atol=0, err_msg=k)
    assert traj[step - 1]["drop_frac"] > 0   # capacity drops slots


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_parameters_are_placed_as_the_reference_specs(trained, run):
    arch, over, mesh = run
    got = trained[ref.run_id(run)][1]
    ref.check_placements(arch, over, mesh, got)
    # EP: experts over model (and d over data, FSDP); TP-within-expert:
    # the experts whole, their FFN dim over model
    want = {(1, 1, 4): "(Shard(dim=0),)",
            (1, 2, 2): "(Shard(dim=1), Shard(dim=0))"}[mesh] if over is None \
        else "(Shard(dim=1), Shard(dim=2))"
    assert str(got["placed/layers.0.moe.w1"]) == want


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_the_sharded_paths_ran(trained, run):
    """Remat nothing_saveable runs each layer's forward again in the
    backward: twice a layer a step."""
    got = trained[ref.run_id(run)][1]
    layers = fx.smoke_cfg(run[0]).n_layers
    want = 2 * layers * fx.STEPS
    assert int(got["path/_moe_ffn_sharded"]) == want
    assert int(got["path/_flash_attention_sharded"]) == want


def _stand_in(shape):
    return SimpleNamespace(mesh_dim_names=fx.AXES, shape=shape,
                           size=lambda dim=None: int(np.prod(shape))
                           if dim is None else shape[dim])


def test_experts_that_split_over_neither_axis_refuse():
    """3 experts and an FFN dim of 33 over a model axis of 2: EP cannot
    split the experts, TP-within-expert cannot split their FFN dim."""
    from repro_torch.models.model import build_model
    cfg = fx.smoke_cfg(QWEN, n_experts=3, d_ff=33)
    plan = plan_for(cfg, ShapeConfig("train", 32, 8, "train"),
                    _stand_in((1, 2, 2)))
    with pytest.raises(NotImplementedError,
                       match=r"33 expert FFN dims \(d_ff; 3 experts"):
        build_model(cfg, plan, device="cpu")
    # d_ff 32 splits: TP-within-expert builds (no process group is needed
    # before the parameters are drawn, so only the check runs here)
    from repro_torch.models.model import check_supported
    cfg = fx.smoke_cfg(QWEN, n_experts=3)
    check_supported(cfg, plan_for(cfg, ShapeConfig("train", 32, 8, "train"),
                                  _stand_in((1, 2, 2))))


@pytest.fixture(scope="module")
def torchrun_moe(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchrun_moe")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", QWEN, "--smoke", "--steps", "12", "--batch", "2",
         "--seq", "32", "--log-every", "1", "--ckpt-every", "12",
         "--device", "cpu", "--ckpt-dir", str(d / "ck")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


def test_torchrun_trains_moe_on_the_planned_mesh(torchrun_moe):
    out = torchrun_moe.stdout
    assert torchrun_moe.returncode == 0, out + torchrun_moe.stderr[-3000:]
    raqo = [l for l in out.splitlines() if l.startswith("[raqo]")]
    assert len(raqo) == 1 and "(2 chips)" in raqo[0], out
    assert "over 2 of 2 ranks" in out
    losses = [float(l.split("loss")[1].split()[0]) for l in out.splitlines()
              if l.startswith("[train] step")]
    assert len(losses) == 12
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
