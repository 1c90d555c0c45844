"""Multi-device training of the vlm and audio families on the CPU: worlds
of processes over gloo (``fixtures_torch_multidevice``), held against the
reference (``fixtures_torch_multidevice_ref``).

- **Training**: three AdamW steps (float32, lr 1e-3) under ``plan_for``'s
  train plan on one batch of B=4, S=48 with 3 pads, from the reference's
  parameters (``load_jax_params``), of the smoke llama-3.2-vision-11b (5
  groups of one self block and one gated cross block onto 8 media
  tokens, its gates opened on both sides: ``fixtures_torch_media``) and
  the smoke musicgen-medium (dense blocks on projected frame
  embeddings) at meshes (pod, data, model) (1, 2, 2) and (1, 1, 4).  The
  media and the frame embeddings enter sharded as the reference's
  ``batch_shardings`` places them.  At (1, 2, 2) the vlm's 2 media KV
  heads split over "model"; at (1, 1, 4) they do not, and stay
  replicated over it (``transformer.media_kv_for``).  Each step's loss
  and grad norm, and every parameter after it, equal the reference's
  single-device JAX trajectory at test_torch_train.py's LOSS_TOL,
  GRAD_TOL and PARAM_TOL, every parameter within PARAM_TOL.
- **Placements**: every parameter is placed as the reference's
  PartitionSpec of its leaf says, the vlm's ``cross.<g>`` blocks (the
  reference's stacked ``cross`` leaves) and their 0-d gates included.
- **The sharded paths ran**: K7's ``local_map`` in every self block,
  cross attention's ``local_map`` in every cross block.
- **torchrun** at world 2 trains the smoke vlm: its loss falls.

The card's twin (a world of one over NCCL, the gates open) is
``test_torch_cuda.py::test_kernels_launch_through_local_map_on_the_card``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import fixtures_torch_multidevice as fx
import fixtures_torch_multidevice_ref as ref

ROOT = Path(__file__).resolve().parents[1]
VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
MESHES = [(1, 2, 2), (1, 1, 4)]
RUNS = [(arch, None, mesh) for arch in (VLM, AUDIO) for mesh in MESHES]
IDS = [ref.run_id(r) for r in RUNS]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ref.trained(tmp_path_factory.mktemp("multidevice_media"), RUNS)


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_training_matches_reference(trained, run, step):
    assert run[0] not in fx.NEAR_ZERO_RULE
    ref.check_step(run[0], *trained[ref.run_id(run)], step)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_parameters_are_placed_as_the_reference_specs(trained, run):
    arch, over, mesh = run
    got = trained[ref.run_id(run)][1]
    ref.check_placements(arch, over, mesh, got)
    # the projector (media_embed_dim, d): d over "data" (FSDP)
    assert str(got["placed/projector"]) == {
        (1, 2, 2): "(Shard(dim=1), Replicate())",
        (1, 1, 4): "(Replicate(),)"}[mesh]
    if arch == VLM:
        cfg = fx.smoke_cfg(arch)
        g = cfg.n_layers // cfg.cross_attn_period
        assert sum(k.startswith("placed/cross.") and k.endswith(".gate_attn")
                   for k in got) == g
        assert str(got[f"placed/cross.{g - 1}.gate_mlp"]) == {
            (1, 2, 2): "(Replicate(), Replicate())",
            (1, 1, 4): "(Replicate(),)"}[mesh]
        assert str(got["placed/cross.0.attn.wk"]) == {
            (1, 2, 2): "(Shard(dim=0), Shard(dim=1))",
            (1, 1, 4): "(Shard(dim=1),)"}[mesh]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_the_sharded_paths_ran(trained, run):
    """Remat nothing_saveable runs each layer's (a vlm's each group's)
    forward again in the backward: twice a step.  A vlm's self blocks
    launch K7, its cross blocks attend through their own ``local_map``."""
    got = trained[ref.run_id(run)][1]
    cfg = fx.smoke_cfg(run[0])
    twice = 2 * fx.STEPS
    cross = cfg.n_layers // cfg.cross_attn_period if run[0] == VLM else 0
    assert int(got["path/_flash_attention_sharded"]) == \
        twice * (cfg.n_layers - cross)
    assert int(got["path/_cross_attention_sharded"]) == twice * cross
    assert int(got["path/_flash_attention_sharded/window"]) == 0


@pytest.fixture(scope="module")
def torchrun_vlm(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchrun_vlm")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", VLM, "--smoke", "--steps", "12", "--batch", "2",
         "--seq", "32", "--log-every", "1", "--ckpt-every", "12",
         "--device", "cpu", "--ckpt-dir", str(d / "ck")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


def test_torchrun_trains_the_vlm_on_the_planned_mesh(torchrun_vlm):
    out = torchrun_vlm.stdout
    assert torchrun_vlm.returncode == 0, out + torchrun_vlm.stderr[-3000:]
    raqo = [l for l in out.splitlines() if l.startswith("[raqo]")]
    assert len(raqo) == 1 and "(2 chips)" in raqo[0], out
    assert "over 2 of 2 ranks" in out
    losses = [float(l.split("loss")[1].split()[0]) for l in out.splitlines()
              if l.startswith("[train] step")]
    assert len(losses) == 12
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
