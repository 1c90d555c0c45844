"""Heads that the model axis does not divide, on the CPU: gloo worlds of
2 processes with the model axis 2 (``fixtures_torch_multidevice``) and
the smoke smollm-360m at 3 q heads over 1 KV head
(``fx.VARIANTS["smollm-360m-3heads"]``), held against the reference's
single device (``fixtures_torch_multidevice_ref``), float32.

The port cuts the q heads as DTensor's ``Shard`` cuts a dim
(``sharding.chunk_range``: 2 and 1 here, as jax's padded split tiles them),
each rank's K7 reading the KV heads its own q heads read.

The reference under ``tp_mode="shard_map"`` with the same plans was
probed on the CPU with 2 forced host devices, ``plan_for(cfg,
ShapeConfig("t", 16, 2, kind), mesh (1, 1, 2), tp_mode=...)``, jitted:

| kind | gspmd | shard_map |
|---|---|---|
| train | runs | runs (the same loss) |
| prefill | runs | runs |
| decode | runs | ValueError (the one-token sequence over "model") |

so the port trains and prefills under shard_map and raises
``ValueError`` at the first shard_map decode step
(``sharding.check_explicit_split``), as it does for every model.

- **Training**: three AdamW steps under ``plan_for``'s train plan, in
  GSPMD and in shard_map: each step's loss, grad norm and parameters as
  the reference's at ``test_torch_train.py``'s tolerances.
- **Serving**: ``test_torch_multidevice_uneven_heads_serve.py``.
"""
import pytest

import fixtures_torch_multidevice as fx
import fixtures_torch_multidevice_ref as ref

ARCH = "smollm-360m-3heads"
MESH = (1, 1, 2)
SM = {"tp_mode": "shard_map"}
RUNS = [(ARCH, None, MESH), (ARCH, None, MESH, SM)]
IDS = [ref.run_id(r) for r in RUNS]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ref.trained(tmp_path_factory.mktemp("multidevice_uneven"), RUNS)


def test_heads_do_not_divide_the_model_axis():
    cfg = fx.smoke_cfg(ARCH)
    assert cfg.n_heads % MESH[2] and cfg.n_heads // cfg.n_kv_heads == 3


@pytest.mark.parametrize("step", ref.STEPS)
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_training_matches_reference(trained, run, step):
    ref.check_step(run[0], *trained[ref.run_id(run)], step)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_parameters_are_placed_as_the_reference_specs(trained, run):
    arch, over, mesh, *_ = run
    got = trained[ref.run_id(run)][1]
    ref.check_placements(arch, over, mesh, got)
    assert int(got["path/_flash_attention_sharded"]) > 0
