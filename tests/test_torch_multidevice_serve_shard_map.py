"""Serving under ``tp_mode="shard_map"`` on the CPU: one world of 4
processes over gloo that builds two meshes over the same ranks, (pod,
data, model) (2, 2, 1) and (1, 2, 2) (``fx.serve_worker``), each
case under ``plan_for``'s prefill and decode plans with
``tp_mode="shard_map"``, held against the reference's single-device
``prefill`` and ``decode_step`` (``fixtures_torch_multidevice_ref.
served``) at the reference's parameters, float32.

Where the reference serves under shard_map, and where it raises.  It was
probed on the CPU with forced host devices
(``--xla_force_host_platform_device_count``): the smoke configs in
float32, a prompt of 8 into a cache of 12, ``plan_for(cfg,
ShapeConfig("t", 16, B, kind), mesh, tp_mode="shard_map")`` on meshes
over ("pod", "data", "model"), ``jax.jit`` of ``prefill``, then of
``decode_step``:

| family (smoke arch) | B | mesh | prefill | decode |
|---|---|---|---|---|
| smollm, qwen3-moe, zamba2, gemma2, vlm, musicgen | 2 | (1, 2, 1) | runs | runs |
| the same six | 2 | (1, 1, 2), (1, 2, 2) | runs | ValueError |
| falcon-mamba-7b | 2 | (1, 2, 1), (1, 1, 2), (1, 2, 2) | runs | runs |
| all seven | 4 | (2, 2, 1) | runs | runs |
| smollm, qwen3-moe, gathered | 16 | (2, 2, 1) | runs | runs |
| the same, gathered | 16 | (1, 2, 2) | runs | ValueError |
| smollm | 1 at (1, 2, 1); 2 at (2, 2, 1) | | ValueError | |

The decode ValueError is shard_map's: its explicit projections (q and
the MLP's) place the one-token sequence over "model", which does not
split it.  The prefill ValueError is the batch's: the bodies place it
over the data axes ("pod", "data") whatever the plan's "batch" rule.
falcon-mamba reaches no explicit projection, so it decodes on every
mesh.  The port raises the same ``ValueError`` before any block runs
(``sharding.check_explicit_split``).

Cases, every prompt of 18 into a cache of 22 slots, then 4 decode steps
each fed the reference's greedy token (musicgen: seeded frames):

- (2, 2, 1), prefill and decode: smollm-360m at B=4 (below serve_plan's
  cut at 16: the batch whole in the plan, split over ("pod", "data")
  inside the explicit bodies), smollm at B=16 with
  ``serve_weight_mode="gathered"`` (the batch over ("pod", "data"),
  "embed" over "data": the FSDP gather inside the bodies runs),
  qwen3-moe-30b-a3b, zamba2-2.7b, falcon-mamba-7b, gemma2-9b,
  llama-3.2-vision-11b (gates opened) and musicgen-medium at B=4;
- (1, 2, 2): the prefill of smollm, qwen3-moe and smollm at B=16
  gathered, each then refused at its first decode step; falcon's
  prefill and decode;
- (2, 2, 1): smollm at B=2, refused at its prefill.

Checks, at ``test_torch_multidevice_serve.py``'s tolerances: prefill
logits within 1e-4, each decode step within 1e-3, greedy tokens equal,
the prefill cache within 1e-5, every cache leaf placed as the
reference's ``cache_specs``; the decode model over the prefill model's
tensors; the explicit projections counted (a prefill's
``fx.explicit_projections``, a decode step's q and MLPs) and K7 under
``local_map`` once an attention block in prefill.

The card's twin (a world of one) is
``test_torch_cuda.py::test_serve_shard_map_on_the_card``.
"""
import numpy as np
import pytest

import fixtures_torch_multidevice as fx
import fixtures_torch_multidevice_ref as ref

SM = {"tp_mode": "shard_map"}
GATHERED = dict(SM, serve_weight_mode="gathered")
POD, MODEL = (2, 2, 1), (1, 2, 2)
FAMILIES = ("qwen3-moe-30b-a3b", "zamba2-2.7b", "falcon-mamba-7b",
            "gemma2-9b", "llama-3.2-vision-11b", "musicgen-medium")
# (mesh, arch, B, plan overrides, the step that raises or None)
CASES = ([(POD, "smollm-360m", 4, SM, None),
          (POD, "smollm-360m", 16, GATHERED, None)] +
         [(POD, arch, 4, SM, None) for arch in FAMILIES] +
         [(MODEL, "smollm-360m", 4, SM, "decode"),
          (MODEL, "qwen3-moe-30b-a3b", 4, SM, "decode"),
          (MODEL, "smollm-360m", 16, GATHERED, "decode"),
          (MODEL, "falcon-mamba-7b", 4, SM, None),
          (POD, "smollm-360m", 2, SM, "prefill")])
IDS = ["x".join(map(str, m)) + f"-{a}-B{b}" +
       ("-gathered" if "serve_weight_mode" in kw else "") +
       (f"-refused-{r}" if r else "") for m, a, b, kw, r in CASES]
PREFILLED = [c for c in CASES if c[4] != "prefill"]
SERVED = [c for c in CASES if c[4] is None]


def _id(case):
    return IDS[CASES.index(case)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    meshes = (POD, MODEL)
    out = ref.served(
        tmp_path_factory.mktemp("multidevice_serve_shard_map"),
        [(m, [(a, b, kw) + ((r,) if r else ()) for mm, a, b, kw, r in CASES
              if mm == m]) for m in meshes])
    results = {}
    for m, world in zip(meshes, out):
        cases = [c for c in CASES if c[0] == m]
        results.update(zip(map(_id, cases), world.values()))
    return results


@pytest.mark.parametrize("case", SERVED, ids=map(_id, SERVED))
def test_prefill_and_decode_match_reference(served, case):
    assert not ref.served_logits(*served[_id(case)])


@pytest.mark.parametrize("case", PREFILLED, ids=map(_id, PREFILLED))
def test_prefill_matches_reference(served, case):
    want, got = served[_id(case)]
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=1e-4,
                               rtol=1e-4)
    assert np.array_equal(got["prefill"].argmax(-1),
                          want["prefill"].argmax(-1))
    assert not ref.served_cache(want, got)


@pytest.mark.parametrize("case", PREFILLED, ids=map(_id, PREFILLED))
def test_cache_is_placed_as_the_reference_specs(served, case):
    mesh, arch, B, kw, _ = case
    got = served[_id(case)][1]
    placed = {k[len("placed/"):]: str(v) for k, v in got.items()
              if k.startswith("placed/")}
    assert placed == ref.cache_placements(arch, B, mesh, kw)
    # each rank holds its own chunk of k (an ssm model's state), the
    # chunks summing to the whole, where every mesh dim shards it
    # (falcon's state is replicated over "data": "inner" runs over
    # "model" alone, and the batch stays whole)
    leaf = placed["k" if "k" in placed else "ssm"]
    assert bool(got["k_chunks"]) == ("Replicate" not in leaf)


@pytest.mark.parametrize("case", PREFILLED, ids=map(_id, PREFILLED))
def test_decode_model_shares_the_prefill_parameters(served, case):
    assert bool(served[_id(case)][1]["shares"])


@pytest.mark.parametrize("case", PREFILLED, ids=map(_id, PREFILLED))
def test_the_explicit_projections_ran(served, case):
    """A prefill runs every explicit projection a forward has, and K7
    under ``local_map`` once an attention block; a decode step the
    explicit q and MLPs (``wo`` keeps the GSPMD form, the reference's
    plain einsum), and its attention on the sharded cache."""
    _, arch, _, _, refusal = case
    got = served[_id(case)][1]
    cfg = fx.smoke_cfg(arch)
    col, row = fx.explicit_projections(cfg)
    n = fx.attention_layers(cfg)
    steps = fx.SERVE_NEW if refusal is None else 0

    def count(phase, name):
        return int(got[f"{phase}_path/{name}"])

    assert (count("prefill", "explicit_col_project"),
            count("prefill", "explicit_row_project")) == (col, row)
    assert count("prefill", "_flash_attention_sharded") == n
    assert (count("decode", "explicit_col_project"),
            count("decode", "explicit_row_project")) == \
        (col * steps, (row - n) * steps)
    assert count("decode", "_decode_attention_sharded") == n * steps
    assert count("decode", "_flash_attention_sharded") == 0


@pytest.mark.parametrize("case", [c for c in CASES if c[4]],
                         ids=[_id(c) for c in CASES if c[4]])
def test_refused_where_the_reference_refuses(served, case):
    """Where the reference's shard_map raises, the port raises
    ``ValueError`` at the same step: the decode step's one token over a
    model axis of 2, the prefill's batch of 2 over 4 data ranks."""
    _, _, B, _, refusal = case
    got = served[_id(case)][1]
    assert "refused" in got, f"the {refusal} ran"
    msg = str(got["refused"])
    if refusal == "decode":
        assert "a sequence of 1 does not split over a model axis of 2" in msg
    else:
        assert f"a batch of {B} does not split over the data axes' 4" in msg
