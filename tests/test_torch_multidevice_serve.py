"""Serving under ``plan_for``'s prefill and decode plans on the CPU: one
world of 4 processes over gloo at mesh (pod, data, model) (1, 2, 2)
(``fixtures_torch_multidevice.serve_worker``), held against the
reference's single-device ``prefill`` and ``decode_step``
(``fixtures_torch_multidevice_ref.served``) at the reference's
parameters (``load_jax_params``), float32.

Cases: smollm-360m at a global batch of 2, below ``serve_plan``'s cut at
16, where the batch stays whole and the cache's sequence ("kv_seq") runs
over ("data", "model"), nested; smollm at 16 with
``serve_weight_mode="gathered"``, where the batch runs over "data",
"kv_seq" over "model" and the parameters' "embed" over "data";
qwen3-moe-30b-a3b at 2 (token-replicated dispatch, experts over
"model") and at 16 with groups of 25 tokens (prefill: 288 tokens in 12
groups, the last padded, split over every axis; decode: the batch over
"data", the tokens replicated), musicgen-medium (frame embeddings)
at 2, smollm at 2 with its own positions (``fx.VARIANTS``: its first
row's prompt left-padded by 5, K7 masking by the positions under
``local_map``, each row decoding from its own next position) and the
Mamba1 hybrid (zamba2's smoke config with ``ssm_version=1``: K8 over
each rank's channels) at 2.  Each prefills a prompt of 18
into a cache of 22 slots (no mesh of 4 splits 22 evenly) and takes 4
decode steps, each fed the reference's greedy token (musicgen: seeded
frames); the decode model runs over the prefill model's parameter
tensors (``Model.with_plan``).  The moe oracle: the reference's prefill
aims its groups at the world's size, its decode at 1, as the plans do,
both with the case's ``moe_group_size``.

- **Logits**: prefill within 1e-4, each decode step within 1e-3 (atol
  and rtol, ``test_torch_serve.py``'s), greedy tokens equal.
- **The prefill cache**, gathered, within 1e-5 of the reference's in the
  port's flat names.
- **Placements**: every cache leaf as the reference's ``cache_specs``;
  each rank's chunk of ``k`` shorter than the whole, the chunks summing
  to it.
- **Parameters**: the decode model holds the prefill model's tensors.
- **The sharded paths**: K7 under ``local_map`` once a layer in prefill,
  decode attention and the cache writes on the sharded cache.

The card's twin is ``test_torch_cuda.py::test_serve_plans_on_the_card``.
"""
import pytest

import fixtures_torch_multidevice_ref as ref

MESH = (1, 2, 2)
GATHERED = {"serve_weight_mode": "gathered"}
# groups of 25 of the 288 prefill tokens at B=16: 12 groups, the last
# padded, so they do not follow the batch's shards
GROUPS = {"moe_group_size": 25}
CASES = [("smollm-360m", 2, None), ("smollm-360m", 16, GATHERED),
         ("qwen3-moe-30b-a3b", 2, None), ("qwen3-moe-30b-a3b", 16, GROUPS),
         ("musicgen-medium", 2, None), ("smollm-360m-leftpad", 2, None),
         ("zamba2-2.7b-mamba1", 2, None)]
IDS = [f"{a}-B{b}" + "".join(f"-{k}-{v}" for k, v in (kw or {}).items())
       for a, b, kw in CASES]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = ref.served(tmp_path_factory.mktemp("multidevice_serve"), MESH,
                     CASES)
    return dict(zip(IDS, out.values()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(served, case):
    assert not ref.served_logits(*served[IDS[CASES.index(case)]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_cache_matches_reference(served, case):
    assert not ref.served_cache(*served[IDS[CASES.index(case)]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cache_is_placed_as_the_reference_specs(served, case):
    arch, B, kw = case
    want, got = served[IDS[CASES.index(case)]]
    assert not ref.served_placements((arch, B, MESH, kw), want, got)
    # B=2: the sequence over ("data", "model"), 22 slots nested 6, 5, 6, 5
    # over the ranks; B=16: the batch over "data", 11 slots a rank
    assert list(got["k_local"]) == ([5, 6] if B == 2 else [11, 11])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_model_shares_the_prefill_parameters(served, case):
    assert bool(served[IDS[CASES.index(case)]][1]["shares"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_sharded_paths_ran(served, case):
    assert not ref.served_paths(case[0], served[IDS[CASES.index(case)]][1])
