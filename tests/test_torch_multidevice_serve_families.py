"""Serving under ``plan_for``'s prefill and decode plans on the CPU, the
other families: one world of 4 processes over gloo at mesh (pod, data,
model) (1, 1, 4), against the reference's single-device ``prefill`` and
``decode_step`` (``fixtures_torch_multidevice_ref.served``), float32, as
``test_torch_multidevice_serve.py`` holds its cases.

At a global batch of 2 the cache's sequence runs over "model" alone (22
slots: 6, 6, 6, 4): gemma2-9b (a prompt of 18 past its smoke window of
16, so its local layers' rolling caches of 16 slots wrap; softcaps),
mixtral-8x7b (every layer windowed, moe), falcon-mamba-7b (no attention:
K8 under ``map_channels`` in prefill, the decode steps' scan and conv on
each rank's channels of the "inner"-sharded states), zamba2-2.7b (Mamba2
blocks and the shared attention block) and llama-3.2-vision-11b (its
gates opened; the media K/V cached replicated but for the batch).
"""
import pytest

import fixtures_torch_multidevice_ref as ref

MESH = (1, 1, 4)
CASES = [(arch, 2, None) for arch in (
    "gemma2-9b", "mixtral-8x7b", "falcon-mamba-7b", "zamba2-2.7b",
    "llama-3.2-vision-11b")]
IDS = [a for a, _, _ in CASES]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = ref.served(tmp_path_factory.mktemp("multidevice_serve_families"),
                     MESH, CASES)
    return dict(zip(IDS, out.values()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(served, case):
    assert not ref.served_logits(*served[case[0]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_cache_matches_reference(served, case):
    assert not ref.served_cache(*served[case[0]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cache_is_placed_as_the_reference_specs(served, case):
    arch, B, kw = case
    want, got = served[arch]
    assert not ref.served_placements((arch, B, MESH, kw), want, got)
    if arch == "falcon-mamba-7b":
        return
    # the sequence over "model": 22 slots as 6, 6, 6, 4 (mixtral's
    # rolling cache of 16 as 4 a rank)
    assert list(got["k_local"]) == ([4, 4] if arch == "mixtral-8x7b"
                                    else [4, 6])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_model_shares_the_prefill_parameters(served, case):
    assert bool(served[case[0]][1]["shares"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_sharded_paths_ran(served, case):
    assert not ref.served_paths(case[0], served[case[0]][1])
