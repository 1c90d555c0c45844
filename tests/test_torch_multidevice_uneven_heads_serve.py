"""Serving with heads that the model axis does not divide, on the CPU:
a gloo world of 2 processes with the model axis 2
(``fixtures_torch_multidevice``), the smoke smollm-360m at 3 q heads over
1 KV head (``fx.VARIANTS["smollm-360m-3heads"]``), against the
reference's single device (``fixtures_torch_multidevice_ref.served``),
float32; the training side is
``test_torch_multidevice_uneven_heads.py``, whose docstring has the
reference's shard_map behaviour this pins.

A prompt of 18 into 22 slots, then 4 decode steps, under the prefill and
decode plans (GSPMD), at ``test_torch_multidevice_serve.py``'s
tolerances; under shard_map the prefill, and the refusal of its first
decode step.
"""
import numpy as np
import pytest

import fixtures_torch_multidevice_ref as ref

ARCH = "smollm-360m-3heads"
MESH = (1, 1, 2)
SM = {"tp_mode": "shard_map"}
SERVE = [(ARCH, 2, None), (ARCH, 2, SM, "decode")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return ref.served(tmp_path_factory.mktemp("multidevice_uneven_serve"),
                      [(MESH, SERVE)])[0]


def test_prefill_and_decode_match_reference(served):
    assert not ref.served_logits(*served[f"{ARCH}-B2"])


@pytest.mark.parametrize("tag", [f"{ARCH}-B2", f"{ARCH}-B2-shard_map"],
                         ids=["gspmd", "shard_map"])
def test_prefill_matches_reference(served, tag):
    want, got = served[tag]
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=1e-4,
                               rtol=1e-4)
    assert np.array_equal(got["prefill"].argmax(-1),
                          want["prefill"].argmax(-1))
    assert not ref.served_cache(want, got)


def test_shard_map_decode_is_refused(served):
    """The first shard_map decode step raises ``ValueError``, as the
    reference's ``shard_map`` does on a model axis of 2."""
    got = served[f"{ARCH}-B2-shard_map"][1]
    assert "model" in str(got["refused"])
