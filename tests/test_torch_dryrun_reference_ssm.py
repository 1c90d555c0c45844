"""The port's per-device dot FLOPs against the reference's, its ssm
cells: the smoke falcon-mamba-7b, a train and a decode step at (2, 2,
2), as ``test_torch_dryrun_reference.py`` holds the dense and moe ones
and ``test_torch_dryrun_reference_hybrid.py`` the hybrid's
(``fixtures_torch_dryrun``; bands ``fd.BANDS``, itemised in PERF.md
section 6).
"""
import pytest

import fixtures_torch_dryrun as fd
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

ARCHS = ("falcon-mamba-7b",)


@pytest.fixture(scope="module")
def flops():
    return fd.collect({side: fd.run_side(side, ARCHS)
                       for side in ("ref", "port")})


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k in fd.cells(ARCHS)])
def test_dot_flops_match_reference_within_band(flops, cell):
    fd.check_band(flops, cell)


def test_the_forward_matches_reference(flops):
    """falcon's forward (outside the backward) computes exactly the reference's
    products; its gap is in the backward (PERF.md's itemisation)."""
    cell = "falcon-mamba-7b/train"
    port = fd.phases(flops["port"][cell]["by_op"], "port")
    ref = fd.phases(flops["ref"][cell]["by_op"], "ref")
    assert port["forward"] == ref["forward"]
