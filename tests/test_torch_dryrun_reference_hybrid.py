"""The port's per-device dot FLOPs against the reference's, its hybrid
cells: the smoke zamba2-2.7b, a train and a decode step at (2, 2, 2)
(``fixtures_torch_dryrun``; bands ``fd.BANDS``, itemised in PERF.md
section 6: the train step's gap is K7's backward recompute, the
loss's recompute and the SSD's state update that a train step drops).
"""
import pytest

import fixtures_torch_dryrun as fd
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

ARCHS = ("zamba2-2.7b",)


@pytest.fixture(scope="module")
def flops():
    return fd.collect({side: fd.run_side(side, ARCHS)
                       for side in ("ref", "port")})


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k in fd.cells(ARCHS)])
def test_dot_flops_match_reference_within_band(flops, cell):
    fd.check_band(flops, cell)


def test_the_decode_step_matches_reference_by_phase(flops):
    """The decode step has no backward: every product is the forward's,
    on both sides, and their totals are equal."""
    cell = "zamba2-2.7b/decode"
    port = fd.phases(flops["port"][cell]["by_op"], "port")
    ref = fd.phases(flops["ref"][cell]["by_op"], "ref")
    assert set(port) == set(ref) == {"forward"}
    assert port["forward"] == ref["forward"]
