"""The port's per-device dot FLOPs against the reference's (the twin of
``test_system.py``'s ``test_multi_device_lowering_subprocess``), its
dense and moe cells: the smoke smollm-360m and mixtral-8x7b, a train and
a decode step at (2, 2, 2) (``fixtures_torch_dryrun``): the reference's
``hlo_analysis.analyze(...).dot_flops`` in a process with 8 forced host
devices beside the port's ``StepStats.dot_flops`` over a fake world of 8
(``launch.dryrun``'s trace of rank 0).  Each ratio lies in its band
(``fd.BANDS``, itemised in PERF.md section 6); the ssm and hybrid
cells are ``test_torch_dryrun_reference_{ssm,hybrid}.py``'s.
"""
import pytest

import fixtures_torch_dryrun as fd
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

ARCHS = ("smollm-360m", "mixtral-8x7b")


@pytest.fixture(scope="module")
def flops():
    return fd.collect({side: fd.run_side(side, ARCHS, again=True)
                       for side in ("ref", "port")})


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k in fd.cells(ARCHS)])
def test_dot_flops_match_reference_within_band(flops, cell):
    fd.check_band(flops, cell)


def test_the_forward_matches_reference(flops):
    """smollm's forward (outside the backward) computes exactly the reference's
    products; its gap is in the backward (PERF.md's itemisation)."""
    cell = "smollm-360m/train"
    port = fd.phases(flops["port"][cell]["by_op"], "port")
    ref = fd.phases(flops["ref"][cell]["by_op"], "ref")
    assert port["forward"] == ref["forward"]


def test_a_second_trace_counts_the_same(flops):
    """smollm-360m's train cell, traced first (while DTensor's caches warm,
    its sharding propagation running the global ops on the fake mode) and
    again in the same process, counts the same dot FLOPs, traffic and
    collectives."""
    first = flops["port"]["smollm-360m/train"]
    again = flops["port"]["smollm-360m/train/again"]
    assert first == again
