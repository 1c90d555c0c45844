"""Faults of the port that the dry run's comparison with the reference
found in zamba2-2.7b's smoke train cell at (2, 2, 2) (ROADMAP §3, PERF.md
§6): products the port computes and the reference does not.  Each test
measures its fault's dot FLOPs a device in rank 0's traced step
(``fixtures_torch_dryrun.products``) and holds them equal to the
fault's ``FAULTS`` entry, which ``check_band`` takes out of the cell's
count before its band; when a fault is repaired its test changes with
it, and its entry goes.  falcon-mamba's x_proj fault is
``test_torch_dryrun.py``'s.

The reference's side, from its compiled HLO for the same cell
(``fixtures_torch_dryrun``'s breakdown by op): its ``btn,bsn->bts`` dots
(C.B^T) count 786,432 a device in the forward, half the port's
1,572,864 (GSPMD splits the chunk's rows over "model"); its forward and
its rematerialised forward hold no ``bch,bcn,bchp->bhpn`` dot (the
state update); its backward takes the in_proj_bc product's transpose on
the rank's half of B's and C's columns.
"""
import pytest

import fixtures_torch_dryrun as fd
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

CELL = "zamba2-2.7b/train"
TP = 2                                  # the model axis of (2, 2, 2)


@pytest.fixture(scope="module")
def traced():
    return fd.products("zamba2-2.7b")


@pytest.fixture(scope="module")
def cfg():
    from repro_torch.configs import REGISTRY
    return REGISTRY["zamba2-2.7b"].smoke()


def test_in_proj_bc_backward_takes_both_halves(traced, cfg):
    """B's and C's projection (``in_proj_bc``, (d_model, 2N), its columns
    over "model") runs its forward on the rank's N columns, but its
    backward (d x and the weight's gradient) on all 2N: DTensor gathers
    the weight, as it does falcon's x_proj.  The backward products of
    width 2N less those of the rematerialised k and v projections of the
    same width (two each) are B's and C's; half of them is the fault."""
    dots, _ = traced
    d, n2 = cfg.d_model, 2 * cfg.ssm_state
    T = fd.BATCH // 4 * fd.SEQ                 # the rank's tokens
    wide = ((T, n2), (n2, d)), ((d, T), (T, n2))
    bwd = sum(f for k, f in dots.items() if k[0] and k[3:] in wide)
    kv = sum(f for k, f in dots.items()
             if k[0] and k[1] == "bwd models.transformer._qkv" and
             k[3:] == ((T, d), (d, n2)))
    half = ((T, n2 // 2), (n2 // 2, d)), ((d, T), (T, n2 // 2))
    assert not any(k[0] and k[3:] in half for k in dots)
    assert (bwd - 2 * kv) * (1 - 1 / TP) == \
        fd.FAULTS[CELL]["in_proj_bc backward whole"]


def test_ssd_computes_cb_whole_on_each_model_rank(traced, cfg):
    """The SSD's C.B^T (``btn,bsn->bts``) is shared by the heads, and each
    rank of "model" computes all of it for its own heads, where GSPMD
    splits its rows over "model" (module docstring).  Its FLOPs: each
    forward, each rematerialised forward and that one's two backward
    products (dC, dB) of the same size; the fault is their (1 - 1/tp)."""
    _, sums = traced
    calls = {k: f for k, f in sums.items() if k[1] == "btn,bsn->bts"}
    chunk = min(128, fd.SEQ)
    assert calls and all(k[2][0][1] == chunk for k in calls)
    fwd = sum(f for k, f in calls.items() if not k[0])
    remat = sum(f for k, f in calls.items() if k[0])
    assert fwd == remat > 0
    assert (fwd + 3 * remat) * (1 - 1 / TP) == \
        fd.FAULTS[CELL]["ssd C.B^T whole"]


def test_ssd_computes_the_state_update_a_train_step_drops(traced):
    """At S = 64 the SSD runs one chunk, so its state update
    (``bchp,bcn->bhpn``) is the last chunk's, whose state a train step
    drops: the reference's compiler removes it from the forward and the
    rematerialised forward, eager torch computes it in both.  (The
    reference's backward then takes its transpose, which the port's
    autograd skips: PERF.md's itemisation counts that on the reference's
    side.)"""
    _, sums = traced
    calls = {k: f for k, f in sums.items() if k[1] == "bchp,bcn->bhpn"}
    assert calls and all(k[2][1][1] == fd.SEQ for k in calls)
    assert sum(calls.values()) == \
        fd.FAULTS[CELL]["ssd dropped state update"]
