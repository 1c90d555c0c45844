"""The port's join operators against the JAX reference, on the CPU.

The same numpy-seeded keys and values go through ``repro.kernels.ops``
(the Pallas kernels in interpret mode, as tests/test_kernels.py runs
them), ``repro.kernels.ref`` (the oracles) and the port's ``ops.bhj_join``
/ ``ops.smj_join``, kernel wrappers and plain versions (on CPU tensors the
wrappers take the plain versions).  Results are int32 and must be equal,
not close.

On primary-key joins with values >= -1 every path agrees.  On duplicate
build keys or values below -1 the Pallas kernels part from their own
oracles (the hash join's masked max fills with -1 and keeps the largest
match, the rank kernel keeps the last); the port follows the oracles: the
value of the first matching build row, whatever its sign.
``test_pallas_joins_diverge_from_oracles`` pins that fault of the
reference.

``repro_torch.kernels.join_cases`` holds the cases shaped to reach each
mode of the CUDA kernels (the hash join's dense array and table, the merge
join's staged and narrowed tiles); here they run through the port's CPU
path against the oracles, and through the Pallas kernels where those agree
with their oracles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import hash_join as hj
from repro_torch.kernels import join_cases as jc
from repro_torch.kernels import merge_join as mj
from repro_torch.kernels import ops, ref

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _port_results(probe, bkeys, bvals):
    """Every port path on the same inputs, as numpy arrays."""
    p, k, v = (torch.from_numpy(np.ascontiguousarray(x, np.int32))
               for x in (probe, bkeys, bvals))
    fns = {"ops.bhj_join": ops.bhj_join, "ops.smj_join": ops.smj_join,
           "bhj_join ref": lambda *a: ops.bhj_join(*a, impl="ref"),
           "smj_join ref": lambda *a: ops.smj_join(*a, impl="ref"),
           "hash_join": hj.hash_join, "merge_join": mj.merge_join,
           "hash_join_ref": ref.hash_join_ref,
           "merge_join_ref": ref.merge_join_ref}
    out = {}
    for name, fn in fns.items():
        got = fn(p, k, v)
        assert got.dtype == torch.int32 and got.shape == p.shape, name
        out[name] = got.numpy()
    return out


def _oracle(probe, bkeys, bvals, fn=rref.hash_join_ref):
    return np.asarray(fn(jnp.asarray(probe), jnp.asarray(bkeys),
                         jnp.asarray(bvals)))


def _assert_port_equals(probe, bkeys, bvals, want):
    for name, got in _port_results(probe, bkeys, bvals).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------- the join cases of tests/test_kernels.py ------------------ #

@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), r=st.sampled_from([128, 512]),
       s=st.sampled_from([256, 1024]))
def test_hypothesis_joins_match_reference(seed, r, s):
    """Random PK joins, empty-match and all-match regimes included: the
    port equals both Pallas kernels and both oracles."""
    rng = np.random.default_rng(seed)
    bkeys = np.sort(rng.choice(5000, size=r, replace=False)).astype(np.int32)
    bvals = (bkeys * 3 + 7).astype(np.int32)
    probe = rng.integers(0, 5000, size=s).astype(np.int32)
    want = _oracle(probe, bkeys, bvals)
    np.testing.assert_array_equal(
        _oracle(probe, bkeys, bvals, rref.merge_join_ref), want)
    for fn in (rops.bhj_join, rops.smj_join):
        np.testing.assert_array_equal(
            np.asarray(fn(jnp.asarray(probe), jnp.asarray(bkeys),
                          jnp.asarray(bvals), block_probe=128,
                          block_build=128)), want)
    _assert_port_equals(probe, bkeys, bvals, want)


def test_join_semantics_pk():
    bkeys = np.asarray([2, 5, 9], np.int32)
    bvals = np.asarray([20, 50, 90], np.int32)
    probe = np.asarray([5, 3, 9, 2, 11, 5, 9, 1], np.int32)
    want = np.array([50, -1, 90, 20, -1, 50, 90, -1])
    for fn in (rops.bhj_join, rops.smj_join):
        np.testing.assert_array_equal(
            np.asarray(fn(jnp.asarray(probe), jnp.asarray(bkeys),
                          jnp.asarray(bvals), block_probe=8,
                          block_build=1)), want)
    _assert_port_equals(probe, bkeys, bvals, want)


def test_join_multi_tile_build_side():
    """A build side spanning several of the reference's VMEM tiles."""
    rng = np.random.default_rng(0)
    bkeys = np.sort(rng.choice(100_000, size=4096, replace=False)) \
        .astype(np.int32)
    bvals = (bkeys + 1).astype(np.int32)
    probe = rng.integers(0, 100_000, size=2048).astype(np.int32)
    want = _oracle(probe, bkeys, bvals, rref.merge_join_ref)
    for fn in (rops.bhj_join, rops.smj_join):
        np.testing.assert_array_equal(
            np.asarray(fn(jnp.asarray(probe), jnp.asarray(bkeys),
                          jnp.asarray(bvals), block_probe=512,
                          block_build=1024)), want)
    _assert_port_equals(probe, bkeys, bvals, want)


# ------------- duplicate keys and negative values: the oracles ------------- #

DIVERGENT = (np.asarray([5, 9, 2, 3], np.int32),       # probe
             np.asarray([2, 5, 9, 9], np.int32),       # build keys
             np.asarray([20, -50, 90, 91], np.int32))  # build values


def test_port_follows_oracles_on_duplicates_and_negatives():
    want = [-50, 90, 20, -1]
    for fn in (rref.hash_join_ref, rref.merge_join_ref):
        np.testing.assert_array_equal(_oracle(*DIVERGENT, fn), want)
    _assert_port_equals(*DIVERGENT, want)


def test_pallas_joins_diverge_from_oracles():
    """The reference's own fault, kept as it is: its BHJ kernel fills the
    masked max with -1 (losing matched values below -1) and keeps the
    largest of duplicate matches, its SMJ rank keeps the last; both
    oracles, and the port, take the first match."""
    p, k, v = (jnp.asarray(x) for x in DIVERGENT)
    for bt in (2, 4):
        np.testing.assert_array_equal(
            np.asarray(rops.bhj_join(p, k, v, block_build=bt)),
            [-1, 91, 20, -1])
    np.testing.assert_array_equal(np.asarray(rops.smj_join(p, k, v)),
                                  [-50, 91, 20, -1])
    np.testing.assert_array_equal(ops.bhj_join(*map(torch.from_numpy,
                                                    DIVERGENT)).numpy(),
                                  [-50, 90, 20, -1])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_duplicates_and_negative_values_match_oracles(seed):
    """Many duplicate build keys, values over the whole int32 range: the
    port equals ``repro.kernels.ref`` on sorted build sides (both joins)
    and, for the hash join, on unsorted ones."""
    rng = np.random.default_rng(seed)
    R, S = int(rng.integers(1, 300)), int(rng.integers(0, 500))
    bkeys = rng.integers(-40, 40, size=R).astype(np.int32)
    bvals = rng.integers(INT32_MIN, INT32_MAX, size=R, dtype=np.int64) \
        .astype(np.int32)
    probe = rng.integers(-50, 50, size=S).astype(np.int32)
    want = _oracle(probe, bkeys, bvals)
    p, k, v = (torch.from_numpy(x) for x in (probe, bkeys, bvals))
    for fn in (hj.hash_join, ref.hash_join_ref, ops.bhj_join):
        np.testing.assert_array_equal(fn(p, k, v).numpy(), want)
    order = np.argsort(bkeys, kind="stable")
    sk, sv = bkeys[order], bvals[order]
    want = _oracle(probe, sk, sv, rref.merge_join_ref)
    np.testing.assert_array_equal(_oracle(probe, sk, sv), want)
    _assert_port_equals(probe, sk, sv, want)


# ------------------------------- edge cases -------------------------------- #

EDGE_CASES = {
    "int-min-max": ([INT32_MAX, INT32_MIN, 7, -1, 0, INT32_MIN + 1],
                    [INT32_MIN, -1, 0, INT32_MAX], [1, 2, 3, 4]),
    "s0": ([], [1, 2, 3], [4, 5, 6]),
    "r1": ([4, 3, 4, INT32_MIN], [4], [-7]),
    "ragged": (list(range(-3, 1000, 7)), list(range(0, 999, 3)),
               list(range(333))),
    "all-miss": ([1, 3, 5], [2, 4, 6], [0, 0, 0]),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_cases_match_oracles(name):
    """Lengths the reference's tiled kernels refuse: held against its
    oracles only."""
    probe, bkeys, bvals = (np.asarray(x, np.int32)
                           for x in EDGE_CASES[name])
    want = _oracle(probe, bkeys, bvals)
    np.testing.assert_array_equal(
        _oracle(probe, bkeys, bvals, rref.merge_join_ref), want)
    _assert_port_equals(probe, bkeys, bvals, want)


def test_empty_build_side_misses_everything():
    probe = np.asarray([0, INT32_MIN, INT32_MAX], np.int32)
    empty = np.zeros(0, np.int32)
    _assert_port_equals(probe, empty, empty, [-1, -1, -1])


@pytest.mark.parametrize("bad", ["int64-probe", "int64-build", "float-vals",
                                 "2-d", "length-mismatch"])
def test_bad_inputs_raise(bad):
    p = torch.tensor([1, 2], dtype=torch.int32)
    k = torch.tensor([1, 2, 3], dtype=torch.int32)
    v = torch.tensor([4, 5, 6], dtype=torch.int32)
    args = {"int64-probe": (p.long(), k, v), "int64-build": (p, k.long(), v),
            "float-vals": (p, k, v.float()), "2-d": (p[None], k, v),
            "length-mismatch": (p, k, v[:2])}[bad]
    for fn in (ops.bhj_join, ops.smj_join, hj.hash_join, mj.merge_join,
               ref.hash_join_ref, ref.merge_join_ref):
        with pytest.raises(ValueError, match="int32"):
            fn(*args)


def test_unsupported_device_raises_without_fallback():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises."""
    p = torch.zeros(4, dtype=torch.int32, device="meta")
    k = torch.zeros(2, dtype=torch.int32, device="meta")
    for fn in (ops.bhj_join, ops.smj_join):
        with pytest.raises(ValueError, match="unsupported devices"):
            fn(p, k, k)


def test_cpu_path_launches_nothing():
    before = (hj.hash_join.launches, mj.merge_join.launches)
    _port_results(*DIVERGENT)
    assert (hj.hash_join.launches, mj.merge_join.launches) == before
    with pytest.raises(ValueError, match="impl"):
        ops.bhj_join(*map(torch.from_numpy, DIVERGENT), impl="pallas")


@pytest.mark.parametrize("R,slots", [(0, 2), (1, 2), (2, 4), (3, 8),
                                     (1_000_000, 1 << 21)])
def test_hash_table_size(R, slots):
    """A power of two with load factor at most 1/2 (at R = 1M, 16 MB of
    64-bit slots, which the card's 50 MB L2 holds)."""
    assert hj.table_slots(R) == slots


def test_dense_slots():
    """The dense array takes the table's memory as 32-bit words: twice its
    slots, so s_suppkey's 1..1M at R = 1M fits (4M words)."""
    for R in (0, 1, 2, 3, 1_000, 1_000_000):
        assert hj.dense_slots(R) == 2 * hj.table_slots(R)
    assert hj.dense_slots(1_000_000) == 1 << 22


# --------------- the kernels' modes: join_cases, on the CPU ---------------- #

JOIN_CASES = jc.join_cases()


def _pallas_agrees(probe, bkeys, bvals) -> bool:
    """Where the reference's Pallas joins equal their oracles and take the
    lengths: distinct build keys, values >= -1, lengths that divide their
    default tiles (1024 probes, 2048 build rows)."""
    S, R = probe.size, bkeys.size
    return (np.unique(bkeys).size == R and bvals.min() >= -1 and
            (S <= 1024 or S % 1024 == 0) and (R <= 2048 or R % 2048 == 0))


# the reference's hash-join oracle compares every probe with every build
# key; above this many pairs its sort-merge oracle on the stably sorted
# build side stands in (the same first-row answers: the smaller cases
# check that the two agree)
COMPARE_PAIRS = 10 ** 8


@pytest.mark.parametrize("name", sorted(JOIN_CASES))
def test_join_cases_match_oracles(name):
    """Each case the CUDA kernels' modes are shaped by: the hash join on
    the build side as it is, the merge join on it stably sorted; both
    equal to ``repro.kernels.ref``'s oracles."""
    probe, bkeys, bvals = JOIN_CASES[name]
    sk, sv = jc.sorted_build(bkeys, bvals)
    want = _oracle(probe, sk, sv, rref.merge_join_ref)
    if probe.size * bkeys.size <= COMPARE_PAIRS:
        np.testing.assert_array_equal(_oracle(probe, bkeys, bvals), want)
        np.testing.assert_array_equal(_oracle(probe, sk, sv), want)
    p, k, v = (torch.from_numpy(x) for x in (probe, bkeys, bvals))
    for fn in (hj.hash_join, ref.hash_join_ref, ops.bhj_join):
        np.testing.assert_array_equal(fn(p, k, v).numpy(), want)
    _assert_port_equals(probe, sk, sv, want)
    if _pallas_agrees(probe, bkeys, bvals):
        for fn in (rops.bhj_join, rops.smj_join):
            np.testing.assert_array_equal(
                np.asarray(fn(jnp.asarray(probe), jnp.asarray(sk),
                              jnp.asarray(sv))), want)


def test_join_cases_reach_every_mode():
    """The case set reaches the hash join's dense array and table, and the
    merge join's staged and narrowed tiles, each more than once; and the
    Pallas kernels run on some of it."""
    seen = {"hash_join": [], "merge_join": []}
    for probe, bkeys, _ in JOIN_CASES.values():
        for op, got in jc.modes(probe, bkeys).items():
            seen[op] += sorted(got)
    assert sorted(set(seen["hash_join"])) == ["dense", "hash"]
    assert sorted(set(seen["merge_join"])) == ["narrowed", "staged"]
    for op, got in seen.items():
        assert all(got.count(m) >= 2 for m in set(got)), (op, got)
    assert sum(_pallas_agrees(*c) for c in JOIN_CASES.values()) >= 3


def test_join_case_shapes():
    """The shapes the cases promise: a -1 key whose first value is -1 among
    keys that start at its slot; a key range of 2^32; tile ranges of
    exactly STAGE and STAGE + 1 build keys; an S that is not a multiple of
    the 16-byte width."""
    probe, bkeys, bvals = JOIN_CASES["key -1, value -1, colliding keys"]
    mask = np.uint32(hj.table_slots(bkeys.size) - 1)
    start = jc.mix32(np.asarray([-1], np.int32)) & mask
    assert bvals[np.flatnonzero(bkeys == -1)[0]] == -1
    assert ((jc.mix32(bkeys) & mask) == start).sum() >= 20
    probe, bkeys, _ = JOIN_CASES["INT_MIN and INT_MAX"]
    assert int(bkeys.max()) - int(bkeys.min()) + 1 == 2 ** 32
    probe, bkeys, _ = JOIN_CASES["tile range at the budget, and one over"]
    spans = jc.tile_spans(torch.from_numpy(probe), torch.from_numpy(bkeys))
    assert spans.tolist() == [mj.STAGE, mj.STAGE + 1]
    assert JOIN_CASES["S not a multiple of 4"][0].size % 4
