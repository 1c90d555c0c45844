"""The join kernels' edge cases, one set for the CPU tests, the card tests
and ``chip_smoke.py``: numpy arrays from a seed, each case shaped to reach
one mode of the kernels in ``csrc/hash_join.cu`` and ``csrc/merge_join.cu``
(``modes`` says which), or one edge of the contract.

A case is (probe keys, build keys, build values), int32.  The build keys
are not sorted: the hash join takes them as they are; the merge join takes
them after a stable sort, values following (``sorted_build``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.hash_join import dense_slots, table_slots
from repro_torch.kernels.merge_join import STAGE, TILE

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1

Case = Tuple[np.ndarray, np.ndarray, np.ndarray]


def mix32(k: np.ndarray) -> np.ndarray:
    """The hash join's slot hash (murmur3's finalizer) of int32 keys."""
    k = k.astype(np.int32).view(np.uint32).astype(np.uint64)
    m = np.uint64(0xFFFFFFFF)
    k ^= k >> np.uint64(16)
    k = (k * np.uint64(0x85EBCA6B)) & m
    k ^= k >> np.uint64(13)
    k = (k * np.uint64(0xC2B2AE35)) & m
    k ^= k >> np.uint64(16)
    return k.astype(np.uint32)


def sorted_build(keys: np.ndarray, vals: np.ndarray):
    """The build side as the merge join takes it: keys ascending, values
    following, equal keys in their first order."""
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def takes_dense(keys: torch.Tensor) -> bool:
    """Whether the hash join builds its direct-addressed array for these
    build keys (their range fits ``dense_slots(R)`` words), as the kernel
    decides on the device."""
    return keys.numel() > 0 and \
        int(keys.max()) - int(keys.min()) + 1 <= dense_slots(keys.numel())


def tile_spans(probe: torch.Tensor, sorted_keys: torch.Tensor):
    """For each merge-join tile of ``TILE`` consecutive probe keys, the
    number of build keys in its [min, max]: the tile stages them when
    there are at most ``STAGE``."""
    n = probe.numel() // TILE * TILE
    ends = [(t.min(1).values, t.max(1).values) for t in (
        probe[:n].view(-1, TILE), probe[n:].view(1, -1)) if t.numel()]
    if not ends:
        return torch.zeros(0, dtype=torch.int64)
    return torch.searchsorted(sorted_keys, torch.cat([e[1] for e in ends]),
                              right=True) - \
        torch.searchsorted(sorted_keys, torch.cat([e[0] for e in ends]))


def modes(probe: np.ndarray, keys: np.ndarray) -> Dict[str, set]:
    """The modes the kernels take on this case: the hash join's "dense"
    array or "hash" table; the merge join's tiles "staged" in shared
    memory or "narrowed" (each probe's own search)."""
    probe, keys = torch.from_numpy(probe), torch.from_numpy(keys)
    spans = tile_spans(probe, torch.sort(keys).values)
    return {"hash_join": {"dense" if takes_dense(keys) else "hash"},
            "merge_join": {"staged" if int(n) <= STAGE else "narrowed"
                           for n in spans}}


def join_cases(seed: int = 0) -> Dict[str, Case]:
    rng = np.random.default_rng(seed)

    def ints(n, lo, hi):                    # [lo, hi), int32
        return rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)

    def i32(xs):
        return np.asarray(xs, np.int64).astype(np.int32)

    cases: Dict[str, Case] = {}
    # a dense primary key (s_suppkey 1..R), probes missing on both sides
    R = 8192
    cases["dense"] = (ints(4096, -8, R + 8),
                      rng.permutation(np.arange(1, R + 1, dtype=np.int32)),
                      ints(R, -1, INT32_MAX))
    cases["dense, duplicates"] = (ints(10_007, -5, 3_005),
                                  ints(6_001, 0, 3_000),
                                  ints(6_001, INT32_MIN, INT32_MAX))
    # distinct keys over 2^31: the table
    keys = rng.permutation(np.unique(ints(6_000, -2 ** 30, 2 ** 30))[:4096])
    cases["sparse"] = (rng.permutation(np.concatenate(
        [keys[:1024], ints(1024, -2 ** 30, 2 ** 30)])), keys,
        ints(4096, -1, INT32_MAX))
    # max - min + 1 = 2^32: overflows int32, takes the table
    keys = np.concatenate([ints(1_001, INT32_MIN, INT32_MAX),
                           i32([INT32_MAX, INT32_MIN, INT32_MIN])])
    cases["INT_MIN and INT_MAX"] = (
        np.concatenate([i32([INT32_MIN, INT32_MAX, INT32_MIN + 1,
                             INT32_MAX - 1]), keys[:500],
                        ints(500, INT32_MIN, INT32_MAX)]),
        keys, ints(keys.size, INT32_MIN, INT32_MAX))
    # key -1 with value -1 among keys that start at -1's slot: the table
    # (INT_MIN, INT_MAX) and the dense array
    cand = ints(200_000, INT32_MIN, INT32_MAX)
    R = 48
    mask = np.uint32(table_slots(R) - 1)
    same = cand[(mix32(cand) & mask) == (mix32(i32([-1])) & mask)]
    keys = np.concatenate([i32([INT32_MIN, -1, INT32_MAX]), same[:20],
                           i32([-1]), same[:4], ints(R - 28, -99, 99)])
    vals = ints(R, INT32_MIN, INT32_MAX)
    vals[1], vals[23] = -1, 5               # -1's first row has value -1
    cases["key -1, value -1, colliding keys"] = (
        np.concatenate([i32([-1, -1, INT32_MIN]), same[:30], keys]),
        keys, vals)
    keys = ints(40, -3, 4)
    vals = ints(40, INT32_MIN, INT32_MAX)
    vals[keys == -1] = -1
    cases["key -1, value -1, dense"] = (ints(101, -5, 6), keys, vals)
    # lineitem x orders in small: dbgen's sparse order keys, 1-7 lines an
    # order, clustered by order, ~half the orders kept
    i = np.arange(20_000)
    okey = (32 * (i // 8) + i % 8 + 1).astype(np.int32)
    probe = np.repeat(okey, rng.integers(1, 8, i.size))
    keys = okey[rng.random(i.size) < 0.48]
    cases["clustered"] = (probe, keys, ints(keys.size, 1, 1 << 20))
    # the same at 1M orders: ~2,000 tiles, more than the card's blocks, so
    # each block takes a run of tiles and predicts each range from the
    # last; a reversed and a shuffled stretch make the prediction miss
    i = np.arange(1_000_000)
    okey = (32 * (i // 8) + i % 8 + 1).astype(np.int32)
    probe = np.repeat(okey, rng.integers(1, 8, i.size))
    probe[1_000_000:1_200_000] = probe[1_000_000:1_200_000][::-1]
    rng.shuffle(probe[2_000_000:2_100_000])
    keys = okey[rng.random(i.size) < 0.48]
    cases["clustered, runs of tiles"] = (probe, keys,
                                         ints(keys.size, 1, 1 << 20))
    # random probes: every tile's range is over the budget
    cases["scattered"] = (ints(4_099, INT32_MIN, INT32_MAX),
                          ints(20_000, INT32_MIN, INT32_MAX),
                          ints(20_000, INT32_MIN, INT32_MAX))
    # tile 0 spans exactly STAGE build keys, tile 1 one more
    keys = np.arange(3 * STAGE, dtype=np.int32)
    t0, t1 = ints(TILE, 0, STAGE), ints(TILE, 10, 11 + STAGE)
    t0[[0, 1]], t1[[0, 1]] = (0, STAGE - 1), (10, 10 + STAGE)
    cases["tile range at the budget, and one over"] = (
        np.concatenate([t0, t1]), keys, (3 * keys + 7).astype(np.int32))
    keys = np.concatenate([np.arange(10_000, dtype=np.int32),
                           np.full(9, 4321, np.int32)])
    cases["all probes equal"] = (np.full(5_000, 4321, np.int32), keys,
                                 ints(keys.size, INT32_MIN, INT32_MAX))
    keys = np.concatenate([ints(3_000, -500, 500),
                           np.full(STAGE + 1, 77, np.int32)])
    cases["all probes equal, over the budget"] = (
        np.full(TILE + 1, 77, np.int32), keys,
        ints(keys.size, INT32_MIN, INT32_MAX))
    cases["S not a multiple of 4"] = (ints(TILE + 5, 0, 700),
                                      ints(600, 0, 700),
                                      ints(600, INT32_MIN, INT32_MAX))
    return cases
