"""Serving under the serve plans, without devices: the placements and
specs of a sequence-sharded cache against the reference's, the decode
inputs' stand-ins, the parameter-sharing check, and the cache write and
decode attention of one rank's chunk of a cache at an uneven length
against the one-device functions.

- ``ParallelPlan.placements`` of "kv_seq": the reference's spec on both
  meshes of ``test_torch_parallel_plans.py`` (stand-ins), below and at or
  above ``serve_plan``'s small-batch cut of 16, as ``Shard`` on each of
  its axes in mesh order (data-major, as jax's tuple assignment nests).
- ``cache_specs``: every arch's, at global batch 2 and 32, on both
  meshes, under the prefill and the decode plan, leaf for leaf against
  the reference's ``Model.cache_specs()`` (its nested names mapped to the
  port's flat ones, compared from the batch axis on).
- ``decode_input_specs``: shapes and dtypes against the reference's, the
  cache mapped as above (the port's index leaves ``slot_pos`` and ``pos``
  are int64, torch's index dtype, the reference's int32).
- ``check_shared_params``: the prefill and decode plans place every
  parameter alike; a train plan, the "gathered" weight mode, another
  mesh, or a single-device model's ``with_plan`` of an enabled plan
  raise ``ValueError``.
- ``shard_range``: 22 slots over one mesh dim of 4 (6, 6, 6, 4) and over
  2 x 2 (nested, 6, 5, 6, 5).  ``write_chunk`` on each chunk (the decode
  write of one position a row, clamped on the global length, and the
  prefill write, full and rolling) equals ``write_cache`` on the whole
  cache; ``_decode_attend`` on four chunks whose reductions meet in a
  world of threads equals ``decode_attention`` (float32 within 1e-6,
  bfloat16 caches within 2e-2), an empty chunk included.
"""
import dataclasses
import functools
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax
from repro.configs import REGISTRY as RREGISTRY
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.launch.specs import decode_input_specs as rdecode_input_specs
from repro.launch.specs import plan_for as rplan_for
from repro.models import build_model as rbuild
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.specs import decode_input_specs, plan_for
from repro_torch.models import attention as attn
from repro_torch.models.model import (build_model, cache_layout,
                                      cache_specs, check_shared_params)
from repro_torch.sharding import shard_range, single_device_plan

MESHES = {("data", "model"): (16, 16),
          ("pod", "data", "model"): (2, 16, 16)}
BATCHES = (2, 32)
KINDS = ("prefill", "decode")
SEQ = 4096


def _meshes(axes):
    sizes = MESHES[axes]
    return (SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes))),
            SimpleNamespace(mesh_dim_names=axes, shape=sizes))


def _plans(arch, kind, axes, B, **kw):
    rmesh, mesh = _meshes(axes)
    shape = (kind, SEQ, B, kind)
    return (rplan_for(RREGISTRY[arch], RShapeConfig(*shape), rmesh, **kw),
            plan_for(REGISTRY[arch], ShapeConfig(*shape), mesh, **kw))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _port_name(key):
    """The port's flat name of a reference cache leaf's path."""
    *top, name = key.split("/")
    return name + ("_local" if top == ["local"] else "")


@pytest.mark.parametrize("axes", list(MESHES), ids=["2d", "3d"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("kind", KINDS)
def test_kv_seq_placements_match_reference_spec(axes, B, kind):
    rplan, plan = _plans("smollm-360m", kind, axes, B)
    spec = plan.spec(("kv_seq",))
    assert spec == tuple(rplan.spec(("kv_seq",)))
    seq = spec[0]
    data = tuple(a for a in axes if a != "model")
    assert seq == (data + ("model",) if B < 16 else "model")
    seq = (seq,) if isinstance(seq, str) else seq
    placed = plan.placements((None, "batch", "kv_seq", "kv_heads", None))
    batch = plan.rule("batch")
    batch = () if batch is None else (batch,) if isinstance(batch, str) \
        else batch
    assert placed == [Shard(2) if a in seq else
                      Shard(1) if a in batch else Replicate() for a in axes]


CASES = [(arch, kind, axes, B) for arch in sorted(REGISTRY)
         for kind in KINDS for axes in MESHES for B in BATCHES]


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"{c[0]}-{c[1]}-{len(c[2])}d-B{c[3]}"))
def test_cache_specs_match_reference(case):
    arch, kind, axes, B = case
    rplan, plan = _plans(arch, kind, axes, B)
    want = {_port_name(k): tuple(v) for k, v in
            _flat(rbuild(RREGISTRY[arch], rplan).cache_specs())}
    got = cache_specs(REGISTRY[arch], plan)
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        # the port's one layer axis against the reference's stacked ones
        n = len(spec) - (name != "pos")
        assert spec[len(spec) - n:] == want[name][len(want[name]) - n:], \
            name
        assert all(a is None for a in spec[:len(spec) - n]), name


SMOKE = ["smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
         "zamba2-2.7b", "mixtral-8x7b", "gemma2-9b", "llama-3.2-vision-11b",
         "musicgen-medium"]


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_input_specs_match_reference(arch):
    rcfg = dataclasses.replace(RREGISTRY[arch].smoke(), dtype="bfloat16")
    cfg = dataclasses.replace(REGISTRY[arch].smoke(), dtype="bfloat16")
    shape = ("d", 40, 3, "decode")
    rin, rcache, rq = rdecode_input_specs(rcfg, RShapeConfig(*shape),
                                          rbuild(rcfg))
    model = build_model(cfg, device="cpu")
    inputs, cache, q_pos = decode_input_specs(cfg, ShapeConfig(*shape),
                                              model)
    assert model.cache_specs() == cache_specs(cfg, single_device_plan())

    def same(t, s, index=False):
        want = torch.int64 if index else getattr(torch, str(s.dtype))
        return t.device.type == "meta" and tuple(t.shape) == s.shape and \
            t.dtype == want

    assert sorted(inputs) == sorted(rin)
    assert all(same(inputs[k], rin[k]) for k in rin)
    assert same(q_pos, rq)
    flat = dict(_flat(rcache))
    assert sorted(cache) == sorted(_port_name(k) for k in flat)
    for key, s in flat.items():
        name = _port_name(key)
        lead = s.ndim - cache[name].ndim + 1
        merged = jax.ShapeDtypeStruct(
            (int(np.prod(s.shape[:lead])),) + s.shape[lead:], s.dtype)
        assert same(cache[name], merged if name != "pos" else s,
                    index=name.startswith(("slot_pos", "pos"))), name


SHARE = [(arch, axes, B) for arch in sorted(REGISTRY) for axes in MESHES
         for B in BATCHES]


@pytest.mark.parametrize("case", SHARE, ids=lambda c: (
    f"{c[0]}-{len(c[1])}d-B{c[2]}"))
def test_prefill_and_decode_plans_share_parameters(case):
    arch, axes, B = case
    prefill = _plans(arch, "prefill", axes, B)[1]
    decode = plan_for(REGISTRY[arch], ShapeConfig("decode", SEQ, B,
                                                  "decode"), prefill.mesh)
    check_shared_params(REGISTRY[arch], prefill, decode)


def test_sharing_refuses_other_placements():
    cfg, axes = REGISTRY["smollm-360m"], ("pod", "data", "model")
    prefill = _plans("smollm-360m", "prefill", axes, 32)[1]

    def on_mesh(kind, **kw):
        return plan_for(cfg, ShapeConfig(kind, SEQ, 32, kind),
                        prefill.mesh, **kw)

    for other in (on_mesh("train"),
                  on_mesh("decode", serve_weight_mode="gathered")):
        with pytest.raises(ValueError, match="placed"):
            check_shared_params(cfg, prefill, other)
    with pytest.raises(ValueError, match="another mesh"):
        check_shared_params(cfg, prefill, _plans("smollm-360m", "decode",
                                                 axes, 32)[1])
    model = build_model(dataclasses.replace(cfg.smoke(), dtype="float32"),
                        device="cpu")
    with pytest.raises(ValueError, match="another mesh"):
        model.with_plan(prefill)
    one = model.with_plan(single_device_plan().with_(moe_target_groups=4))
    assert all(a is b for a, b in zip(one.parameters(), model.parameters()))


# ------------------------- one rank's chunk ------------------------------ #

def _stand_in(sizes, rank):
    """A mesh stand-in of ``sizes`` seen from ``rank`` (row-major)."""
    coord = np.unravel_index(rank, sizes)
    return SimpleNamespace(get_coordinate=lambda: tuple(map(int, coord)),
                           size=lambda i: sizes[i])


def _chunks(S, sizes):
    """[(offset, length)] of each rank's chunk of S slots sharded over
    every dim of a mesh of ``sizes``."""
    n = int(np.prod(sizes))
    return [shard_range(S, _stand_in(sizes, r), [Shard(1)] * len(sizes), 1)
            for r in range(n)]


def test_shard_range_cuts_as_dtensor_nests():
    assert _chunks(22, (4,)) == [(0, 6), (6, 6), (12, 6), (18, 4)]
    assert _chunks(22, (2, 2)) == [(0, 6), (6, 5), (11, 6), (17, 5)]
    assert _chunks(2, (4,)) == [(0, 1), (1, 1), (2, 0), (2, 0)]
    # over the batch (dim 0) only: the sequence whole
    assert shard_range(22, _stand_in((4,), 2), [Shard(0)], 1) == (0, 22)


def _cache(B, S, KV=2, hd=4, dtype=torch.float32, seed=0, filled=True):
    g = torch.Generator().manual_seed(seed)
    k = torch.randn((B, S, KV, hd), generator=g).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(dtype)
    sp = torch.arange(S).expand(B, S).clone() if filled else \
        torch.full((B, S), -1, dtype=torch.int64)
    if not filled:
        k.zero_()
        v.zero_()
    return k, v, sp


WRITES = {  # (cache slots, rolling window, positions (B, T))
    "decode": (22, None, [[9], [21]]),
    "decode_clamped_invalid": (22, None, [[30], [-1]]),
    "prefill": (22, None, [list(range(18))] * 2),
    "rolling_prefill": (16, 16, [list(range(2, 18))] * 2),
    "rolling_decode": (16, 16, [[18], [33]]),
}


@pytest.mark.parametrize("sizes", [(4,), (2, 2)], ids=["4", "2x2"])
@pytest.mark.parametrize("case", list(WRITES))
def test_write_chunk_matches_write_cache(case, sizes):
    S, window, positions = WRITES[case]
    positions = torch.tensor(positions)
    B, T = positions.shape
    g = torch.Generator().manual_seed(1)
    k_new = torch.randn((B, T, 2, 4), generator=g)
    v_new = torch.randn((B, T, 2, 4), generator=g)
    filled = positions.shape[1] == 1
    want = attn.write_cache(*_cache(B, S, filled=filled), k_new, v_new,
                            positions, rolling_window=window)
    whole = _cache(B, S, filled=filled)
    for offset, n in _chunks(S, sizes):
        chunk = [t[:, offset:offset + n].clone() for t in whole]
        attn.write_chunk(*chunk, k_new, v_new, positions, window, offset, S)
        for t, c in zip(whole, chunk):
            t[:, offset:offset + n] = c
    for got, w in zip(whole, want):
        assert torch.equal(got, w)


class _Threads:
    """A world of threads: ``reduce(rank, t, op)`` returns every rank's
    ``t`` combined in rank order, as an all-reduce does."""

    def __init__(self, n):
        self.parts = [None] * n
        self.barrier = threading.Barrier(n)

    def reduce(self, rank, t, op):
        self.parts[rank] = t
        self.barrier.wait()
        out = functools.reduce(torch.maximum if op == "max" else torch.add,
                               self.parts)
        self.barrier.wait()
        return out


def _chunked_attention(q, k, v, q_pos, sp, chunks, **kw):
    world, outs = _Threads(len(chunks)), [None] * len(chunks)

    def rank(r, offset, n):
        sl = slice(offset, offset + n)
        outs[r] = attn._decode_attend(
            q, k[:, sl], v[:, sl], q_pos, sp[:, sl], kw.get("attn_softcap"),
            kw.get("window"), functools.partial(world.reduce, r))

    threads = [threading.Thread(target=rank, args=(r, *c))
               for r, c in enumerate(chunks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(torch.equal(o, outs[0]) for o in outs)
    return outs[0]


ATTEND = {"full": {}, "window": {"window": 8},
          "softcap": {"attn_softcap": 50.0}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [(4,), (2, 2)], ids=["4", "2x2"])
@pytest.mark.parametrize("kw", list(ATTEND))
def test_chunked_decode_attention_matches_one_device(kw, sizes, dtype):
    B, S, H, KV, hd = 2, 22, 4, 2, 4
    k, v, sp = _cache(B, S, KV, hd, dtype=dtype, seed=3)
    sp[:, 19:] = -1                     # empty slots past the positions
    q = torch.randn((B, 1, H, hd), generator=torch.Generator().manual_seed(
        4)).to(dtype)
    q_pos = torch.tensor([18, 15])
    want = attn.decode_attention(q, k, v, q_pos, sp, **ATTEND[kw])
    got = _chunked_attention(q, k, v, q_pos, sp, _chunks(S, sizes),
                             **ATTEND[kw])
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_decode_attention_with_an_empty_chunk():
    """Two slots over four ranks: two chunks are empty, and give nothing
    to the max, the sum or the output."""
    k, v, sp = _cache(1, 2, seed=5)
    q = torch.randn((1, 1, 4, 4), generator=torch.Generator().manual_seed(6))
    q_pos = torch.tensor([1])
    want = attn.decode_attention(q, k, v, q_pos, sp)
    got = _chunked_attention(q, k, v, q_pos, sp, _chunks(2, (4,)))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
