"""The port's parallel plans against the reference's, in pure Python.

For every arch of the registry, every shape kind (train, prefill,
decode), both mesh axis sets (``("data", "model")`` at 16 x 16 and
``("pod", "data", "model")`` at 2 x 16 x 16, the reference's production
meshes) and global batches 8 and 32 (either side of ``serve_plan``'s
small-batch cut at 16): ``launch.specs.plan_for``'s plan equals the
reference's, rule for rule and field for field, and
``defs_to_specs(model_defs(cfg), plan)`` equals the reference's leaf for
leaf (the reference's ``PartitionSpec`` as the tuple it holds).  The
reference's ``plan_for`` reads only ``mesh.axis_names`` and
``mesh.shape``, the port's ``mesh_dim_names`` and ``shape``, so stand-ins
serve as both meshes, with no devices.  mixtral-8x7b's 8 experts do not
divide the model axis of 16, so its plans take ``moe_rules_for``'s
TP-within-expert branch; qwen3's 128 do, and keep EP.

Also ``moe_rules_for`` on its own, ``placements`` on a few logical
tuples (on a stand-in mesh: placements need no process group),
``constrain``'s identity on plain tensors, the projections on plain
tensors in either ``tp_mode``, every arch's admission of
``tp_mode="shard_map"``, causal_skip and pipeline stages, the refusal of
an unknown mode or schedule, ``active_mesh``'s choice of dims and
``ops.local_kv_heads``.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import REGISTRY as RREGISTRY
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.launch.specs import plan_for as rplan_for
from repro.models.transformer import model_defs as rmodel_defs
from repro.sharding import defs_to_specs as rdefs_to_specs
from repro.sharding import moe_rules_for as rmoe_rules_for
from repro.sharding import train_plan as rtrain_plan
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.ops import local_kv_heads
from repro_torch.launch.specs import plan_for
from repro_torch.models.transformer import model_defs
from repro_torch.sharding import (ParallelPlan, active_mesh, defs_to_specs,
                                  moe_rules_for, single_device_plan,
                                  train_plan)

MESHES = {("data", "model"): (16, 16),
          ("pod", "data", "model"): (2, 16, 16)}
KINDS = ("train", "prefill", "decode")
BATCHES = (8, 32)
SEQ = 4096
FIELDS = ("name", "rules", "enabled", "remat", "microbatch", "seq_shard",
          "attention_schedule", "moe_group_size", "moe_target_groups",
          "ssm_chunk", "tp_mode", "pipeline_stages")
CASES = [(arch, kind, axes, batch) for arch in sorted(REGISTRY)
         for kind in KINDS for axes in MESHES for batch in BATCHES]


def _ids(case):
    arch, kind, axes, batch = case
    return f"{arch}-{kind}-{len(axes)}d-B{batch}"


def _meshes(axes):
    sizes = MESHES[axes]
    rmesh = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))
    mesh = SimpleNamespace(mesh_dim_names=axes, shape=sizes)
    return rmesh, mesh


def _plans(arch, kind, axes, batch):
    rmesh, mesh = _meshes(axes)
    rplan = rplan_for(RREGISTRY[arch], RShapeConfig(kind, SEQ, batch, kind),
                      rmesh)
    plan = plan_for(REGISTRY[arch], ShapeConfig(kind, SEQ, batch, kind),
                    mesh)
    return rplan, plan, rmesh, mesh


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plan_for_matches_reference(case):
    rplan, plan, rmesh, mesh = _plans(*case)
    for f in FIELDS:
        assert getattr(plan, f) == getattr(rplan, f), f
    assert plan.mesh is mesh and rplan.mesh is rmesh


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_param_specs_match_reference(case):
    arch = case[0]
    rplan, plan = _plans(*case)[:2]
    want = dict(_flat(rdefs_to_specs(rmodel_defs(RREGISTRY[arch]), rplan)))
    got = dict(_flat(defs_to_specs(model_defs(REGISTRY[arch]), plan)))
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k] == tuple(spec), k


@pytest.mark.parametrize("model_size,n_experts", [(16, 8), (16, 128),
                                                  (4, 6), (1, 8)])
def test_moe_rules_for_matches_reference(model_size, n_experts):
    axes = ("pod", "data", "model")
    got = moe_rules_for(train_plan(axes), n_experts, model_size)
    want = rmoe_rules_for(rtrain_plan(axes), n_experts, model_size)
    assert got.rules == want.rules
    ep = n_experts % model_size == 0
    assert got.rule("experts") == ("model" if ep else None)
    assert got.rule("ff_expert") == (None if ep else "model")


def test_placements():
    axes = ("pod", "data", "model")
    plan = train_plan(axes)
    mesh = SimpleNamespace(mesh_dim_names=axes, shape=(2, 4, 4))
    R = Replicate()
    assert plan.spec(("batch", "seq", None)) == (("pod", "data"), "model",
                                                 None)
    assert plan.placements(("batch", "seq", None), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert plan.placements(("embed", "heads"), mesh) == \
        [R, Shard(0), Shard(1)]
    assert plan.placements(("vocab", "embed"), mesh) == \
        [R, Shard(1), Shard(0)]
    assert plan.placements((None, None), mesh) == [R, R, R]
    assert plan.placements(("tokens",), mesh) == [Shard(0)] * 3
    # on a ("data", "model") mesh "batch" is the one axis, not a tuple
    plan2 = train_plan(("data", "model"))
    mesh2 = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 4))
    assert plan2.rule("batch") == "data"
    assert plan2.placements(("batch", None, "heads", None), mesh2) == \
        [Shard(0), Shard(2)]
    # a size-1 axis a rule names may be missing from the mesh given
    # (active_mesh drops it); a missing axis of size > 1 raises
    plan3 = plan.with_(mesh=SimpleNamespace(mesh_dim_names=axes,
                                            shape=(1, 4, 4)))
    sub = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 4))
    assert plan3.placements(("batch", "ff"), sub) == [Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="pod"):
        plan.with_(mesh=mesh).placements(("batch",), sub)


def test_constrain_and_projections_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    w = torch.randn(4, 5)
    for plan in (single_device_plan(), train_plan(("data", "model"))):
        assert plan.constrain(x, ("batch", "seq", None)) is x
        assert torch.equal(plan.col_parallel_project(x, w), x @ w)
        assert torch.equal(plan.row_parallel_project(x, w), x @ w)
        # the explicit collectives run on DTensors only, as the
        # reference's run only with a mesh
        explicit = plan.with_(tp_mode="shard_map")
        assert torch.equal(explicit.col_parallel_project(x, w), x @ w)
        assert torch.equal(explicit.row_parallel_project(x, w), x @ w)
    assert single_device_plan() == ParallelPlan(
        name="single", enabled=False, remat="none", seq_shard=False)


class _Mesh(SimpleNamespace):
    """A stand-in DeviceMesh for active_mesh: indexing by names returns
    the names."""

    def __getitem__(self, names):
        return names


@pytest.mark.parametrize("shape,want", [
    ((1, 2, 2), ("data", "model")), ((2, 2, 1), ("pod", "data")),
    ((1, 1, 4), "model"), ((1, 1, 1), "model"), ((2, 2, 2), None)])
def test_active_mesh(shape, want):
    mesh = _Mesh(mesh_dim_names=("pod", "data", "model"), shape=shape)
    got = active_mesh(mesh)
    assert (got is mesh) if want is None else got == want


@pytest.mark.parametrize("H,KV,tp", [(4, 2, 1), (4, 2, 2), (4, 2, 4),
                                     (15, 5, 3), (15, 5, 5), (15, 5, 15),
                                     (32, 8, 16), (8, 8, 4)])
def test_local_kv_heads(H, KV, tp):
    """Each rank's local q head j, read through the kernel's own grouping
    of its local heads onto the KV heads it is handed, reads the model's
    KV head (h0 + j) // (H / KV)."""
    G = H // KV
    for m in range(tp):
        Hl = H // tp
        pick = np.arange(KV)[local_kv_heads(H, KV, tp, m)]
        assert Hl % len(pick) == 0
        local_group = Hl // len(pick)
        for j in range(Hl):
            assert pick[j // local_group] == (m * Hl + j) // G
    with pytest.raises(NotImplementedError, match="head"):
        local_kv_heads(15, 5, 2, 0)


class _DeviceMesh(SimpleNamespace):
    """A stand-in DeviceMesh for a model's plan checks."""

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]


def _train_plan_on(cfg, shape=(1, 2, 2)):
    mesh = _DeviceMesh(mesh_dim_names=("pod", "data", "model"), shape=shape)
    return plan_for(cfg, ShapeConfig("train", 32, 8, "train"), mesh)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_every_arch_admits_shard_map_causal_skip_and_stages(arch):
    from repro_torch.models.model import check_supported
    cfg = REGISTRY[arch].smoke()
    check_supported(cfg, _train_plan_on(cfg).with_(
        tp_mode="shard_map", attention_schedule="causal_skip",
        pipeline_stages=2))


@pytest.mark.parametrize("kw,match", [
    (dict(tp_mode="megatron"), "tp_mode='megatron'"),
    (dict(attention_schedule="window"), "attention_schedule='window'"),
    (dict(attention_schedule="sparse"), "attention_schedule='sparse'")])
def test_unknown_tp_mode_or_schedule_raises(kw, match):
    """An unknown tp_mode or block schedule raises ValueError: in the
    model's plan check, in a projection, in K7's wrapper."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import check_supported
    cfg = REGISTRY["smollm-360m"].smoke()
    with pytest.raises(ValueError, match=match):
        check_supported(cfg, _train_plan_on(cfg).with_(**kw))
    x = torch.randn(2, 3, 4)
    if "tp_mode" in kw:
        with pytest.raises(ValueError, match=match):
            single_device_plan().with_(**kw).col_parallel_project(
                x, torch.randn(4, 5))
    elif kw["attention_schedule"] != "window":
        q = torch.randn(1, 3, 2, 16)
        with pytest.raises(ValueError, match="schedule='sparse'"):
            ops.flash_attention(q, q, q, schedule="sparse")


DENSE_FULL = sorted(a for a, c in REGISTRY.items()
                    if c.family == "dense" and c.attention == "full")


def test_dense_full_archs():
    assert DENSE_FULL == ["deepseek-67b", "nemotron-4-15b", "smollm-360m"]


def test_dense_plans_refuse_what_is_not_ported():
    """smollm-360m under a plan admits the local_global schedule (and
    swa), the causal_skip block schedule, tp_mode="shard_map" and
    pipeline stages, and refuses only a head count the model axis does
    not divide."""
    from repro_torch.models.model import build_model, check_supported
    cfg = REGISTRY["smollm-360m"]
    for schedule in ("local_global", "swa"):
        admitted = dataclasses.replace(cfg.smoke(), attention=schedule)
        check_supported(admitted, _train_plan_on(admitted))
    small = cfg.smoke()
    for kw in (dict(attention_schedule="causal_skip"),
               dict(tp_mode="shard_map"), dict(pipeline_stages=2)):
        check_supported(small, _train_plan_on(small).with_(**kw))
    # 15 heads do not split over a model axis of 2
    with pytest.raises(NotImplementedError, match="head"):
        build_model(cfg, _train_plan_on(cfg), device="cpu")


def test_launcher_refuses_many_gpus_without_torchrun(monkeypatch):
    """More than one visible GPU in a process torchrun did not start
    raises, naming torchrun (the GPUs are faked: only the count is
    read before the raise)."""
    from repro_torch.launch import train
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["smollm-360m", "llama-3.2-vision-11b",
                                  "musicgen-medium"])
def test_batch_specs_and_shardings_match_reference(arch):
    """The batch stand-ins' shapes and dtypes, and their placements from
    the reference's NamedSharding specs."""
    from repro.launch.specs import batch_specs as rbatch_specs
    from repro_torch.launch.specs import batch_shardings, batch_specs
    rshape = RShapeConfig("train", 128, 8, "train")
    shape = ShapeConfig("train", 128, 8, "train")
    want = rbatch_specs(RREGISTRY[arch], rshape)
    got = batch_specs(REGISTRY[arch], shape)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape)
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
    axes = ("pod", "data", "model")
    plan = train_plan(axes)
    mesh = SimpleNamespace(mesh_dim_names=axes, shape=(2, 2, 2))
    placed = batch_shardings(REGISTRY[arch], shape, mesh, plan)
    assert sorted(placed) == sorted(want)
    assert placed["labels"] == [Shard(0), Shard(0), Shard(1)]


def test_train_state_specs():
    from repro_torch.launch.specs import serve_param_specs, train_state_specs
    from repro_torch.models.model import build_model
    cfg = REGISTRY["smollm-360m"].smoke()
    model = build_model(cfg, device="cpu")
    state, specs = train_state_specs(model)
    params = dict(model.named_parameters())
    assert sorted(state.params) == sorted(params) == sorted(specs.params)
    for k, p in params.items():
        assert state.params[k].shape == p.shape
        assert state.opt_state.m[k].dtype == torch.float32
        assert specs.params[k] == (None,) * p.ndim   # one device's plan
    served = dict(_flat(serve_param_specs(cfg)))
    assert served["layers/attn/wq"].shape == (cfg.n_layers, cfg.d_model,
                                              cfg.n_heads * cfg.head_dim)
    assert served["layers/attn/wq"].dtype == torch.bfloat16
