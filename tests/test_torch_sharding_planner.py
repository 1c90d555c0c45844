"""The port's sharding planner (``repro_torch.core.sharding_planner``)
against the reference's (``repro.core.sharding_planner``).

The first twelve tests are the port's counterparts of
``tests/test_sharding_planner.py`` on the exact ``backend="torch"``
(the port's default backend is the GPU's).  Then decisions — resources,
plan choice and the float64 objective — must equal the reference's
``backend="numpy"`` ones across archs x shape kinds x the three
``resource_planning`` modes x both objectives: on ``"torch"``, on
``CudaPlanBackend(device="cpu")`` unsharded and sharded over logical CPU
shards (float32 search, float64 commit), and on the session broker.  The
reference's single-device ``pallas`` backend (interpret mode) is held to
the same decisions on two archs.
"""
import dataclasses
import math

import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_shape as r_get_shape
from repro.core.plan_broker import PlanBroker as RPlanBroker
from repro.core.sharding_planner import ShardingPlanner as RPlanner
from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.core.cluster import paper_cluster
from repro_torch.core.cost_model import simulator_cost_models
from repro_torch.core.plan_broker import PlanBroker
from repro_torch.core.plan_cache import ResourcePlanCache
from repro_torch.core.planning_backend import get_backend
from repro_torch.core.plans import OperatorCosting
from repro_torch.core.roofline import (HW, Resources, chip_seconds,
                                       decode_terms, prefill_terms,
                                       train_terms)
from repro_torch.core.sharding_planner import ShardingPlanner, TpuCluster
from repro_torch.kernels.plan_scan import CudaPlanBackend

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")
MODES = ("hillclimb", "ensemble", "brute")


def _planner(**kw):
    return ShardingPlanner(backend=kw.pop("backend", "torch"), **kw)


# ------------------- counterparts of test_sharding_planner ------------------ #

def test_roofline_terms_positive_and_scale():
    cfg = get_config("deepseek-67b")
    shape = get_shape("train_4k")
    t1 = train_terms(cfg, shape, Resources(1, 16, 16, 2))
    t2 = train_terms(cfg, shape, Resources(2, 16, 16, 2))
    assert t1.compute_s > 0 and t1.memory_s > 0 and t1.collective_s > 0
    assert t2.compute_s == pytest.approx(t1.compute_s / 2, rel=1e-6)
    assert t1.model_flops == pytest.approx(
        6 * cfg.param_count() * 256 * 4096, rel=0.01)


def test_decode_memory_bound_for_big_dense():
    t = decode_terms(get_config("deepseek-67b"), get_shape("decode_32k"),
                     Resources(1, 16, 16, 1))
    assert t.bottleneck == "memory"


def test_moe_flops_use_active_params():
    cfg = get_config("qwen3-moe-30b-a3b")
    t = train_terms(cfg, get_shape("train_4k"), Resources(2, 16, 16, 1))
    dense_equiv = 8 * cfg.param_count() * 256 * 4096
    assert t.flops_per_chip * 512 < 0.5 * dense_equiv


def test_infeasible_single_chip():
    t = train_terms(get_config("deepseek-67b"), get_shape("train_4k"),
                    Resources(1, 1, 1, 1))
    assert not t.feasible


def test_joint_feasible_for_all_archs():
    p = _planner()
    for arch in ("deepseek-67b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                 "gemma2-9b", "zamba2-2.7b"):
        for shape in SHAPE_NAMES:
            d = p.joint(get_config(arch), get_shape(shape), arch=arch)
            assert d.terms.feasible
            assert d.terms.hbm_per_chip < HW["hbm_bytes"]
            assert math.isfinite(d.objective_value)


def test_ssm_has_no_attention_schedule_choice():
    d = _planner().joint(get_config("falcon-mamba-7b"), get_shape("train_4k"))
    assert d.plan_choice.get("schedule", "dense") == "dense"


def test_replan_respects_degraded_cluster():
    p = _planner()
    full = p.joint(get_config("deepseek-67b"), get_shape("train_4k"))
    degraded = p.replan(get_config("deepseek-67b"), get_shape("train_4k"),
                        lost_chips=256)
    assert degraded.resources.chips <= 256
    assert degraded.terms.feasible
    assert degraded.terms.step_s >= full.terms.step_s


def test_budget_mode_respects_budget():
    d = _planner().for_budget(get_config("smollm-360m"),
                              get_shape("train_4k"), 64)
    assert d.resources.chips <= 64


def test_budget_infeasible_raises():
    with pytest.raises(RuntimeError):
        _planner().for_budget(get_config("deepseek-67b"),
                              get_shape("train_4k"), 8)


def test_stale_cache_validated_under_new_cluster():
    cache = ResourcePlanCache("nearest_neighbor", 50.0)
    p = _planner(cache=cache)
    p.joint(get_config("deepseek-67b"), get_shape("train_4k"))
    d = p.replan(get_config("deepseek-67b"), get_shape("train_4k"),
                 lost_chips=256)
    assert d.resources.chips <= 256


def test_chip_seconds_objective_prefers_fewer_chips():
    pt = _planner(objective="time")
    pc = _planner(objective="chip_seconds")
    cfg, shape = get_config("smollm-360m"), get_shape("train_4k")
    dt_ = pt.joint(cfg, shape)
    dc = pc.joint(cfg, shape)
    assert dc.resources.chips <= dt_.resources.chips
    assert chip_seconds(dc.terms, dc.resources) <= \
        chip_seconds(dt_.terms, dt_.resources) + 1e-9


def test_prefill_terms_swa_cheaper_than_full():
    cfg = get_config("mixtral-8x7b")
    full = dataclasses.replace(cfg, attention="full")
    r = Resources(1, 16, 16, 1)
    t_swa = prefill_terms(cfg, get_shape("prefill_32k"), r)
    t_full = prefill_terms(full, get_shape("prefill_32k"), r)
    assert t_swa.compute_s < t_full.compute_s


# ---------------------- decisions against the reference --------------------- #

def _decision(call):
    """(resources, plan choice, objective, terms) or "infeasible"."""
    try:
        d = call()
    except RuntimeError:
        return "infeasible"
    return (d.resources.as_tuple(), tuple(sorted(d.plan_choice.items())),
            d.objective_value, d.terms.step_s, d.terms.hbm_per_chip,
            d.arch, d.shape)


def _ref_decisions(arch, objective="time", backend="numpy", modes=MODES):
    out = {}
    for sname in SHAPE_NAMES:
        for mode in modes:
            p = RPlanner(resource_planning=mode, objective=objective,
                         backend=backend)
            out[sname, mode] = _decision(lambda: p.joint(
                r_get_config(arch), r_get_shape(sname), arch=arch))
    return out


def _port_decisions(arch, objective="time", backend="torch", modes=MODES,
                    **kw):
    out = {}
    for sname in SHAPE_NAMES:
        for mode in modes:
            p = ShardingPlanner(resource_planning=mode, objective=objective,
                                backend=backend, **kw)
            out[sname, mode] = _decision(lambda: p.joint(
                get_config(arch), get_shape(sname), arch=arch))
    return out


@pytest.mark.parametrize("objective", ["time", "chip_seconds"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_torch_backend_decisions_identical_to_numpy(arch, objective):
    assert _port_decisions(arch, objective) == \
        _ref_decisions(arch, objective)


@pytest.mark.parametrize("devices", [None, ["cpu"] * 3, ["cpu"] * 8])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cuda_backend_on_cpu_decisions_equal_numpy(arch, devices):
    backend = CudaPlanBackend(device="cpu", devices=devices)
    assert _port_decisions(arch, backend=backend) == _ref_decisions(arch)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-67b"])
def test_cuda_backend_on_cpu_equals_reference_pallas(arch):
    modes = ("hillclimb", "brute")
    assert _port_decisions(arch, backend=CudaPlanBackend(device="cpu"),
                           modes=modes) == \
        _ref_decisions(arch, backend="pallas", modes=modes)


def test_budget_and_replan_equal_reference():
    for arch in ("smollm-360m", "deepseek-67b", "mixtral-8x7b"):
        for mode in MODES:
            for be in ("torch", CudaPlanBackend(device="cpu",
                                                devices=["cpu"] * 4)):
                p = ShardingPlanner(resource_planning=mode, backend=be)
                rp = RPlanner(resource_planning=mode)
                cfg, rcfg = get_config(arch), r_get_config(arch)
                shape, rshape = get_shape("train_4k"), r_get_shape("train_4k")
                assert _decision(lambda: p.for_budget(cfg, shape, 64)) == \
                    _decision(lambda: rp.for_budget(rcfg, rshape, 64))
                assert _decision(lambda: p.replan(cfg, shape, 128)) == \
                    _decision(lambda: rp.replan(rcfg, rshape, 128))


@pytest.mark.parametrize("mode", MODES)
def test_broker_path_equals_inline_path(mode):
    for be in ("torch", CudaPlanBackend(device="cpu")):
        for arch in ("deepseek-67b", "falcon-mamba-7b"):
            for sname in SHAPE_NAMES:
                cfg, shape = get_config(arch), get_shape(sname)
                inline = _decision(lambda: ShardingPlanner(
                    resource_planning=mode, backend=be).joint(cfg, shape))
                brokered = _decision(lambda: ShardingPlanner(
                    resource_planning=mode, backend=be,
                    broker=PlanBroker(be)).joint(cfg, shape))
                ref = _decision(lambda: RPlanner(
                    resource_planning=mode, broker=RPlanBroker("numpy")
                ).joint(r_get_config(arch), r_get_shape(sname)))
                assert brokered[:5] == inline[:5] == ref[:5]


def test_db_and_tpu_share_one_broker_flush():
    broker = PlanBroker("torch")
    db = OperatorCosting(models=simulator_cost_models(),
                         cluster=paper_cluster(), resource_planning="batched",
                         broker=broker)
    db.prefetch("SMJ", 2.0, 74.0)
    db.prefetch("BHJ", 1.0, 74.0)
    assert broker.pending_count() == 2
    tpu = ShardingPlanner(resource_planning="hillclimb", backend="torch",
                          broker=broker)
    d = tpu.joint(get_config("smollm-360m"), get_shape("train_4k"))
    assert broker.pending_count() == 0        # TPU resolve flushed DB too
    solo = OperatorCosting(models=simulator_cost_models(),
                           cluster=paper_cluster(),
                           resource_planning="batched", backend="torch")
    assert db.plan_resources("SMJ", 2.0, 74.0) == \
        solo.plan_resources("SMJ", 2.0, 74.0)
    ref = ShardingPlanner(resource_planning="hillclimb",
                          backend="torch").joint(get_config("smollm-360m"),
                                                 get_shape("train_4k"))
    assert d.resources == ref.resources


def test_grid_fn_carries_its_surface():
    p = _planner()
    fn = p._grid_fn(get_config("gemma2-9b"), get_shape("decode_32k"),
                    {"weight_mode": "gathered"}, get_backend("torch"))
    assert fn.surface.kind == "decode" and fn.surface.objective == "time"
    assert fn.surface.flags & 16          # gathered weights
    assert TpuCluster().dims(get_shape("decode_32k")).n_dims == \
        fn.surface.n_dims


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")


def test_default_backend_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ShardingPlanner().joint(get_config("smollm-360m"),
                                get_shape("train_4k"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ShardingPlanner().for_budget(get_config("smollm-360m"),
                                     get_shape("train_4k"), 64)
