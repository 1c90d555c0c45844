"""The port's roofline (``repro_torch.core.roofline``) against the
reference's (``repro.core.roofline``).

In float64 the port is the reference bit for bit: ``terms_for`` field for
field, and ``terms_grid(xp=torch)`` (float64 columns) against the
reference's numpy ``terms_grid`` for every config, shape kind and
``PLAN_CHOICES`` entry over the sharding planner's grid.  In float32 the
roofline ``Surface`` (the sharding planner's objective and masks) is held
to the reference's jnp float32 surface within ``rtol=1e-5``: the two
round at different points (the port divides where a Python number meets
a tensor as one IEEE division; jax keeps weak types and may rewrite
divisions), and the argmin over the grid must be the same configuration.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as R_REGISTRY
from repro.configs import SHAPES as R_SHAPES
from repro.core import roofline as rr
from repro.core.planning_backend import enumerate_configs as r_enumerate
from repro.core.sharding_planner import ShardingPlanner as RPlanner
from repro.core.sharding_planner import TpuCluster as RTpuCluster
from repro_torch.configs import ARCH_IDS, REGISTRY, SHAPES
from repro_torch.core import roofline as tr
from repro_torch.core.cost_model import Surface
from repro_torch.core.roofline import RooflineCost
from repro_torch.core.sharding_planner import PLAN_CHOICES, ShardingPlanner

KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
RESOURCES = [(1, 1, 1, 1), (1, 16, 16, 2), (2, 4, 8, 8), (2, 16, 1, 1),
             (1, 2, 16, 4)]
RTOL = 1e-5


def _grid(kind):
    return r_enumerate(RTpuCluster().dims(R_SHAPES[KINDS[kind]]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_terms_for_bit_identical(arch):
    for kind, sname in KINDS.items():
        for choice in PLAN_CHOICES[kind]:
            for res in RESOURCES:
                want = rr.terms_for(R_REGISTRY[arch], R_SHAPES[sname],
                                    rr.Resources(*res), **choice)
                got = tr.terms_for(REGISTRY[arch], SHAPES[sname],
                                   tr.Resources(*res), **choice)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert (got.step_s, got.bottleneck) == \
                    (want.step_s, want.bottleneck)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_terms_grid_torch_float64_bit_identical(arch):
    for kind, sname in KINDS.items():
        cfgs = _grid(kind)
        for choice in PLAN_CHOICES[kind]:
            want = rr.terms_grid(R_REGISTRY[arch], R_SHAPES[sname], cfgs,
                                 **choice)
            got = tr.terms_grid(REGISTRY[arch], SHAPES[sname],
                                torch.as_tensor(cfgs), xp=torch, **choice)
            numpy_got = tr.terms_grid(REGISTRY[arch], SHAPES[sname], cfgs,
                                      **choice)
            for f in dataclasses.fields(want):
                w = np.asarray(getattr(want, f.name))
                g = getattr(got, f.name)
                g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
                assert g.dtype != np.float32, f.name
                assert np.array_equal(g, w), (arch, kind, choice, f.name)
                assert np.array_equal(np.asarray(getattr(numpy_got, f.name)),
                                      w)
            assert np.array_equal(got.step_s.numpy(), want.step_s)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_float32_surface_close_to_reference_jnp(arch):
    r_planner, planner = RPlanner(), ShardingPlanner(backend="torch")
    for kind, sname in KINDS.items():
        cfgs = _grid(kind)
        for objective in ("time", "chip_seconds"):
            r_planner.objective = planner.objective = objective
            for choice in PLAN_CHOICES[kind]:
                r_fn = r_planner._grid_fn(R_REGISTRY[arch], R_SHAPES[sname],
                                          choice, _Jnp())
                surface = Surface(RooflineCost(REGISTRY[arch], SHAPES[sname],
                                               dict(choice), planner._hw()),
                                  objective)
                for params in ([math.inf, math.inf], [64.0, math.inf],
                               [math.inf, 384.0]):
                    want = np.asarray(r_fn(jnp.asarray(cfgs), jnp.asarray(
                        params, dtype=jnp.float32)))
                    got = surface(torch.as_tensor(cfgs), torch.tensor(
                        params, dtype=torch.float32)).numpy()
                    assert got.dtype == np.float32 and \
                        want.dtype == np.float32
                    fin = np.isfinite(want)
                    assert np.array_equal(np.isfinite(got), fin)
                    np.testing.assert_allclose(got[fin], want[fin],
                                               rtol=RTOL)
                    if fin.any():
                        assert np.argmin(got) == np.argmin(want)


class _Jnp:
    """The reference planner's backend stand-in for a jnp surface (its
    ``_grid_fn`` reads ``name`` and ``xp``)."""
    name = "jax"
    xp = jnp


def test_hw_and_resources_are_the_reference_data():
    assert tr.HW == rr.HW
    assert tr.Resources().as_tuple() == rr.Resources().as_tuple()
    assert tr.Resources(2, 16, 16, 1).chips == 512


def test_roofline_consts_fold_the_grid_path():
    """The kernel's constants are the grid path's own resource-free
    terms: with every per-row factor 1 the float64 surface is rebuilt from
    them (spot check of the train fold: N, tokens and the FLOP census)."""
    cfg, shape = REGISTRY["deepseek-67b"], SHAPES["train_4k"]
    rc = RooflineCost(cfg, shape, dict(PLAN_CHOICES["train"][0]), tr.HW)
    c = rc.consts()
    assert c[0] == float(cfg.param_count()) and c[1] == c[0] * 2
    assert c[7] == shape.global_batch * shape.seq_len
    g = tr.terms_grid(cfg, shape, np.array([[1, 1, 1, 1]]),
                      **PLAN_CHOICES["train"][0])
    assert g.compute_s[0] == c[3] / (1 * tr.HW["peak_flops"])
    assert Surface(rc).n_dims == 4 and Surface(rc).n_params == 2
    with pytest.raises(ValueError, match="does not apply"):
        Surface(rc, "money")
