"""Port cost models against the JAX reference's numpy cost models.

Both packages get the same state: the port's models are built from the
reference models' numbers (``models_from_arrays``) or fitted by the port
itself from the same simulator profile runs.  In float64 the scalar
``cost`` and the torch ``cost_grid`` must equal the reference's numpy
values bit for bit, for the time and the money objective, for one request
(scalar ss/ls) and for a stacked (Q, 1) request batch.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import cost_model as rcm
from repro_torch.core import cost_model as tcm

OOM_FRAC = 0.7          # the reference's BHJ OOM lambdas: ss > 0.7 * cs


def _spec(models):
    return {name: {"coef": np.asarray(m.coef), "floor": m.floor,
                   "oom_frac": None if m.oom_fn is None else OOM_FRAC}
            for name, m in models.items()}


def _pairs():
    sim = rcm.HiveSimulator()
    return {
        "paper": (rcm.paper_models(),
                  tcm.models_from_arrays(_spec(rcm.paper_models()))),
        "simreg-arrays": (rcm.simulator_models(),
                          tcm.models_from_arrays(
                              _spec(rcm.simulator_models()))),
        "simreg-fit": (rcm.simulator_models(), tcm.simulator_models()),
        "sim": (rcm.simulator_cost_models(sim),
                tcm.models_from_arrays(dataclasses.asdict(sim))),
    }


PAIRS = _pairs()


def _configs(rng, n=4000):
    return np.stack([rng.integers(1, 200, n), rng.integers(1, 40, n)], 1)


def test_reference_oom_lambdas_match_oom_frac():
    rng = np.random.default_rng(3)
    for ref in (rcm.paper_models()["BHJ"], rcm.simulator_models()["BHJ"]):
        for ss, cs in zip(rng.uniform(0, 30, 500), rng.integers(1, 40, 500)):
            assert bool(ref.oom_fn(ss, float(cs))) == (ss > OOM_FRAC * cs)


def test_port_fit_is_bit_equal():
    ref, port = rcm.simulator_models(), tcm.simulator_models()
    for name in ("SMJ", "BHJ"):
        assert np.array_equal(ref[name].coef, port[name].coef)
    assert port["BHJ"].oom_frac == OOM_FRAC and port["SMJ"].oom_frac is None


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_scalar_cost_bit_equal(pair):
    ref, port = PAIRS[pair]
    rng = np.random.default_rng(0)
    for impl in ("SMJ", "BHJ"):
        for _ in range(300):
            ss, ls = float(rng.uniform(0.01, 40)), float(rng.uniform(0, 200))
            cs, nc = float(rng.integers(1, 40)), float(rng.integers(1, 200))
            a = ref[impl].cost(ss, cs, nc, ls=ls)
            b = port[impl].cost(ss, cs, nc, ls=ls)
            assert a == b or (math.isinf(a) and math.isinf(b))
            if math.isfinite(a):
                assert rcm.monetary_cost(a, cs, nc) == \
                    tcm.monetary_cost(b, cs, nc)


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("objective", ["time", "money"])
def test_cost_grid_bit_equal(pair, objective):
    ref, port = PAIRS[pair]
    rng = np.random.default_rng(1)
    cfgs = _configs(rng)
    for impl in ("SMJ", "BHJ"):
        fn = tcm.Surface(port[impl], objective)
        # one request: the reference sees numpy scalars, the port 0-d
        # tensors; a stack: (Q, 1) columns on both sides
        for q in (None, 6):
            ss = rng.uniform(0.01, 40, q or 1)
            ls = ss + rng.uniform(0, 200, q or 1)
            if q is None:
                p_ref = np.asarray([ss[0], ls[0]])
                p_port = torch.tensor(p_ref)
            else:
                p_ref = np.stack([ss, ls])[:, :, None]
                p_port = torch.tensor(p_ref)
            t = ref[impl].cost_grid(p_ref[0], p_ref[1], cfgs)
            if objective == "money":
                nc, cs = cfgs[:, 0].astype(float), cfgs[:, 1].astype(float)
                t = np.where(np.isfinite(t), rcm.monetary_cost(t, cs, nc),
                             np.inf)
            got = fn(torch.tensor(cfgs), p_port).numpy()
            assert got.dtype == np.float64
            np.testing.assert_array_equal(np.broadcast_to(t, got.shape), got)


def test_surface_descriptor_constants():
    sim = tcm.HiveSimulator()
    s = tcm.Surface(tcm.SimulatorCostModel("SMJ", sim), "money")
    assert s.kind == "smj" and s.n_params == 2
    assert s.consts()[3] == sim.disk_gbps * 80
    r = tcm.Surface(tcm.paper_models()["BHJ"], "sla")
    assert r.kind == "regression" and r.oom and r.n_params == 3
    assert r.consts()[-1] == OOM_FRAC
    with pytest.raises(TypeError):
        tcm.Surface(object(), "time")
    with pytest.raises(ValueError):
        tcm.Surface(tcm.paper_models()["SMJ"], "latency")


def test_max_clamps_keep_nan():
    # torch.maximum rejects a Python float; clamp_min keeps np.maximum's
    # value and NaN behaviour
    x = torch.tensor([float("nan"), 0.5, 2.0], dtype=torch.float64)
    np.testing.assert_array_equal(torch.clamp_min(x, 1.0).numpy(),
                                  np.maximum(x.numpy(), 1.0))
