"""Cost models f(d, r) -> C (paper §VI-A), with torch grid surfaces.

Three layers, as in the JAX reference (``repro.core.cost_model``):

1. ``PAPER_SMJ`` / ``PAPER_BHJ``: the paper's published linear-regression
   coefficients over [ss, ss^2, cs, cs^2, nc, nc^2, cs*nc].
2. ``HiveSimulator``: the analytic Hive/YARN join simulator that stands in
   for the profiled cluster.
3. ``RegressionModel.fit``: ordinary least squares (numpy lstsq) over the
   same feature vector.

Every model exposes two evaluation paths with one operation order:

* ``cost(ss, cs, nc, ls)`` — one configuration, Python floats;
* ``cost_grid(ss, ls, configs)`` — an ``(N, 2)`` tensor of ``(nc, cs)``
  configurations in one torch call.  ``ss``/``ls`` are Python floats, 0-d
  tensors (one request) or ``(Q, 1)`` columns (a stacked request batch);
  the surface computes in their dtype (float64 for Python floats).

The port differs from the reference in four places:

* ``torch.maximum`` rejects a Python float operand, so ``max(x, c)``
  is ``torch.clamp_min(x, c)`` — the same value, NaN propagated like
  ``np.maximum``.
* Division by a Python constant goes through ``_div``: PyTorch's CUDA
  kernel multiplies by the reciprocal of a host-scalar divisor, which can
  be an ulp off the true quotient that numpy, XLA and the CUDA scan
  kernel compute.
* The external-sort ``log2`` term: in float64 it is computed on the host
  exactly as the reference does (``math.log2`` for one request — the
  reference sees a numpy scalar there — and ``np.log2`` for a stacked
  column), so the float64 port is bit-identical with the numpy backend;
  in float32 it is ``log(x) / log(2)``, the definition ``jnp.log2`` traces
  to and the CUDA kernel computes.
* OOM predicates are a number, not a lambda: ``RegressionModel.oom_frac``
  marks ``ss > oom_frac * cs`` infeasible, so a CUDA kernel can evaluate
  it.  Each shipped model also describes itself as a ``Surface``
  (kind + constants + objective) that ``repro_torch.kernels.plan_scan``
  turns into kernel arguments; so do the sharding planner's rooflines
  (``roofline.RooflineCost``) and ``CostTable``, a cost per grid point.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.roofline import RooflineCost

FEATURES = ("ss", "ss2", "cs", "cs2", "nc", "nc2", "cs_nc")

# float32 log(2), as the reference's jnp.log2 computes it (log x / log 2)
_LN2_F32 = float(np.float32(math.log(2.0)))


def feature_vector(ss: float, cs: float, nc: float) -> np.ndarray:
    return np.array([ss, ss * ss, cs, cs * cs, nc, nc * nc, cs * nc],
                    dtype=np.float64)


def _dtype_of(*xs) -> torch.dtype:
    """Compute dtype of a surface: that of its first tensor argument,
    float64 when every per-request scalar is a Python float."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.dtype
    return torch.float64


def _split_configs(configs, dtype=torch.float64):
    """(N, 2) tensor of (nc, cs) resource configurations -> float columns."""
    a = torch.as_tensor(configs)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"expected (N, 2) (nc, cs) configs, got "
                         f"{tuple(a.shape)}")
    a = a.to(dtype)
    return a[:, 0], a[:, 1]


def _div(x, c: float):
    """``x / c`` for a Python-float divisor, as a true IEEE division on
    every device (a 0-d tensor of x's dtype on x's device, never a host
    scalar that the CUDA kernel would turn into a reciprocal)."""
    if isinstance(x, torch.Tensor):
        return x / x.new_full((), c)
    return x / c


def _maximum(a, b):
    """``np.maximum`` of two per-request values (Python floats or tensors
    of one shape)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
    return max(a, b)


def _sort_log2(total):
    """log2 term of the external-sort cost (see the module docstring for
    the float64 / float32 split)."""
    if isinstance(total, (int, float)):
        return math.log2(max(total * 8, 2))
    if total.dtype == torch.float64:
        t = total.detach().cpu().numpy()
        if t.ndim == 0:
            return math.log2(max(float(t) * 8, 2))
        return torch.from_numpy(np.log2(np.maximum(t * 8.0, 2.0))).to(
            total.device)
    return _div(torch.log(torch.clamp_min(total * 8.0, 2.0)), _LN2_F32)


# --- the paper's published coefficients (§VI-A), verbatim ------------------- #
PAPER_SMJ = np.array([1.62643613e+01, 9.68774888e-01, 1.33866542e-02,
                      1.60639851e-01, -7.82618920e-03, -3.91309460e-01,
                      1.10387975e-01])
PAPER_BHJ = np.array([1.00739509e+04, -6.72184592e+02, -1.37392901e+01,
                      -1.64871481e+02, 2.44721676e-02, 1.22360838e+00,
                      -1.37319484e+02])


@dataclasses.dataclass
class RegressionModel:
    """Linear model over FEATURES; cost in seconds.  ``oom_frac`` marks
    ``ss > oom_frac * cs`` as out of memory (infinite cost)."""
    name: str
    coef: np.ndarray
    oom_frac: Optional[float] = None

    # the no-intercept linear form extrapolates negative outside the
    # profiled region; clamp at a small positive floor (see the reference)
    floor: float = 1e-3

    def oom(self, ss, cs):
        return ss > self.oom_frac * cs

    def _eval(self, ss, cs, nc):
        # Shared by cost/cost_grid: one fixed elementwise operation order so
        # scalar and batched evaluation agree bit-for-bit.
        c = [float(v) for v in self.coef]
        return (c[0] * ss + c[1] * (ss * ss) + c[2] * cs + c[3] * (cs * cs)
                + c[4] * nc + c[5] * (nc * nc) + c[6] * (cs * nc))

    def cost(self, ss: float, cs: float, nc: float, ls: float = 0.0) -> float:
        # the paper's feature vector has only the smaller input size; ls is
        # accepted and ignored
        if self.oom_frac is not None and self.oom(ss, cs):
            return math.inf
        return max(float(self._eval(ss, cs, nc)), self.floor)

    def cost_grid(self, ss, ls, configs):
        """Vectorized ``cost`` over an (N, 2) tensor of (nc, cs) configs."""
        nc, cs = _split_configs(configs, _dtype_of(ss, ls))
        out = torch.clamp_min(self._eval(ss, cs, nc), self.floor)
        if self.oom_frac is not None:
            out = torch.where(self.oom(ss, cs), math.inf, out)
        return out

    @classmethod
    def fit(cls, name: str, xs: Sequence[Tuple[float, float, float]],
            ys: Sequence[float], oom_frac: Optional[float] = None
            ) -> "RegressionModel":
        A = np.stack([feature_vector(*x) for x in xs])
        coef, *_ = np.linalg.lstsq(A, np.asarray(ys, np.float64), rcond=None)
        return cls(name, coef, oom_frac)


def paper_models() -> Dict[str, RegressionModel]:
    """The published Hive models.  BHJ OOMs when the hash side exceeds 70%
    of container memory (Hive default-settings behaviour, §III-A)."""
    return {
        "SMJ": RegressionModel("SMJ", PAPER_SMJ),
        "BHJ": RegressionModel("BHJ", PAPER_BHJ, oom_frac=0.7),
    }


# --------------------------------------------------------------------------- #
# Analytic operator simulator (the "profiled system").
# Units: ss/ls = relation sizes in GB, cs = container GB, nc = containers.
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class HiveSimulator:
    """Analytic Hive-on-YARN join timing with the paper's §III structure.

    SMJ: shuffle both sides across nc containers, external sort (spill
    pressure shrinks with container memory), merge.
    BHJ: broadcast small side to every container (cost grows with nc),
    build in-memory hash (fails if it does not fit), stream big side.
    """
    disk_gbps: float = 0.10        # per-container effective scan bandwidth
    net_gbps: float = 0.125        # per-container shuffle bandwidth
    sort_const: float = 0.35
    build_gbps: float = 0.40       # hash build rate
    probe_gbps: float = 0.45
    container_startup_s: float = 1.2
    bhj_mem_frac: float = 0.7      # usable fraction of container memory

    def smj(self, ss: float, ls: float, cs: float, nc: float) -> float:
        total = ss + ls
        shuffle = total / (self.net_gbps * nc)
        per_c = total / nc
        spill = max(1.0, per_c / max(cs * 0.5, 1e-3))
        sort = self.sort_const * total * math.log2(max(total * 8, 2)) \
            * spill / (self.disk_gbps * 80 * nc)
        merge = total / (self.probe_gbps * nc)
        return self.container_startup_s + shuffle + sort + merge

    def bhj(self, ss: float, ls: float, cs: float, nc: float) -> float:
        if ss > self.bhj_mem_frac * cs:
            return math.inf                       # OOM (paper Fig 3a)
        broadcast = ss * nc / (self.net_gbps * nc) + ss / self.net_gbps * 0.1
        build = ss / self.build_gbps              # replicated on every container
        probe = ls / (self.probe_gbps * nc)
        return self.container_startup_s + broadcast + build + probe

    def cost(self, impl: str, ss: float, ls: float, cs: float,
             nc: float) -> float:
        return self.smj(ss, ls, cs, nc) if impl == "SMJ" else \
            self.bhj(ss, ls, cs, nc)

    # -- vectorized twins: identical expressions over (nc, cs) columns ------ #

    def smj_grid(self, ss, ls, cs, nc):
        total = ss + ls
        shuffle = total / (self.net_gbps * nc)
        per_c = total / nc
        spill = torch.clamp_min(per_c / torch.clamp_min(cs * 0.5, 1e-3), 1.0)
        sort = self.sort_const * total * _sort_log2(total) \
            * spill / (self.disk_gbps * 80 * nc)
        merge = total / (self.probe_gbps * nc)
        return self.container_startup_s + shuffle + sort + merge

    def bhj_grid(self, ss, ls, cs, nc):
        broadcast = ss * nc / (self.net_gbps * nc) \
            + _div(ss, self.net_gbps) * 0.1
        build = _div(ss, self.build_gbps)
        probe = ls / (self.probe_gbps * nc)
        out = self.container_startup_s + broadcast + build + probe
        return torch.where(ss > self.bhj_mem_frac * cs, math.inf, out)

    def cost_grid(self, impl: str, ss, ls, cs, nc):
        return self.smj_grid(ss, ls, cs, nc) if impl == "SMJ" else \
            self.bhj_grid(ss, ls, cs, nc)

    # "profile runs" -> training data for regression / decision trees
    def profile(self, ss_grid, cs_grid, nc_grid, ls: float = 74.0):
        xs, y_smj, y_bhj = [], [], []
        for ss in ss_grid:
            for cs in cs_grid:
                for nc in nc_grid:
                    xs.append((ss, cs, nc))
                    y_smj.append(self.smj(ss, ls, cs, nc))
                    b = self.bhj(ss, ls, cs, nc)
                    y_bhj.append(b if math.isfinite(b) else 1e6)
        return xs, y_smj, y_bhj


def simulator_models(sim: HiveSimulator | None = None,
                     ls: float = 74.0) -> Dict[str, RegressionModel]:
    """Regression models trained on simulator profile runs (the paper's
    §VI-A procedure, with the simulator standing in for the cluster) —
    the same profile grid and fit as the reference, so the coefficients
    come out bit-equal."""
    sim = sim or HiveSimulator()
    ss_grid = np.linspace(0.1, 9.0, 14)
    cs_grid = np.arange(1, 11, 1.0)
    nc_grid = np.arange(10, 41, 2.0)
    xs, y_smj, y_bhj = sim.profile(ss_grid, cs_grid, nc_grid, ls=ls)
    finite = [i for i, y in enumerate(y_bhj) if y < 1e5]
    return {
        "SMJ": RegressionModel.fit("SMJ", xs, y_smj),
        "BHJ": RegressionModel.fit(
            "BHJ", [xs[i] for i in finite], [y_bhj[i] for i in finite],
            oom_frac=sim.bhj_mem_frac),
    }


@dataclasses.dataclass
class SimulatorCostModel:
    """Analytic operator model usable directly by the planners (positive,
    1/nc-shaped).  Implements the same .cost interface."""
    name: str
    sim: HiveSimulator = dataclasses.field(default_factory=HiveSimulator)

    def cost(self, ss: float, cs: float, nc: float, ls: float = 74.0) -> float:
        return self.sim.cost(self.name, ss, max(ls, ss), cs, nc)

    def cost_grid(self, ss, ls, configs):
        nc, cs = _split_configs(configs, _dtype_of(ss, ls))
        return self.sim.cost_grid(self.name, ss, _maximum(ls, ss), cs, nc)


def simulator_cost_models(sim: HiveSimulator | None = None
                          ) -> Dict[str, SimulatorCostModel]:
    sim = sim or HiveSimulator()
    return {"SMJ": SimulatorCostModel("SMJ", sim),
            "BHJ": SimulatorCostModel("BHJ", sim)}


def models_from_arrays(spec: dict) -> Dict[str, object]:
    """The port's models from plain data.

    ``spec`` is either ``{"SMJ": {"coef": (7,), "floor": 1e-3,
    "oom_frac": None}, "BHJ": {...}}`` (regression models) or a
    ``HiveSimulator``'s fields (``{"disk_gbps": ..., ...}``, giving the
    analytic ``simulator_cost_models``)."""
    if "SMJ" not in spec:
        return simulator_cost_models(HiveSimulator(**spec))
    return {name: RegressionModel(
        name, np.asarray(m["coef"], dtype=np.float64),
        oom_frac=None if m.get("oom_frac") is None else float(m["oom_frac"]),
        floor=float(m.get("floor", 1e-3))) for name, m in spec.items()}


def monetary_cost(exec_time_s, cs, nc, dollars_per_gb_hour: float = 0.05):
    """Serverless billing (§III-C): pay for total container-GB-hours."""
    return _div(exec_time_s, 3600.0) * cs * nc * dollars_per_gb_hour


# --------------------------------------------------------------------------- #
# Surface descriptors: what a CUDA kernel needs to evaluate a cost fn.
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True, eq=False)
class CostTable:
    """A cost per grid configuration plus the request's ``params[0]``: the
    counterpart of a reference cost fn that looks its costs up in an array
    it captured (the reference's Pallas kernels take such arrays as kernel
    inputs).  ``costs`` has the grid's shape, first dim slowest; ``grids``
    are the dims' values, each ascending."""
    grids: Tuple[np.ndarray, ...]
    costs: np.ndarray
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        shape = tuple(len(g) for g in self.grids)
        if self.costs.shape != shape:
            raise ValueError(f"costs {self.costs.shape} for a grid {shape}")
        if any(np.any(np.diff(g) <= 0) for g in self.grids):
            raise ValueError("CostTable grids must be strictly ascending")

    @classmethod
    def of(cls, cluster, costs) -> "CostTable":
        return cls(tuple(np.asarray(d.grid(), dtype=np.int64)
                         for d in cluster.dims),
                   np.asarray(costs, dtype=np.float64))

    def flat_costs(self, device, dtype=torch.float32) -> torch.Tensor:
        """The costs by flat row id on ``device`` (one copy per device and
        dtype, kept)."""
        key = (torch.device(device), dtype)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.costs.ravel(), dtype=dtype,
                                             device=device)
        return self._on[key]

    def __call__(self, configs, p0):
        cfgs = torch.as_tensor(configs)
        flat = torch.zeros(cfgs.shape[0], dtype=torch.int64,
                           device=cfgs.device)
        for d, g in enumerate(self.grids):
            idx = torch.searchsorted(torch.as_tensor(g, device=cfgs.device),
                                     cfgs[:, d].contiguous())
            flat = flat * len(g) + idx
        dtype = p0.dtype if isinstance(p0, torch.Tensor) else torch.float64
        return self.flat_costs(cfgs.device, dtype)[flat] + p0


SURFACE_KINDS = {"regression": 0, "smj": 1, "bhj": 2, "table": 3,
                 "train": 4, "prefill": 5, "decode": 6}
OBJECTIVES = {"time": 0, "money": 1, "sla": 2, "chip_seconds": 3}
# per-request params each objective reads: [ss, ls] or [ss, ls, target]
PARAMS_OF = {"time": 2, "money": 2, "sla": 3}
ROOFLINE_KINDS = ("train", "prefill", "decode")


@dataclasses.dataclass(frozen=True, eq=False)
class Surface:
    """A shipped batch cost surface as data: the model it evaluates and
    the objective wrapped around it.  DB models take ``time``, ``money``
    (the ``plans._grid_fn`` wrap) or ``sla`` (the
    ``RAQO.resources_for_plan`` wrap) with params ``[ss, ls(, target)]``;
    a ``roofline.RooflineCost`` takes ``time`` or ``chip_seconds`` (the
    ``ShardingPlanner._grid_fn`` wrap) with params ``[chip_budget,
    max_chips]``; a ``CostTable`` takes ``time`` with params ``[offset]``.
    Calling it evaluates the plain torch expression ``fn(configs,
    params)``; ``kind``/``consts``/``flags``/``batch`` are what the CUDA
    kernel takes in its place."""
    model: object
    objective: str = "time"

    def __post_init__(self):
        allowed = {"table": ("time",), "roofline": ("time", "chip_seconds")}
        group = "roofline" if self.kind in ROOFLINE_KINDS else self.kind
        if self.objective not in allowed.get(group, tuple(PARAMS_OF)):
            raise ValueError(f"objective {self.objective!r} does not apply "
                             f"to a {self.kind} surface")

    @functools.cached_property
    def kind(self) -> str:
        m = self.model
        if isinstance(m, RegressionModel):
            return "regression"
        if isinstance(m, SimulatorCostModel):
            return "smj" if m.name == "SMJ" else "bhj"
        if isinstance(m, CostTable):
            return "table"
        if isinstance(m, RooflineCost):
            return m.kind
        raise TypeError(f"no kernel surface for {type(m).__name__}")

    @functools.cached_property
    def n_dims(self) -> Optional[int]:
        """The grid dimension count the surface evaluates (None: any)."""
        if self.kind == "table":
            return len(self.model.grids)
        return 4 if self.kind in ROOFLINE_KINDS else 2

    @functools.cached_property
    def n_params(self) -> int:
        if self.kind == "table":
            return 1
        return 2 if self.kind in ROOFLINE_KINDS else PARAMS_OF[self.objective]

    @property
    def oom(self) -> bool:
        return self.kind == "bhj" or (self.kind == "regression" and
                                      self.model.oom_frac is not None)

    @property
    def flags(self) -> int:
        return self.model.flags() if self.kind in ROOFLINE_KINDS else 0

    @property
    def batch(self) -> int:
        """The global batch a train surface's microbatching must divide."""
        return self.model.shape.global_batch if self.kind == "train" else 0

    def consts(self) -> Tuple[float, ...]:
        """The surface's constants in the kernel's order, each a Python
        float folded exactly as the Python expression folds it (e.g.
        ``disk_gbps * 80``) before the kernel rounds it to float32."""
        m = self.model
        if self.kind in ROOFLINE_KINDS:
            return m.consts()
        if self.kind == "table":
            return ()
        if self.kind == "regression":
            frac = m.oom_frac if m.oom_frac is not None else 0.0
            return tuple(float(v) for v in m.coef) + (float(m.floor),
                                                      float(frac))
        s = m.sim
        if self.kind == "smj":
            return (s.container_startup_s, s.net_gbps, s.sort_const,
                    s.disk_gbps * 80, s.probe_gbps)
        return (s.container_startup_s, s.net_gbps, s.build_gbps,
                s.probe_gbps, s.bhj_mem_frac)

    def __call__(self, cfgs, params):
        if self.kind == "table":
            return self.model(cfgs, params[0])
        if self.kind in ROOFLINE_KINDS:
            return self._roofline(cfgs, params)
        ss, ls = params[0], params[1]
        t = self.model.cost_grid(ss, ls, cfgs)
        if self.objective == "time":
            return t
        nc, cs = _split_configs(cfgs, t.dtype)
        money = monetary_cost(t, cs, nc)
        if self.objective == "money":
            return torch.where(torch.isfinite(t), money, math.inf)
        return torch.where(t <= params[2], money, math.inf)

    def _roofline(self, cfgs, params):
        """``ShardingPlanner._grid_fn``: the step time (or chip-seconds),
        inf where the configuration is infeasible, over the chip budget
        ``params[0]`` or the degraded cluster's ``params[1]``, or (train)
        where pods * dp * microbatch does not divide the global batch."""
        g = self.model.grid(cfgs, dtype=_dtype_of(params[0]))
        cost = g.step_s if self.objective != "chip_seconds" \
            else g.step_s * g.chips
        bad = ~g.feasible
        bad = bad | (g.chips > params[0]) | (g.chips > params[1])
        if self.kind == "train":
            a = torch.as_tensor(cfgs)
            denom = a[:, 0] * a[:, 1] * a[:, 3]
            bad = bad | ((self.model.shape.global_batch % denom) != 0)
        return torch.where(bad, math.inf, cost)


# --------------------------------------------------------------------------- #
# plan-lint registration: expose the shipped DB cost surfaces to the surface
# contract lint (``python -m repro_torch.analysis``).  Factories are lazy —
# nothing here builds a model until the lint evaluates a surface.
# --------------------------------------------------------------------------- #

def _register_lint_surfaces() -> None:
    from repro_torch.analysis.registry import (CostSurface,
                                               register_cost_surface)

    def db_surface(name: str, make_model) -> None:
        def make_fn():
            # params = [ss, ls]: the per-request relation sizes, as
            # OperatorCosting._grid_fn builds its fns
            surface = Surface(make_model(), "time")

            def fn(cfgs, params):
                return surface(cfgs, params)

            fn.surface = surface
            return fn

        def make_cluster():
            from repro_torch.core.cluster import paper_cluster
            return paper_cluster()

        register_cost_surface(CostSurface(
            name=name, domain="db", make_fn=make_fn,
            make_cluster=make_cluster, params=(2.0, 74.0)))

    db_surface("db/paper/SMJ", lambda: paper_models()["SMJ"])
    db_surface("db/paper/BHJ", lambda: paper_models()["BHJ"])
    db_surface("db/sim/SMJ", lambda: simulator_cost_models()["SMJ"])
    db_surface("db/sim/BHJ", lambda: simulator_cost_models()["BHJ"])


_register_lint_surfaces()
