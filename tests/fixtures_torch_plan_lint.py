"""Deliberately broken cost surfaces and hot paths for the port's plan-lint
golden tests (tests/test_torch_analysis.py), written in torch.

Every function here violates exactly one plan-lint contract (named in its
docstring), or none where the docstring says CLEAN, so the tests can
assert the precise rule id, severity and line the analyzer must emit —
and nothing else.  Shipped code imports none of these; the hot-path
fixtures live in this file (outside ``src/repro_torch``) so ``lint_tree``
never sees them.
"""
import numpy as np
import torch

from repro_torch.analysis.registry import hot_path
from repro_torch.obs import get_tracer

_obs = get_tracer()


# -------------------------- surface-lint fixtures -------------------------- #

def fn_host_branch(configs, params):
    """rule host-branch: Python branch on a tensor comparison."""
    if configs[0, 0] > 0:
        return configs[:, 0].to(params.dtype)
    return configs[:, 0].to(params.dtype) * 2.0


def fn_dtype_follow(configs, params):
    """rule dtype-follow: int column x Python float is torch's default
    float32, whatever the params' dtype."""
    return configs[:, 0] * 2.0


def fn_low_precision(configs, params):
    """rule dtype: float16 intermediate on the argmin path."""
    c = configs[:, 0].to(torch.float16)
    return (c * params[0]).to(params.dtype)


def fn_multi_output(configs, params):
    """rule dtype: two outputs where the contract wants one vector."""
    c = configs[:, 0].to(params.dtype)
    return c, c * params[0]


def fn_wrong_shape(configs, params):
    """rule dtype: full (n_configs, n_dims) grid instead of (n_configs,)."""
    return configs.to(params.dtype) * params[0]


def fn_int_output(configs, params):
    """rule dtype: integer cost vector (inf mask and argmin need float)."""
    return configs[:, 0] * 2


def fn_cross_reduce(configs, params):
    """rule cross-config-reduce: sum across the config axis couples every
    row's cost to the chunk geometry."""
    costs = configs[:, 0].to(params.dtype)
    return costs + torch.sum(costs)


def fn_cross_sort(configs, params):
    """rule cross-config-reduce: a sort along the config axis."""
    costs = configs[:, 0].to(params.dtype) * params[0]
    return torch.sort(costs).values


def make_fn_scalar_capture():
    """rule closure-capture (warn): 0-d tensor captured from the scope."""
    scalar = torch.tensor(3.5, dtype=torch.float64)

    def fn(configs, params):
        return configs[:, 0].to(params.dtype) + scalar

    return fn


def make_fn_array_capture():
    """rule closure-capture (error): a captured per-config array has no
    kernel input to ride on."""
    table = torch.arange(7, dtype=torch.float64)

    def fn(configs, params):
        return configs[:, 0].to(params.dtype) + table.to(params.dtype)

    return fn


def make_fn_clean():
    """CLEAN: dtype-following, elementwise, param-driven — clamp_min,
    min.other and a reduction over the dims axis are not cross-config."""

    def fn(configs, params):
        a = configs[:, 0].to(params.dtype)
        b = configs[:, 1].to(params.dtype)
        span = configs.to(params.dtype).sum(dim=1)
        cost = (a - params[0]) ** 2 + b * params[1] + 0.0 * span
        return torch.min(torch.clamp_min(cost, 1e-3), cost + 1.0)

    return fn


# --------------------------- hot-path fixtures ----------------------------- #

@hot_path("fixture: per-iteration sync in a chunk loop")
def hot_loop_sync(values):
    out = []
    for v in values:
        out.append(v.item())
    return values.cpu()


@hot_path("fixture: allowed single fold")
def hot_allowed_fold(values):
    # plan-lint: allow(host-sync): fixture demonstrates a justified fold
    return float(values[0])


@hot_path("fixture: two depth-zero syncs against a folds=1 budget",
          folds=1)
def hot_over_budget(a, b):
    ca = a.cpu()
    cb = b.tolist()
    return ca, cb


@hot_path("fixture: copied host matrix decoded in a loop", folds=1)
def hot_host_tracked_decode(device_costs):
    costs = device_costs.cpu().numpy()
    out = []
    for q in range(3):
        out.append(float(costs[q]))
    return out


@hot_path("fixture: tuple target of one host copy, decoded in a loop",
          folds=1)
def hot_tuple_host_decode(outs):
    idx, cost = (torch.cat([o[k].cpu() for o in outs]).numpy()
                 for k in range(2))
    res = []
    for q in range(len(idx)):
        res.append((int(idx[q]), float(cost[q])))
    return res


@hot_path("fixture: numpy on host params is no sync", folds=0)
def hot_numpy_params(params_many):
    pm = np.asarray(params_many, dtype=np.float64)
    for row in pm:
        yield float(row[0]), pm.tolist()


@hot_path("fixture: int() and bool() are not flagged", folds=0)
def hot_int_bool(chunks):
    n = 0
    for c in chunks:
        n += int(c)
        if bool(c):
            n += 1
    return n


@hot_path("fixture: every depth-zero copy and wait")
def hot_sync_kinds(x, ev):
    a = x.to("cpu")
    b = x.to(device="cpu")
    c = x.to(torch.device("cpu"))
    torch.cuda.synchronize()
    ev.synchronize()
    return a, b, c


@hot_path("fixture: data-dependent shapes in a loop")
def hot_data_dependent(xs, mask):
    out = []
    for x in xs:
        out.append(torch.nonzero(x))
        out.append(x.nonzero())
        out.append(torch.masked_select(x, mask))
        out.append(torch.unique(x))
    return out


def cold_loop_sync(values):
    """Not @hot_path: identical syncs must NOT be flagged here."""
    return [v.item() for v in values]


@hot_path("fixture: traced hot loop — obs span/metric payload is "
          "sync-free", folds=0)
def hot_traced_clean(chunks, host_costs):
    """GOLDEN: instrumented hot path that must lint CLEAN with zero
    pragmas: every would-be sync below sits inside obs calls."""
    total = 0
    for i, c in enumerate(chunks):
        with _obs.span("chunk", cat="fixture") as sp:
            total += c
            if sp:
                sp.set(index=i, cost=host_costs[i].item())
        _obs.instant("tick", value=float(host_costs[i]))
    _obs.complete("done", 0, total=float(total))
    return total


@hot_path("fixture: obs exemption must not leak past the obs call")
def hot_traced_still_syncs(chunks):
    """The loop .item() OUTSIDE any obs call must still warn."""
    out = []
    for c in chunks:
        _obs.instant("tick")
        out.append(c.item())
    return out


@hot_path("fixture: admission loop — per-ticket obs payloads are "
          "sync-free, one wave readback inside the budget", folds=1)
def hot_admission_loop(arrivals, wave_costs):
    """GOLDEN: the streaming service's admission-loop shape
    (repro_torch.service.admission ``StreamingPlannerService.step``):
    per ticket host bookkeeping plus obs stamps (exempt), and the wave
    pays exactly ONE depth-zero readback."""
    admitted = 0
    for a in arrivals:
        _obs.instant("service.submit", tenant=a,
                     latency_us=float(wave_costs[a]))
        admitted += 1
    wave = wave_costs.cpu()             # the wave's single host copy
    _obs.complete("service.wave", 0, admitted=admitted,
                  total=float(wave.sum()))
    return admitted


# reason-less pragma below: must surface as pragma-no-reason
# plan-lint: allow(host-sync)
_PRAGMA_NO_REASON_LINE_MARKER = True
