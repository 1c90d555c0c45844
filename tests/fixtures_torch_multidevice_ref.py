"""The reference's side of the multi-device family tests
(test_torch_multidevice_moe.py, test_torch_multidevice_ssm.py): a smoke
model's parameters, trajectory and gradients from ``repro`` in the port's
names, each world of the port's path (``fixtures_torch_multidevice``,
which imports no JAX) run against them, and the placements the
reference's specs give each parameter.

The moe oracle: a moe model's capacity, and so which slots drop, depends
on the group size ``Sg = min(moe_group_size, T // moe_target_groups)``,
and ``plan_for`` sets ``moe_target_groups`` to the world's size, so a
world of n is held against the reference's single device under
``single_device_plan().with_(moe_target_groups=n)``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
from torch.distributed.tensor import Replicate, Shard

import fixtures_torch_multidevice as fx
from fixtures_torch_media import gate_values
from repro.configs import REGISTRY as RREGISTRY
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.launch.specs import plan_for as rplan_for
from repro.models import build_model as rbuild
from repro.models.transformer import model_defs as rmodel_defs
from repro.optim import AdamW as RAdamW
from repro.runtime.steps import TrainState as RTrainState
from repro.runtime.steps import make_loss_fn as rmake_loss_fn
from repro.runtime.steps import make_train_step as rmake_train_step
from repro.sharding import defs_to_specs as rdefs_to_specs
from repro.sharding import single_device_plan as rsingle_device_plan
from repro_torch.models.model import cache_layout, load_jax_params
from repro_torch.models.transformer import layer_stack

B, S = 4, 48
STEPS = range(1, fx.STEPS + 1)


def _flat_tree(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


def _numpy(tree, cfg):
    return {k: v.numpy() for k, v in load_jax_params(
        jax.tree_util.tree_map(np.asarray, tree), cfg).items()}


def run_id(run):
    """A run (arch, config overrides, mesh[, plan overrides]) as a name."""
    arch, over, mesh, *plan_kw = run
    return "-".join([arch] + [f"{k}{v}" for k, v in (over or {}).items()] +
                    ["x".join(map(str, mesh))] +
                    [f"{k}{v}" for kw in plan_kw for k, v in kw.items()])


def trained(d, runs, seed: int = 0, grads: bool = False, replay=(),
            probe: bool = False):
    """Each run (arch, config overrides, mesh[, plan overrides for
    plan_for]) of ``runs`` from the reference's parameters drawn from
    ``seed`` on ``fx.batch``'s batch of seed 1 + ``seed``: {run_id(run):
    (the reference's trajectory [{loss, grad_norm, moe metrics, params,
    grads: the gradients the step takes}] and its first step's gradients
    {name: array}, the world's results: with ``grads`` each step's
    gradients on its own trajectory (``g<step>/``), and for the archs of
    ``replay`` its gradients at the reference's parameters before each
    step (``r<step>/``), with ``probe`` the explicit projections against
    the GSPMD ones on its mesh (``fx.projections``))}; one reference for
    the runs that share a config and a world size, whatever their plan
    overrides."""
    refs, out = {}, {}
    for run in runs:
        arch, over, mesh, *plan_kw = run
        world = int(np.prod(mesh))
        key = (arch, tuple(sorted((over or {}).items())), world)
        tag = run_id((arch, over, (world,)))
        if key not in refs:
            refs[key] = _reference(d, tag, arch, over or {}, world, seed)
        path = d / f"{run_id(run)}.npz"
        fx.spawn(fx.train_worker, world, mesh, str(d / f"{tag}_params.npz"),
                 str(d / f"{tag}_batch.npz"), str(path), 1, arch, over,
                 grads, step_params(d, tag) if arch in replay else (),
                 *(plan_kw or [None]), probe)
        with np.load(path) as f:
            out[run_id(run)] = (refs[key], dict(f))
    return out


def step_params(d, tag):
    """The reference's parameter files before each step of ``tag``'s
    trajectory (its initial ones, then after each step but the last)."""
    return [str(d / (f"{tag}_params.npz" if i == 1 else
                     f"{tag}_params_{i - 1}.npz")) for i in STEPS]


def rsmoke(arch, **over):
    """The reference's smoke config of ``arch`` (a variant's,
    ``fx.VARIANTS``) in float32, with ``over``."""
    base, vover, _ = fx.variant(arch)
    return dataclasses.replace(RREGISTRY[base].smoke(), dtype="float32",
                               **{**vover, **over})


def _reference(d, tag, arch, over, groups, seed=0):
    rcfg = rsmoke(arch, **over)
    cfg = fx.smoke_cfg(arch, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    rmodel = rbuild(rcfg, rsingle_device_plan().with_(
        moe_target_groups=groups))
    params = _open_gates(rmodel.init(jax.random.PRNGKey(seed)), cfg)
    batch = fx.with_positions(arch, fx.batch(cfg, B, S, seed=1 + seed))
    np.savez(d / f"{tag}_params.npz", **_flat_tree(params))
    np.savez(d / f"{tag}_batch.npz", **batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.grad(lambda p: rmake_loss_fn(rmodel)(p, jbatch)[0]))
    opt = RAdamW(lr=fx.LR)
    state = RTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(rmake_train_step(rmodel, opt))
    traj = []
    for i in STEPS:
        g = _numpy(grad(state.params), cfg)
        state, m = step(state, jbatch)
        if i < STEPS[-1]:
            np.savez(d / f"{tag}_params_{i}.npz", **_flat_tree(state.params))
        traj.append({**{k: float(v) for k, v in m.items()},
                     "params": _numpy(state.params, cfg), "grads": g})
    return traj, traj[0]["grads"]


def _open_gates(params, cfg):
    """The reference's vlm parameters with its cross blocks' gates set to
    ``gate_values`` (the port's side opens its own in
    ``fx.train_worker``); other families' as they are."""
    if cfg.family != "vlm":
        return params
    ga, gm = gate_values(cfg)
    return dict(params, cross=dict(params["cross"], gate_attn=jnp.asarray(ga),
                                   gate_mlp=jnp.asarray(gm)))


def grads_agree(got, want):
    """Each tensor's gradient ``got`` against the reference's ``want``
    ({name: array}) as test_torch_train holds gradients: max |diff| over
    max |want| within GRAD_TOL.  [(name, that ratio)] of the tensors
    beyond it, worst first, and the worst ratio of all."""
    rel = {n: float(np.abs(np.asarray(got[n], np.float64) - w).max() /
                    max(float(np.abs(w).max()), 1e-30))
           for n, w in want.items()}
    far = sorted(((n, r) for n, r in rel.items() if r > fx.GRAD_TOL),
                 key=lambda x: -x[1])
    return far, max(rel.values())


def check_step_grads(ref, got, step: int) -> None:
    """The world's gradients at the reference's parameters before
    ``step`` (``trained``'s ``replay``) against the reference's, tensor
    by tensor, as ``grads_agree`` holds them."""
    want = ref[0][step - 1]["grads"]
    far, worst = grads_agree({k: got[f"r{step}/{k}"] for k in want}, want)
    assert not far, (worst, far[:5])


def check_step(arch, ref, got, step: int) -> None:
    """The world's loss, grad norm and every parameter after ``step``
    against the reference's, at test_torch_train's tolerances (the
    parameters as ``fx.params_agree`` holds ``arch``'s)."""
    traj, grad0 = ref
    want = traj[step - 1]
    for k, tol in (("loss", fx.LOSS_TOL), ("grad_norm", fx.GRAD_TOL)):
        rel = abs(float(got[f"{k}_{step}"]) / want[k] - 1)
        assert rel <= tol, f"{k} {rel:.3g} relative (tol {tol})"
    names = sorted(k[len(f"p{step}/"):] for k in got
                   if k.startswith(f"p{step}/"))
    assert names == sorted(want["params"])
    failed = fx.params_agree({k: got[f"p{step}/{k}"] for k in names},
                             want["params"], grad0, step,
                             arch in fx.NEAR_ZERO_RULE)
    assert not failed, failed


def reference_placements(arch, over, mesh):
    """{parameter name: str(placements)} from the reference's
    ``plan_for`` and ``defs_to_specs`` for a mesh of ``mesh``'s shape (its
    PartitionSpec's axes as ``Shard`` on the mesh's dims of size > 1)."""
    rcfg = rsmoke(arch, **(over or {}))
    axes = fx.AXES
    stand_in = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, mesh)))
    rplan = rplan_for(rcfg, RShapeConfig("train", S, B, "train"), stand_in)
    specs = _flat_tree(rdefs_to_specs(rmodel_defs(rcfg), rplan), leaf=tuple)
    active = [a for a, n in zip(axes, mesh) if n > 1] or [axes[-1]]
    # the stacked dims of a leaf: the layers' layer_stack, a vlm's cross
    # blocks' (g,), none elsewhere
    stacked = {"layers": len(layer_stack(rcfg)), "cross": 1}

    def placed(spec):
        out = [Replicate()] * len(active)
        for dim, assign in enumerate(spec):
            for a in (assign,) if isinstance(assign, str) else (assign or ()):
                if a in active:
                    out[active.index(a)] = Shard(dim)
        return str(tuple(out))

    return {(name if name.split("/")[0] in stacked else
             name.replace("/", ".")):
            placed(spec[stacked.get(name.split("/")[0], 0):])
            for name, spec in specs.items()}


def check_placements(arch, over, mesh, got) -> None:
    """Every parameter of the world is placed as the reference's spec of
    its leaf says (a layer's, or a vlm's cross block's, as its stacked
    leaf's, less the stacked dims); every leaf of the reference's has its
    parameters."""
    want = reference_placements(arch, over, mesh)
    placed = {k[len("placed/"):]: str(v) for k, v in got.items()
              if k.startswith("placed/")}
    assert placed
    seen = set()
    for name, p in placed.items():
        top, *rest = name.split(".")
        key = f"{top}/" + "/".join(rest[1:]) if top in ("layers", "cross") \
            else name
        assert p == want[key], (name, p, want[key])
        seen.add(key)
    assert seen == set(want), sorted(set(want) ^ seen)


def flat_cache(rcache, cfg):
    """The reference's cache in the port's flat names and shapes: nested
    ``local``/``global``/``attn``/``self`` leaves flattened (a
    local_global model's ``local`` leaves as ``*_local``), leading layer
    dims merged into one (numpy)."""
    layout = cache_layout(cfg, 1, 1, None)
    out = {}
    for key, leaf in _flat_tree(rcache).items():
        *top, name = key.split("/")
        name += "_local" if top == ["local"] else ""
        arr, n = np.asarray(leaf), len(layout[name][0])
        out[name] = arr if n == 1 else \
            arr.reshape((-1,) + arr.shape[arr.ndim - n + 1:])
    return out


def cache_placements(arch, B, mesh, plan_kw=None):
    """{port cache leaf name: str(placements)} from the reference's
    ``Model.cache_specs`` under its ``plan_for`` prefill and decode plans
    (which place the cache alike: asserted) at global batch B, on a mesh
    of ``mesh``'s shape (its axes as ``Shard`` on the dims of size > 1),
    a leaf's stacked layer dims merged into one.  A Mamba1 hybrid's
    ``ssm`` leaf takes the reference's spec of a Mamba1 state (its
    hybrid cache holds Mamba2's whatever the blocks: ROADMAP §3)."""
    rcfg = rsmoke(arch)
    axes = fx.AXES
    stand_in = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, mesh)))
    specs = []
    for kind in ("prefill", "decode"):
        rplan = rplan_for(rcfg, RShapeConfig(kind, fx.SERVE_CACHE, B, kind),
                          stand_in, **(plan_kw or {}))
        specs.append(_flat_tree(rbuild(rcfg, rplan).cache_specs(),
                                leaf=tuple))
    assert specs[0] == specs[1]
    active = [a for a, n in zip(axes, mesh) if n > 1] or [axes[-1]]
    layout = cache_layout(fx.smoke_cfg(arch), 1, 1, None)
    out = {}
    for key, spec in specs[0].items():
        *top, name = key.split("/")
        name += "_local" if top == ["local"] else ""
        if name == "ssm" and rcfg.family == "hybrid" and \
                rcfg.ssm_version == 1:
            spec = tuple(rplan.spec((None, "batch", "inner", None)))
        # the port's leaf: the reference's leading layer dims merged
        spec = spec[len(spec) - len(layout[name][0]):]
        placed = [Replicate()] * len(active)
        for dim, assign in enumerate(spec):
            for a in (assign,) if isinstance(assign, str) else (assign or ()):
                if a in active:
                    placed[active.index(a)] = Shard(dim)
        out[name] = str(tuple(placed))
    return out


def served(d, mesh, cases):
    """Each serving case (arch, B, plan overrides) on one world of
    ``mesh``'s shape against the reference's single device, from the
    reference's parameters (seed 0, the vlm's gates opened): its prefill
    of ``fx.serve_inputs``'s prompts into a cache of ``fx.SERVE_CACHE``
    slots (moe groups aimed at the world's size, as the prefill plan aims
    them), then ``fx.SERVE_NEW`` decode steps (groups aimed at 1), each
    fed the reference's greedy token (the audio family the input
    frames).  {tag: (the reference's {prefill, decode<t>: logits,
    tokens<t>: the token fed at step t, cache/<name>: the prefill cache
    in the port's names}, the world's results (``fx.serve_worker``))}."""
    world = int(np.prod(mesh))
    refs, worker_cases = {}, []
    for arch, B, plan_kw in cases:
        tag = f"{arch}-B{B}" + "".join(f"-{v}" for v in
                                      (plan_kw or {}).values())
        rcfg = rsmoke(arch)
        cfg = fx.smoke_cfg(arch)
        params = _open_gates(
            jax.jit(rbuild(rcfg).init)(jax.random.PRNGKey(0)), cfg)
        # the plan overrides that set the groups
        groups = {k: v for k, v in (plan_kw or {}).items()
                  if k == "moe_group_size"}
        pre = rbuild(rcfg, rsingle_device_plan().with_(
            moe_target_groups=world, **groups))
        dec = rbuild(rcfg, rsingle_device_plan().with_(**groups))
        batch, frames = fx.serve_inputs(arch, B)
        jb = {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "positions")
                             else jnp.float32) for k, v in batch.items()}
        # jitted: one compile of each step where eager runs recompile
        # every scan body a call
        logits, rcache = jax.jit(lambda p, b: pre.prefill(
            p, b, cache_len=fx.SERVE_CACHE))(params, jb)
        decode_step = jax.jit(dec.decode_step)
        ref = {"prefill": np.asarray(logits)}
        ref.update({f"cache/{k}": v
                    for k, v in flat_cache(rcache, cfg).items()})
        inputs = {f"prompt/{k}": v for k, v in batch.items()}
        for t in range(fx.SERVE_NEW):
            if frames is None:
                tok = np.argmax(np.asarray(logits), -1)[:, None]
                step = {"tokens": tok.astype(np.int32)}
                ref[f"tokens{t}"] = tok[:, 0]
            else:
                step = {"embeddings": frames[:, t:t + 1]}
            inputs.update({f"step{t}/{k}": v for k, v in step.items()})
            q_pos = jnp.asarray(fx.next_positions(batch) + t)
            logits, rcache = decode_step(
                params, rcache, {k: jnp.asarray(v) for k, v in
                                 step.items()}, q_pos)
            ref[f"decode{t}"] = np.asarray(logits)
        np.savez(d / f"{tag}_params.npz", **_flat_tree(params))
        np.savez(d / f"{tag}_inputs.npz", **inputs)
        refs[tag] = ref
        worker_cases.append((tag, arch, B, plan_kw,
                             str(d / f"{tag}_params.npz"),
                             str(d / f"{tag}_inputs.npz")))
    path = d / "served.npz"
    fx.spawn(fx.serve_worker, world, mesh, worker_cases, str(path))
    with np.load(path) as f:
        got = dict(f)
    return {tag: (refs[tag], {k[len(tag) + 1:]: v for k, v in got.items()
                              if k.startswith(tag + "/")})
            for tag in refs}


def served_logits(ref, got) -> str:
    """'' when a served case's prefill logits lie within 1e-4 of the
    reference's and each decode step's within 1e-3 (atol and rtol,
    test_torch_serve's tolerances), with the greedy tokens equal; else
    what differs."""
    failed = []
    for key, tol in [("prefill", 1e-4)] + [(f"decode{t}", 1e-3)
                                           for t in range(fx.SERVE_NEW)]:
        try:
            np.testing.assert_allclose(got[key], ref[key], atol=tol,
                                       rtol=tol)
        except AssertionError as e:
            failed.append(f"{key}: {e}")
        if not np.array_equal(np.argmax(got[key], -1),
                              np.argmax(ref[key], -1)):
            failed.append(f"{key}: greedy tokens differ")
    return "; ".join(failed)


def served_cache(ref, got) -> str:
    """'' when the prefill cache, gathered, equals the reference's (in the
    port's names, ``flat_cache``) within 1e-5 leaf for leaf."""
    names = sorted(k[len("cache/"):] for k in ref if k.startswith("cache/"))
    if names != sorted(k[len("cache/"):] for k in got
                       if k.startswith("cache/")):
        return f"cache leaves differ from the reference's {names}"
    return "; ".join(
        f"prefill cache {n} differs (max |diff| "
        f"{np.abs(got[f'cache/{n}'] - ref[f'cache/{n}']).max()})"
        for n in names if not np.allclose(got[f"cache/{n}"],
                                          ref[f"cache/{n}"], atol=1e-5,
                                          rtol=1e-5))


def served_placements(run, ref, got) -> str:
    """'' when every cache leaf is placed as the reference's
    ``cache_specs`` says (``cache_placements``), and each rank holds a
    chunk of ``k`` shorter than the whole along its sequence (an ssm
    model's ``ssm`` along its channels), the ranks' chunks summing to the
    whole, each in storage of its own."""
    arch, B, mesh, plan_kw = run
    want = cache_placements(arch, B, mesh, plan_kw)
    placed = {k[len("placed/"):]: str(v) for k, v in got.items()
              if k.startswith("placed/")}
    if placed != want:
        return f"cache placements {placed} != {want}"
    whole = ref["cache/k" if "cache/k" in ref else "cache/ssm"].shape[2]
    if not got["k_local"][1] < whole or not got["k_chunks"]:
        return (f"local lengths {got['k_local']} of {whole}, chunks "
                f"{got['k_chunks']}")
    return ""


def served_paths(arch, got) -> str:
    """'' when K7 ran under ``local_map`` once an attention block in
    prefill and never in decode, and every cache write and every decode
    step's attention ran on the sharded cache."""
    n, new = fx.attention_layers(fx.smoke_cfg(arch)), fx.SERVE_NEW
    counts = {(phase, k): int(got[f"{phase}_path/{k}"])
              for phase in ("prefill", "decode") for k in SERVE_PATHS}
    want = dict(zip(counts, (n, 0, n, 0, new * n, new * n)))
    return "" if counts == want else f"sharded paths {counts}, want {want}"


# K7's local_map, decode attention and the cache writes on a sharded cache
SERVE_PATHS = ("_flash_attention_sharded", "_decode_attention_sharded",
               "_write_cache_sharded")


def main(argv=None) -> int:
    """A non-moe ``arch``'s worlds at (1, 2, 2) and (1, 1, 4) and its
    one-device path, each against the reference from ``--seed``'s
    parameters and batch: each step's loss and grad norm error, the
    verdict of ``check_step``, every element beyond PARAM_TOL with its
    first gradient over GRAD_TOL x max, and the gradients the step takes
    against the reference's, tensor by tensor (``grads_agree``: the worst
    max |diff| / max |g| and the tensors beyond GRAD_TOL).  Exits 1 if a
    ``check_step`` or a gradient check fails.

        PYTHONPATH=src:tests JAX_PLATFORMS=cpu \\
            python tests/fixtures_torch_multidevice_ref.py ARCH [--seed N]
    """
    import argparse
    import tempfile
    from pathlib import Path
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        runs = [(a.arch, None, m) for m in ((1, 2, 2), (1, 1, 4))]
        out = trained(d, runs, a.seed, grads=True, replay=(a.arch,))
        ref = next(iter(out.values()))[0]
        worlds = [(run_id(r), out[run_id(r)][1]) for r in runs]
        tag = run_id((a.arch, None, (4,)))
        with np.load(d / f"{tag}_batch.npz") as f:
            one, one_grads = fx.one_device_trajectory(
                dict(f), arch=a.arch,
                params_npz=d / f"{tag}_params.npz")
        worlds.append(("one device", {
            k: v for i, ((loss, gnorm, params), g) in enumerate(
                zip(one, one_grads), 1)
            for k, v in [(f"loss_{i}", loss), (f"grad_norm_{i}", gnorm)] +
            [(f"p{i}/{n}", p) for n, p in params.items()] +
            [(f"g{i}/{n}", x) for n, x in g.items()]}))
        # the one device's gradients at the reference's parameters before
        # each step, as the worlds' replay gives them
        with np.load(d / f"{tag}_batch.npz") as f:
            worlds[-1][1].update({
                f"r{i}/{k}": v
                for i, pnpz in enumerate(step_params(d, tag), 1)
                for k, v in fx.one_device_grads(dict(f), pnpz,
                                                a.arch).items()})
        for name, got in worlds:
            for i in STEPS:
                want = ref[0][i - 1]
                try:
                    check_step(a.arch, ref, got, i)
                    verdict = "ok"
                except AssertionError as e:
                    verdict, bad = f"FAILS {e}", bad + 1
                far, _ = fx.beyond_tol(
                    {k: got[f"p{i}/{k}"] for k in want["params"]},
                    want["params"], ref[1])
                print(f"{a.arch} seed {a.seed} {name} step {i}: loss rel "
                      f"{abs(got[f'loss_{i}'] / want['loss'] - 1):.3g}, "
                      f"grad norm rel "
                      f"{abs(got[f'grad_norm_{i}'] / want['grad_norm'] - 1):.3g}"
                      f", {len(far)} beyond PARAM_TOL: {verdict}",
                      flush=True)
                for n, idx, diff, r in far[:8]:
                    print(f"  {n}{idx}: {diff:.3g}, |g1| {r:.3g} x "
                          f"GRAD_TOL max", flush=True)
                gfar, worst = grads_agree(
                    {k: got[f"g{i}/{k}"] for k in want["grads"]},
                    want["grads"])
                print(f"  gradients of step {i} on its own trajectory: "
                      f"worst max |diff| / max |g| {worst:.3g} (GRAD_TOL "
                      f"{fx.GRAD_TOL}), {len(gfar)} tensors beyond",
                      flush=True)
                # the same gradients at the reference's parameters of step
                # i: the ops alone, without the earlier steps' updates
                gfar, worst = grads_agree(
                    {k: got[f"r{i}/{k}"] for k in want["grads"]},
                    want["grads"])
                bad += bool(gfar)
                print(f"  gradients of step {i} at the reference's "
                      f"parameters: worst {worst:.3g}, {len(gfar)} tensors "
                      f"beyond: {'ok' if not gfar else gfar[:4]}",
                      flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
