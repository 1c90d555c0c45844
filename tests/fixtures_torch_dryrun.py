"""Per-device dot FLOPs of the smoke cells of the reference's
``test_multi_device_lowering_subprocess``, in the port and in the
reference, each side in a process of its own.

The cells: smollm-360m, mixtral-8x7b, falcon-mamba-7b and zamba2-2.7b,
their smoke configs, a train step and a decode step of
``ShapeConfig("t", 64, 8, kind)`` on a (2, 2, 2) ("pod", "data",
"model") mesh under ``plan_for``'s plan.

- ``reference_flops()`` runs in a process with 8 forced host devices: it
  lowers and compiles each cell as the reference's dry run does and
  returns ``hlo_analysis.analyze(...).dot_flops`` and the dot FLOPs by
  the HLO ``op_name`` of each dot (loop-corrected as ``analyze`` does).
- ``port_flops()`` runs over a fake world of 8 (``launch.mesh.
  fake_world``) and traces rank 0's step as ``launch.dryrun`` does,
  returning ``StepStats.dot_flops`` and the dot FLOPs by port function
  (with ``again``, its first cell traced a second time, ``<cell>/again``).

    PYTHONPATH=src:tests python tests/fixtures_torch_dryrun.py --side ref
    PYTHONPATH=src:tests python tests/fixtures_torch_dryrun.py --side port
    PYTHONPATH=src:tests python tests/fixtures_torch_dryrun.py  # the table

print them as JSON, or (no ``--side``) both sides in parallel as the
table of ratios, each cell's dot FLOPs by phase (``phases``) and the
largest items of its breakdown, the source of ``PERF.md``'s itemised
gaps (``--archs a,b`` keeps some archs, ``--top N`` items a side).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("smollm-360m", "mixtral-8x7b", "falcon-mamba-7b", "zamba2-2.7b")
KINDS = ("train", "decode")
CELLS = [(a, k) for a in ARCHS for k in KINDS]
SEQ, BATCH = 64, 8
# the port's products that the reference does not compute: faults of the
# port (ROADMAP section 3), each with the dot FLOPs a device it adds to
# its cell, measured by ``test_torch_dryrun.py``'s pins of them
FAULTS = {
    "falcon-mamba-7b/train": {
        # x_proj's backward takes all of d_inner on each rank of "model"
        "x_proj backward whole": 1_572_864},
    "zamba2-2.7b/train": {
        # in_proj_bc's backward takes both of B's and C's halves
        "in_proj_bc backward whole": 3_145_728,
        # the SSD's C.B^T on every rank of "model" (GSPMD splits its rows)
        "ssd C.B^T whole": 3_145_728,
        # the SSD's last state update, which a train step drops
        "ssd dropped state update": 3_145_728},
}
# port / reference dot FLOPs a device, the faults' FLOPs taken out (so a
# repair leaves the ratio where it is): each band holds the ratio that
# PERF.md (section 6) itemises; a decode step computes the same
# products on both sides
BANDS = {"smollm-360m/train": (1.05, 1.075),
         "mixtral-8x7b/train": (0.925, 0.95),
         "falcon-mamba-7b/train": (1.08, 1.105),
         "zamba2-2.7b/train": (0.995, 1.015),
         **{f"{a}/decode": (0.9999, 1.0001) for a in ARCHS}}


def cells(archs):
    return [(a, k) for a, k in CELLS if a in archs]


def reference_flops(archs=ARCHS):
    """{"<arch>/<kind>": {"dot_flops": x, "by_op": {op_name: x}}}."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import REGISTRY
    from repro.configs.base import ShapeConfig
    from repro.launch import hlo_analysis as H
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import (batch_shardings, batch_specs,
                                    decode_input_specs, plan_for,
                                    serve_param_specs, train_state_specs)
    from repro.models.model import build_model
    from repro.optim import AdamW
    from repro.runtime.steps import make_train_step

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))

    def ns(t):
        return jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), t,
            is_leaf=lambda x: isinstance(x, P))
    out = {}
    for arch, kind in cells(archs):
        cfg = REGISTRY[arch].smoke()
        shape = ShapeConfig("t", SEQ, BATCH, kind)
        plan = plan_for(cfg, shape, mesh)
        model = build_model(cfg, plan)
        with mesh:
            if kind == "train":
                st, ss = train_state_specs(model)
                fn = make_train_step(model, AdamW(lr=1e-4))
                comp = jax.jit(fn, in_shardings=(
                    ns(ss), batch_shardings(cfg, shape, mesh, plan)),
                    out_shardings=(ns(ss), None)).lower(
                    st, batch_specs(cfg, shape)).compile()
            else:
                pstruct = serve_param_specs(cfg, model)
                inputs, cache, qpos = decode_input_specs(cfg, shape, model)
                in_shard = jax.tree_util.tree_map(
                    lambda s: NamedSharding(mesh, plan.spec(
                        ("batch", None) if s.ndim == 2
                        else ("batch", None, None))), inputs)
                comp = jax.jit(
                    lambda p, c, i, q: model.decode_step(p, c, i, q),
                    in_shardings=(ns(model.param_specs()),
                                  ns(model.cache_specs()), in_shard,
                                  NamedSharding(mesh, plan.spec(("batch",)))),
                    out_shardings=None).lower(pstruct, cache, inputs,
                                              qpos).compile()
        text = comp.as_text()
        out[f"{arch}/{kind}"] = {"dot_flops": H.analyze(text).dot_flops,
                                 "by_op": _ref_by_op(H, text)}
    return out


def _ref_by_op(H, text):
    """Dot FLOPs by the HLO op_name of each dot, multiplied through the
    loop nest as ``hlo_analysis.analyze`` multiplies them."""
    comps = H.parse_hlo(text)
    referenced = set()
    for c in comps.values():
        for cond, body in c.while_calls:
            referenced.update((cond, body))
        referenced.update(c.call_targets)
    mult = {c: 1.0 for c in comps if c not in referenced}
    changed = True
    while changed:
        changed = False
        for c in comps.values():
            if c.name not in mult:
                continue
            m = mult[c.name]
            for cond, body in c.while_calls:
                t = H.trip_count(comps[body], comps) if body in comps else 1
                for target, f in ((body, m * t), (cond, m * (t + 1))):
                    if target in comps and mult.get(target, 0.0) < f:
                        mult[target], changed = f, True
            for t_ in c.call_targets:
                if t_ in comps and mult.get(t_, 0.0) < m:
                    mult[t_], changed = m, True
    by = {}
    for c in comps.values():
        for op in c.ops:
            if op.kind == "dot" and c.name in mult:
                md = re.search(r'op_name="([^"]*)"', op.attrs)
                name = md.group(1) if md else "?"
                by[name] = by.get(name, 0.0) + mult[c.name] * H._dot_flops(op)
    return by


def port_flops(archs=ARCHS, again: bool = False):
    """{"<arch>/<kind>": {"dot_flops": x, "by_op": {port function: x}}};
    with ``again`` the first cell traced a second time as well."""
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.specs import plan_for
    out = {}
    todo = cells(archs)
    with fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        # the first cell twice: its first trace warms DTensor's caches
        for i, (arch, kind) in enumerate(todo + todo[:1] * again):
            cfg = REGISTRY[arch].smoke()
            shape = ShapeConfig("t", SEQ, BATCH, kind)
            rec = dryrun._trace(cfg, shape, plan_for(cfg, shape, mesh), mesh)
            hlo = rec["hlo"]
            out[f"{arch}/{kind}" + ("/again" if i == len(todo) else "")] = {
                "dot_flops": hlo["dot_flops_per_device"],
                "by_op": hlo["dot_flops_by_site"],
                "traffic": hlo["traffic_bytes_per_device"],
                "collectives": hlo["collective_counts"]}
    return out


def products(arch: str):
    """The port's products in ``arch``'s smoke train cell at (2, 2, 2) on
    rank 0, traced in this process as ``port_flops`` traces it: ({(bwd,
    site, op, lhs shape, rhs shape): dot FLOPs} of every local matrix
    product, ``bwd`` whether it ran inside the backward, which takes the
    rematerialised forward and the backward's own products; {(bwd,
    equation, operand shapes): FLOPs} of every ``torch.einsum`` on plain
    tensors, 2 * numel(result) * the contracted size)."""
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import step_analysis as H
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.specs import plan_for
    dots, sums = {}, {}
    count, einsum = H.StepAnalysis._count, torch.einsum

    def in_bwd():
        return torch._C._current_graph_task_id() != -1

    def spy(self, func, args, kwargs, out):
        name = func._overloadpacket.__name__
        if name in H._DOTS and not self._quiet:
            lhs, rhs = args[H._DOTS[name]], args[H._DOTS[name] + 1]
            key = (in_bwd(), H._site(), name, tuple(lhs.shape),
                   tuple(rhs.shape))
            dots[key] = dots.get(key, 0.0) + \
                2.0 * out.numel() * lhs.shape[-1]
        return count(self, func, args, kwargs, out)

    def spy_einsum(eq, *ops):
        out = einsum(eq, *ops)
        ins, res = eq.replace(" ", "").split("->")
        size = {c: n for term, t in zip(ins.split(","), ops)
                for c, n in zip(term, t.shape)}
        contracted = 1
        for c in set(ins.replace(",", "")) - set(res):
            contracted *= size[c]
        key = (in_bwd(), eq, tuple(tuple(t.shape) for t in ops))
        sums[key] = sums.get(key, 0.0) + 2.0 * out.numel() * contracted
        return out

    H.StepAnalysis._count, torch.einsum = spy, spy_einsum
    try:
        with fake_world(8):
            mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
            cfg = REGISTRY[arch].smoke()
            shape = ShapeConfig("t", SEQ, BATCH, "train")
            dryrun._trace(cfg, shape, plan_for(cfg, shape, mesh), mesh)
    finally:
        H.StepAnalysis._count, torch.einsum = count, einsum
    return dots, sums


def check_band(got, cell: str) -> None:
    """``cell``'s port / reference dot FLOPs in ``got`` (``collect``'s), the
    port's without its faults' (``FAULTS``), lie in its band (``BANDS``,
    no wider than 0.3)."""
    port = got["port"][cell]["dot_flops"] - sum(FAULTS.get(cell, {}).values())
    ref = got["ref"][cell]["dot_flops"]
    lo, hi = BANDS[cell]
    assert hi - lo <= 0.3 and port > 0
    assert lo <= port / ref <= hi, (cell, port, ref, port / ref)


def phases(by_op, side: str):
    """Dot FLOPs by phase: the forward, its rematerialisation in the
    backward, and the backward's own products.  The reference's phase is
    in its op_name (``transpose(jvp())`` the backward, under it
    ``rematted_computation`` the remat); the port's in its site ("bwd "
    the backward; there a model function's product is the remat, and the
    caller of ``torch.autograd.grad`` or a kernel's backward the
    backward's own)."""
    out = {}
    for name, f in by_op.items():
        if side == "ref":
            k = "forward" if "transpose(" not in name else (
                "remat" if "rematted_computation" in name else "backward")
        elif not name.startswith("bwd "):
            k = "forward"
        else:
            own = name.startswith(("bwd runtime.", "bwd ?")) or \
                name.endswith("_backward")
            k = "backward" if own else "remat"
        out[k] = out.get(k, 0.0) + f
    return out


def run_side(side: str, archs=ARCHS, again: bool = False):
    """Popen of this file's ``--side`` for ``archs`` in a process of its
    own (the reference's with 8 forced host devices)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, __file__, "--side", side,
                             "--archs", ",".join(archs)] +
                            ["--again"] * again,
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def collect(procs, timeout: float = 600):
    """{side: result} of ``run_side``'s processes; raises on a failure."""
    out = {}
    for side, p in procs.items():
        so, se = p.communicate(timeout=timeout)
        if p.returncode:
            raise RuntimeError(f"{side} side failed:\n{se[-4000:]}")
        out[side] = json.loads(so.strip().splitlines()[-1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=("ref", "port"))
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--again", action="store_true",
                    help="the port's first cell traced twice")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    archs = tuple(args.archs.split(","))
    if args.side:
        res = reference_flops(archs) if args.side == "ref" else \
            port_flops(archs, args.again)
        print(json.dumps(res))
        return 0
    got = collect({s: run_side(s, archs) for s in ("ref", "port")})
    for cell in (f"{a}/{k}" for a, k in cells(archs)):
        r, p = got["ref"][cell], got["port"][cell]
        again = got["port"].get(f"{cell}/again")
        if again and again["dot_flops"] != p["dot_flops"]:
            print(f"{cell}: a second trace counts {again['dot_flops']:,.0f}")
        print(f"{cell}: port {p['dot_flops']:,.0f} reference "
              f"{r['dot_flops']:,.0f} ratio "
              f"{p['dot_flops'] / r['dot_flops']:.4f}")
        pp, rp = phases(p["by_op"], "port"), phases(r["by_op"], "ref")
        print("    by phase (port / reference): " + ", ".join(
            f"{k} {pp.get(k, 0):,.0f} / {rp.get(k, 0):,.0f}"
            for k in ("forward", "remat", "backward")))
        for side, d in (("port", p), ("ref", r)):
            for name, f in sorted(d["by_op"].items(),
                                  key=lambda kv: -kv[1])[:args.top]:
                print(f"    {side:4s} {f:>16,.0f}  {name[-100:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
