"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell
on the reference's production meshes, with no device (the port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out artifacts/port_dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --summary \\
        --out artifacts/port_dryrun          # the records as a table

Per cell it joins a "fake" process group of 256 or 512 ranks as rank 0
(``launch.mesh.fake_world``), builds the production mesh
(``make_production_mesh``) and the cell's plan (``plan_for``), and, under
``FakeTensorMode``, runs the real step: ``make_train_step`` on the
``batch_specs`` batch for train shapes (the model and ``init_train_state``
built first), ``make_prefill_step`` on the batch without labels for
prefill shapes and ``make_decode_step`` on ``decode_input_specs``'
inputs, a cache from ``init_cache`` and q_pos for decode shapes (both
with bfloat16 parameters, the reference's ``serve_param_specs``).  The
step runs under ``step_analysis.StepAnalysis``, which counts every
operation on the rank's local shards: dot FLOPs, traffic, collectives by
kind.  Fake tensors hold no memory and the fake group moves nothing, so
a 512-device cell runs in seconds on one CPU.

It is the one entry point of the port whose tensors are fake: it needs no
GPU and asks for none, and no kernel is built or launched (the kernels'
fake inputs take their shape-only path, ``launch.shape_only``, and
``kernels.build`` is never reached).

A record keeps the reference's keys.  ``lower_s`` is the seconds to
build the model and its state (the reference's lowering), ``compile_s``
the seconds of the traced step (its compile).  ``memory_analysis`` is
the rank's bytes: ``argument_bytes`` the local shards of the parameters,
optimizer state and cache and the whole batch (every rank of the port
takes the whole batch and shards it), ``output_bytes`` the step's new
outputs, ``temp_bytes`` the peak of the bytes the step allocated and
still held (``StepStats.peak_bytes``), ``alias_bytes`` the arguments
updated in place and returned.  ``cost_analysis`` holds the total of
``torch.utils.flop_counter``'s registry.  ``hlo`` holds the
``StepStats`` under the reference's names; there is no HLO, the key is
kept so that a reader of the reference's records reads these.  The
records go to ``artifacts/port_dryrun`` by default (never the reference's
``artifacts/dryrun``).  A failing cell is ``"status": "error"`` with the
exception's words, and ``main`` returns 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, get_shape,
                                 shape_applicable)
from repro_torch.launch import step_analysis
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.specs import (batch_specs, decode_input_specs,
                                      plan_for)
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.steps import (init_train_state, make_decode_step,
                                       make_prefill_step, make_train_step)
from repro_torch.sharding import is_dtensor

DEFAULT_OUT = "artifacts/port_dryrun"


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _tensors(tree):
    from torch.utils._pytree import tree_flatten
    return [_local(t) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(step_analysis.shape_bytes(t.dtype, t.shape) for t in ts)


def _fake(specs):
    """Zero-filled fake tensors of the meta stand-ins' shapes."""
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}


def _build(cfg, shape, plan):
    """(step, args) of the cell, under the active fake mode."""
    if shape.kind == "train":
        model = build_model(cfg, plan, device="cpu")
        opt = AdamW(lr=1e-4)
        return make_train_step(model, opt), (init_train_state(model, opt),
                                             _fake(batch_specs(cfg, shape)))
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    model = build_model(cfg, plan, device="cpu")
    if shape.kind == "prefill":
        return make_prefill_step(model), (
            _fake(batch_specs(cfg, shape, with_labels=False)),)
    inputs, _, q_pos = decode_input_specs(cfg, shape, model)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    return make_decode_step(model), (
        cache, _fake(inputs), torch.zeros(q_pos.shape, dtype=q_pos.dtype))


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               plan_overrides: Optional[Dict[str, Any]] = None,
               verbose: bool = True) -> Dict[str, Any]:
    """Trace one rank's step of one cell; return the roofline record."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "multi" if multi_pod else "single"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        # the mesh's rank map is real: built before the fake mode
        mesh = make_production_mesh(multi_pod=multi_pod)
        plan = plan_for(cfg, shape, mesh, **(plan_overrides or {}))
        rec = _trace(cfg, shape, plan, mesh)
    stats = rec.pop("stats")
    t_lower, t_compile = rec["lower_s"], rec["compile_s"]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, **rec,
           "plan_overrides": plan_overrides or {}}
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"(lower {t_lower:.1f}s compile {t_compile:.1f}s, "
              f"dot_flops/dev {stats.dot_flops:.3e}, raw_ca_flops "
              f"{stats.flops:.3e}, coll "
              f"{stats.total_collective_bytes / 1e9:.3f} GB/dev)")
        print(f"  memory_analysis: {rec['memory_analysis']}")
    return rec


def _trace(cfg, shape, plan, mesh) -> Dict[str, Any]:
    """The record's measured part (and ``"stats"``) of one rank's step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        t0 = time.perf_counter()
        step, args = _build(cfg, shape, plan)
        t_lower = time.perf_counter() - t0
        arg_ts = _tensors(args)
        arg_storages = {t.untyped_storage()._cdata for t in arg_ts}
        with step_analysis.StepAnalysis() as mode:
            out = step(*args)
        t_compile = time.perf_counter() - t0 - t_lower
        out_ts = _tensors(out)
        alias = [t for t in out_ts
                 if t.untyped_storage()._cdata in arg_storages]
        fresh = [t for t in out_ts
                 if t.untyped_storage()._cdata not in arg_storages]
    stats = mode.stats
    return {
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "status": "ok",
        "plan": plan.name,
        "chips": mesh.size(),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "cost_analysis": {"flops": float(stats.flops)},
        "memory_analysis": {
            "argument_bytes": _nbytes(arg_ts),
            "output_bytes": _nbytes(fresh),
            "temp_bytes": int(stats.peak_bytes),
            "alias_bytes": _nbytes(alias),
        },
        "hlo": {
            "dot_flops_per_device": stats.dot_flops,
            "traffic_bytes_per_device": stats.traffic_bytes,
            "collective_bytes_per_device": dict(stats.collective_bytes),
            "collective_counts": dict(stats.collective_counts),
            "wire_bytes_per_device": stats.wire_bytes,
            "top_collectives": [
                {"kind": k, "dtype": d, "dims": list(dims), "mult": m,
                 "bytes": b, "op": op}
                for k, d, dims, m, b, op in stats.top_collectives],
            "dot_flops_by_site": dict(sorted(
                stats.dot_flops_by_site.items(), key=lambda kv: -kv[1])),
        },
        "stats": stats,
    }


def summary(out_dir: Path) -> str:
    """The records in ``out_dir`` as a markdown table, an arch a row and a
    shape a column: a cell's status on the (16, 16) / (2, 16, 16) meshes
    and, where "ok", the dot FLOPs a device and the seconds of the build
    plus the traced step, single / multi."""
    recs, shapes = {}, set()
    for f in sorted(out_dir.glob("*.json")):
        r = json.loads(f.read_text())
        recs.setdefault(r["arch"], {}).setdefault(r["shape"], {})[
            r["mesh"]] = r
        shapes.add(r["shape"])
    shapes = [s for s in SHAPES if s in shapes]

    def cell(by):
        rs = [by.get(m) for m in ("single", "multi")]
        status = {r["status"] if r else "—" for r in rs}
        if status != {"ok"}:
            return " / ".join(r["status"] if r else "—" for r in rs)
        flops = " / ".join(f"{r['hlo']['dot_flops_per_device']:.3e}"
                           for r in rs)
        secs = " / ".join(f"{r['lower_s'] + r['compile_s']:.1f}" for r in rs)
        return f"ok: {flops} FLOPs, {secs} s"
    rows = ["| arch | " + " | ".join(shapes) + " |",
            "|---|" + "---|" * len(shapes)]
    for arch, by in sorted(recs.items()):
        rows.append(f"| {arch} | " + " | ".join(
            cell(by.get(s, {})) for s in shapes) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) cell")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="output dir for JSON artifacts")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ParallelPlan overrides")
    ap.add_argument("--summary", action="store_true",
                    help="print the records in --out as a table; run none")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(Path(args.out)))
        return 0

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    overrides = json.loads(args.override) if args.override else None

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            if overrides:
                tag += "__" + "_".join(f"{k}-{v}" for k, v in
                                       sorted(overrides.items()))
            path = out_dir / f"{tag}.json"
            try:
                rec = lower_cell(arch, shape, multi_pod=mp,
                                 plan_overrides=overrides)
            except Exception as e:  # a failure here is a bug in the port
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape,
                       "mesh": "multi" if mp else "single",
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                failures += 1
            path.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] wrote {len(cells) * len(meshes)} artifacts to {out_dir}"
          f" ({failures} failures)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
