"""Training driver: RAQO-planned, checkpointed, fault-tolerant (the port
of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt \\
        --device cpu
    PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \\
        -m repro_torch.launch.train --arch smollm-360m --smoke ...

Flow: (1) the plan: one device's, or under ``torchrun`` (``WORLD_SIZE``
> 1, one process per device) the RAQO sharding planner's joint (plan,
resources) decision for a budget of the world's devices, printed as the
reference's ``[raqo]`` line, then a ``("pod", "data", "model")`` mesh of
the decision's (pods, dp, tp) and ``plan_for``'s plan on it; (2) the data
pipeline, model, optimizer and step function are built under that plan;
(3) the loop checkpoints every --ckpt-every steps, installs SIGTERM/SIGINT
handlers (preemption => checkpoint-then-exit(17)), and resumes from the
latest checkpoint at its data step on relaunch.  Exit code 17 tells the
supervisor (``launch.elastic``) "clean preemption, relaunch me"; a
simulated failure (--fail-at) exits 1.  The log lines are the
reference's; under torchrun rank 0 prints them.

It trains on the GPU (``--device cuda``, the default; without a GPU it
raises) unless asked for the CPU.  Under torchrun each rank takes the GPU
of its ``LOCAL_RANK`` and the ranks join over NCCL (gloo with ``--device
cpu``); rank 0 plans and broadcasts the decision, and after each step
the ranks agree whether any of them was signalled, so all save the same
step and exit 17 together.  A decision over fewer devices than the
world trains on ranks 0 .. chips - 1: the others print that they are
outside the mesh and exit 0.  The reference passes the planner no
budget, so on fewer than its 32-chip choice its mesh cannot be built;
the port's budget is the world.  More than one visible GPU in a process
not started by torchrun raises, as one GPU of many would otherwise train
alone.  Under a plan every family trains, with each attention schedule
(the vlm's media and the audio family's frame embeddings come from
``SyntheticPipeline`` and are sharded as they enter the model), in
either ``tp_mode`` and block schedule a plan names (``models.model``).
Serving under ``serve_plan``'s prefill and decode plans goes through the
Model API (``models.model``; ``launch.serve`` stays single-device, as the
reference's).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.models.model import build_model, resolve_device
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.steps import init_train_state, make_train_step
from repro_torch.sharding import single_device_plan

PREEMPT_EXIT = 17


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from when it holds "
                         "one (default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a node failure at this step (testing)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    shape = ShapeConfig("train", args.seq, args.batch, "train")

    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    group = signals = None
    if world > 1:
        device, plan, group, signals = _distributed_plan(args, cfg, shape,
                                                         device, world)
        if plan is None:             # a rank outside the decision's mesh
            dist.destroy_process_group()
            return 0
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        raise RuntimeError(
            f"{n} GPUs are visible to one process: launch one process per "
            f"GPU with torchrun (torchrun --standalone --nproc_per_node {n} "
            f"-m repro_torch.launch.train ...), or make one GPU visible "
            f"(CUDA_VISIBLE_DEVICES)")
    else:
        plan = single_device_plan()
    try:
        return _train(args, cfg, plan, device, group, signals)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _log(*a, **kw) -> None:
    """print, on rank 0 only under torch.distributed."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*a, **kw)


def _distributed_plan(args, cfg, shape, device, world: int):
    """Under torchrun: join the world (NCCL on the GPUs, gloo on the CPU),
    plan on rank 0 with a chip budget of the world, build the decision's
    mesh over ranks 0 .. chips - 1 and ``plan_for``'s plan on it.
    Returns (this rank's device, the plan, the process group of the
    mesh's ranks, a gloo group of them that agrees on preemption), the
    plan None on a rank outside the mesh."""
    from repro_torch.core.sharding_planner import ShardingPlanner
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import plan_for
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    decided = [None]
    if rank == 0:
        backend = "torch" if device.type == "cpu" else "cuda"
        decision = ShardingPlanner(backend=backend).joint(
            cfg, shape, arch=args.arch, chip_budget=world)
        r = decision.resources
        decided = [((r.pods, r.dp, r.tp), decision.describe(),
                    args.ckpt_dir or tempfile.mkdtemp(
                        prefix="repro_torch_ckpt_"))]
    dist.broadcast_object_list(decided, src=0)
    mesh_shape, described, args.ckpt_dir = decided[0]
    _log(f"[raqo] {described}", flush=True)
    mesh = make_mesh(mesh_shape, ("pod", "data", "model"))
    chips = mesh.size()
    # every rank of the world takes part in making a group
    ranks = list(range(chips))
    group = dist.new_group(ranks) if chips < world else None
    signals = dist.new_group(ranks, backend="gloo")
    if rank >= chips:
        print(f"[train] rank {rank}: outside the decision's mesh "
              f"{mesh_shape} ({chips} of {world} chips); exiting",
              flush=True)
        return device, None, None, None
    _log(f"[train] mesh pod x data x model = {mesh_shape} over {chips} of "
         f"{world} ranks", flush=True)
    return device, plan_for(cfg, shape, mesh), group, signals


def _any_rank(flag: bool, signals) -> bool:
    """Whether ``flag`` is set on any rank of ``signals`` (a host-side
    gloo all-reduce, no device sync), or ``flag`` with no group.  Every
    rank asks once a step, so a signal that reaches one rank stops all of
    them at the same step, where they save together."""
    if signals is None:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=signals)
    return bool(t.item())


def _train(args, cfg, plan, device, group=None, signals=None) -> int:
    model = build_model(cfg, plan, device=device, seed=args.seed)
    opt = AdamW(lr=cosine_schedule(args.lr, max(1, args.steps // 10),
                                   args.steps))
    train_step = make_train_step(model, opt)

    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        _log(f"[train] checkpoints in {args.ckpt_dir} (pass --ckpt-dir "
             f"to resume from them)", flush=True)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3, group=group)
    state = init_train_state(model, opt)
    start_step = 0
    if ckpt.latest_step() is not None:
        state, extras = ckpt.restore(state)
        start_step = int(extras.get("data_step", ckpt.latest_step()))
        _log(f"[train] resumed from step {start_step}", flush=True)

    pipe = SyntheticPipeline(cfg, args.batch, args.seq, seed=args.seed)

    # --- preemption handling --------------------------------------------- #
    preempted = {"flag": False}

    def on_signal(signum, frame):
        _log(f"[train] signal {signum}: checkpoint-then-exit", flush=True)
        preempted["flag"] = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    losses = []
    t0 = time.perf_counter()
    step = start_step
    try:
        while step < args.steps:
            if step == args.fail_at:
                _log(f"[train] SIMULATED FAILURE at step {step}", flush=True)
                raise RuntimeError("simulated node failure")
            state, metrics = train_step(state, pipe.batch_at(step))
            step += 1
            # the handler may set the flag during the reduction: it is
            # read, never written, here, and a late signal stops the next
            # step
            stop = _any_rank(preempted["flag"], signals)
            if step % args.log_every == 0 or step == args.steps:
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.perf_counter() - t0
                _log(f"[train] step {step:5d} loss {loss:.4f} "
                     f"gnorm {float(metrics['grad_norm']):.3f} "
                     f"({dt / max(1, step - start_step):.3f}s/step)",
                     flush=True)
            if step % args.ckpt_every == 0 or stop or \
                    step == args.steps:
                ckpt.save(step, state, extras={"data_step": step,
                                               "arch": args.arch},
                          async_=False)
            if stop:
                _log(f"[train] preempted at step {step}; checkpoint saved",
                     flush=True)
                return PREEMPT_EXIT
    except RuntimeError as e:
        # crash path: the supervisor relaunches; state resumes from the
        # last periodic checkpoint
        _log(f"[train] CRASH: {e}", flush=True)
        return 1
    _log(f"[train] done: {step} steps, final loss "
         f"{losses[-1] if losses else float('nan'):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
