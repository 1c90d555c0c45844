"""Training driver: checkpointed, fault-tolerant (the port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt \\
        --device cpu

Flow: (1) the plan for one device; (2) the data pipeline, model, optimizer
and step function are built under that plan; (3) the loop checkpoints every
--ckpt-every steps, installs SIGTERM/SIGINT handlers (preemption =>
checkpoint-then-exit(17)), and resumes from the latest checkpoint at its
data step on relaunch.  Exit code 17 tells the supervisor
(``launch.elastic``) "clean preemption, relaunch me"; a simulated failure
(--fail-at) exits 1.  The log lines are the reference's.

It trains on the GPU (``--device cuda``, the default; without a GPU it
raises) unless asked for the CPU.  With more than one visible GPU the
reference shards the step over a mesh the sharding planner picks; the
port's multi-device training is not written yet (ROADMAP §1, multi-device
training), so it raises ``NotImplementedError`` there instead of training
on one GPU of many.
"""
from __future__ import annotations

import argparse
import signal
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
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

    device = resolve_device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} GPUs are visible: multi-device "
            f"training is not ported yet (ROADMAP §1, multi-device "
            f"training); make one GPU visible (CUDA_VISIBLE_DEVICES)")
    plan = single_device_plan()

    model = build_model(cfg, plan, device=device, seed=args.seed)
    opt = AdamW(lr=cosine_schedule(args.lr, max(1, args.steps // 10),
                                   args.steps))
    train_step = make_train_step(model, opt)

    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        print(f"[train] checkpoints in {args.ckpt_dir} (pass --ckpt-dir "
              f"to resume from them)", flush=True)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    state = init_train_state(model, opt)
    start_step = 0
    if ckpt.latest_step() is not None:
        state, extras = ckpt.restore(state)
        start_step = int(extras.get("data_step", ckpt.latest_step()))
        print(f"[train] resumed from step {start_step}", flush=True)

    pipe = SyntheticPipeline(cfg, args.batch, args.seq, seed=args.seed)

    # --- preemption handling --------------------------------------------- #
    preempted = {"flag": False}

    def on_signal(signum, frame):
        print(f"[train] signal {signum}: checkpoint-then-exit", flush=True)
        preempted["flag"] = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    losses = []
    t0 = time.perf_counter()
    step = start_step
    try:
        while step < args.steps:
            if step == args.fail_at:
                print(f"[train] SIMULATED FAILURE at step {step}", flush=True)
                raise RuntimeError("simulated node failure")
            state, metrics = train_step(state, pipe.batch_at(step))
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.perf_counter() - t0
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt / max(1, step - start_step):.3f}s/step)",
                      flush=True)
            if step % args.ckpt_every == 0 or preempted["flag"] or \
                    step == args.steps:
                ckpt.save(step, state, extras={"data_step": step,
                                               "arch": args.arch},
                          async_=False)
            if preempted["flag"]:
                print(f"[train] preempted at step {step}; checkpoint saved",
                      flush=True)
                return PREEMPT_EXIT
    except RuntimeError as e:
        # crash path: the supervisor relaunches; state resumes from the
        # last periodic checkpoint
        print(f"[train] CRASH: {e}", flush=True)
        return 1
    print(f"[train] done: {step} steps, final loss "
          f"{losses[-1] if losses else float('nan'):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
