"""Elastic supervisor: retry loop + adaptive-RAQO replanning (the port of
``repro.launch.elastic``).

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch smollm-360m \\
        --smoke --steps 60 --device cpu -- --fail-at 25

Runs ``repro_torch.launch.train`` as a subprocess, with ``--device``
passed on.  On crash (exit != 0) or preemption (exit == 17) it consults
the sharding planner for the *current* cluster condition — if chips were
lost, the plan/resources change (adaptive RAQO, paper §VIII) — and
relaunches; training resumes from the latest checkpoint.  The cluster
condition is simulated here via --lose-chips-after-crash.  The planner
runs on the default CUDA backend, or on ``backend="torch"`` under
``--device cpu``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.sharding_planner import ShardingPlanner, TpuCluster

PREEMPT_EXIT = 17


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="the trainer's checkpoint directory, shared by its "
                         "relaunches (default: a new temporary directory)")
    ap.add_argument("--lose-chips-after-crash", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("rest", nargs="*")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = ShapeConfig("train", 4096, 256, "train")
    planner = ShardingPlanner(
        cluster=TpuCluster(),
        backend="torch" if args.device == "cpu" else "cuda")
    decision = planner.joint(cfg, shape, arch=args.arch)
    print(f"[elastic] initial RAQO decision: {decision.describe()}",
          flush=True)

    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_elastic_ckpt_")
    lost = 0
    for attempt in range(args.max_restarts + 1):
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               "--arch", args.arch, "--steps", str(args.steps),
               "--ckpt-dir", args.ckpt_dir, "--device", args.device] + \
            (["--smoke"] if args.smoke else []) + list(args.rest)
        # only inject the failure on the first attempt
        if attempt > 0:
            cmd = [c for i, c in enumerate(cmd)
                   if not (c == "--fail-at" or
                           (i > 0 and cmd[i - 1] == "--fail-at"))]
        print(f"[elastic] attempt {attempt}: {' '.join(cmd[2:])}",
              flush=True)
        rc = subprocess.call(cmd)
        if rc == 0:
            print("[elastic] training completed", flush=True)
            return 0
        # crash or preemption: degraded cluster => adaptive RAQO replan
        lost += args.lose_chips_after_crash if rc != PREEMPT_EXIT else 0
        print(f"[elastic] exit={rc}; lost chips so far: {lost}; replanning",
              flush=True)
        decision = planner.replan(cfg, shape, lost_chips=lost)
        print(f"[elastic] new RAQO decision: {decision.describe()}",
              flush=True)
    print("[elastic] giving up after max restarts", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
