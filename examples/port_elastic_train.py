"""Fault tolerance on the PyTorch port: train, crash mid-run,
adaptive-RAQO replan, resume (``examples/elastic_train.py`` on
``repro_torch``).

    PYTHONPATH=src python examples/port_elastic_train.py [--device cpu]

Runs ``python -m repro_torch.launch.elastic`` with the reference
example's arguments: the smoke smollm-360m for 30 steps of 4 x 64, a
checkpoint every 5, a simulated failure at step 15, then the replan and
a relaunch that resumes from step 15.  Checkpoints go to
``--ckpt-dir`` (default ``repro_torch_elastic_demo`` under the temporary
directory, ``$TMPDIR`` else ``/tmp``): a directory that already holds a
run's checkpoints resumes from them.  It trains on the GPU (``--device
cuda``, the default; without a GPU it raises) unless asked for the CPU.
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_elastic_demo"))
    args = ap.parse_args(argv)
    return subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.elastic", "--arch",
         "smollm-360m", "--smoke", "--steps", "30", "--max-restarts", "2",
         "--ckpt-dir", args.ckpt_dir, "--device", args.device, "--",
         "--fail-at", "15", "--batch", "4", "--seq", "64",
         "--ckpt-every", "5", "--log-every", "10"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT)


if __name__ == "__main__":
    sys.exit(main())
