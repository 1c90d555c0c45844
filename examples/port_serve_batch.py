"""Batched serving on the PyTorch port: continuous-batching slots over a
tiny model (``examples/serve_batch.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/port_serve_batch.py [--device cpu]

Runs ``python -m repro_torch.launch.serve`` on the smoke smollm-360m: 8
requests of 12-token prompts through 4 slots, 16 greedy tokens each, on
the GPU (``--device cuda``, the default; without a GPU it raises) unless
asked for the CPU.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    return subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-360m", "--smoke", "--requests", "8", "--slots", "4",
         "--prompt-len", "12", "--max-new", "16", "--device", args.device],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT)


if __name__ == "__main__":
    sys.exit(main())
