"""Quickstart on the PyTorch port: train a reduced smollm for a few
hundred steps and watch the loss drop (``examples/quickstart.py`` on
``repro_torch``); checkpoints land in ``repro_torch_quickstart`` under
the temporary directory (``$TMPDIR``, else ``/tmp``).

    PYTHONPATH=src python examples/port_quickstart.py [--device cpu]

It trains on the GPU (``--device cuda``, the default; without a GPU it
raises) unless asked for the CPU.  The defaults are the reference
example's: 200 AdamW steps of 8 x 128 tokens under a cosine schedule
(peak 3e-3, 20 warm-up steps), a loss line every 20 steps and a
checkpoint every 100, the last two kept.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime.steps import (init_train_state,  # noqa: E402
                                       make_train_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart"))
    args = ap.parse_args(argv)

    cfg = get_config("smollm-360m").smoke()
    model = build_model(cfg, device=args.device, seed=0)
    opt = AdamW(lr=cosine_schedule(3e-3, args.steps // 10, args.steps))
    state = init_train_state(model, opt)
    step_fn = make_train_step(model, opt)
    pipe = SyntheticPipeline(cfg, args.batch, args.seq, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    for step in range(args.steps):
        state, metrics = step_fn(state, pipe.batch_at(step))
        if (step + 1) % args.log_every == 0:
            print(f"step {step+1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, extras={"data_step": step + 1})
    ckpt.wait()
    print("done — checkpoints:", ckpt.steps())
    return 0


if __name__ == "__main__":
    sys.exit(main())
