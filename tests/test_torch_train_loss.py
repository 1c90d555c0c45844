"""The port's training loop overfits one batch: for each smoke model of
``test_torch_train.ARCHS`` the loss falls by more than 0.5 over 20 AdamW
steps on the CPU.

Kept apart from tests/test_torch_train.py, whose helpers it imports, so
that under ``--dist loadfile`` these eight long cases run on a worker of
their own.
"""
import numpy as np
import pytest

from repro_torch.configs import REGISTRY
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.steps import init_train_state, make_train_step
from test_torch_models import open_gates
from test_torch_train import ARCHS, _batch
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases_under_training(arch):
    cfg = REGISTRY[arch].smoke()
    model = open_gates(build_model(cfg, device="cpu", seed=2))
    opt = AdamW(lr=3e-3)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    batch = _batch(cfg, seed=2, B=4, S=64)       # overfit one batch
    losses = []
    for _ in range(20):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses
