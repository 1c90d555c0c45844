"""A train step on batches with their own positions, the port against the
reference, on the CPU: ``test_torch_positions.py``'s four cases of
positions (``left``, ``offset``, ``past_window``, ``arange``) on its six
archs, float32 at smoke size, labels -1 on the pads.  The loss within
1e-5 relative and every parameter's gradient within GRAD_TOL (max |diff|
over max |g| of the tensor, ``test_torch_train.py``'s) of
``jax.value_and_grad`` of the reference's loss.  A 0-d tensor's gradient
(the vlm's cross gates) is one sum over the batch that may cancel far
below its terms (measured: -6.9e-4 against gates' gradients up to 0.13,
3.5e-8 apart), so the gates are held against the largest gate gradient
of the model.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.models.model import load_jax_params
from repro_torch.runtime.steps import make_loss_fn

from test_torch_positions import ARCHS, B, CASES, S, _batch, _jx, _pair
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

GRAD_TOL = 1e-5


def train_against_reference(arch, batch, rbatch=None, **over):
    """Loss and every gradient of the port's train loss on ``batch``
    (labels -1 on the pads) against ``jax.value_and_grad`` of the
    reference's on ``rbatch`` (``batch`` by default)."""
    _, params, model, cfg, fns = _pair(arch, **over)
    (rloss, _), rgrads = fns["grad"](params, _jx(rbatch or batch))
    rgrads = load_jax_params(jax.tree_util.tree_map(np.asarray, rgrads),
                             cfg)
    loss, _ = make_loss_fn(model)(batch)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert abs(float(loss.detach()) / float(rloss) - 1) <= 1e-5
    # a 0-d gate's gradient is one sum that may cancel far below its
    # terms: the vlm's gates are held against the largest of them
    gates = max((np.abs(rgrads[n].numpy()).max() for n, _ in named
                 if rgrads[n].ndim == 0), default=0.0)
    for (name, _), g in zip(named, grads):
        want = rgrads[name].numpy().astype(np.float64)
        scale = gates if want.ndim == 0 else np.abs(want).max()
        err = np.abs(g.numpy() - want).max() / max(scale, 1e-30)
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_positions_matches_reference(arch, case):
    _, _, _, cfg, _ = _pair(arch)
    batch = _batch(cfg, case, seed=9)
    labels = np.random.default_rng(10).integers(0, cfg.vocab_size,
                                                (B, S)).astype(np.int32)
    labels[batch["positions"] < 0] = -1
    batch["labels"] = labels
    train_against_reference(arch, batch)
