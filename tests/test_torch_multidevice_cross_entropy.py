"""The chunked cross-entropy beyond one chunk under a plan, on real
tensors: a gloo world of 2 processes (``fixtures_torch_multidevice``),
the model axis 2, so the logits' vocab is sharded over it, held against
the reference's single device (``fixtures_torch_multidevice_ref``).

Before the dry run's repair a training step of S > 512 (the loss's
second chunk) raised in torch.gather's DTensor rule on torch 2.13
("IndexError: too many indices for tensor of dimension 2",
``_ops/_mask_buffer.py``), on the fake tensors of the dry run and on the
real ones here alike; the pick is now a ``map_local`` body a vocab shard
(``models.common._picked``).  Its fake-world twin is
``test_torch_dryrun.py::test_cross_entropy_beyond_one_chunk_on_vocab_
shards``.
"""
import pytest

import fixtures_torch_multidevice_ref as ref

RUN = ("smollm-360m", None, (1, 1, 2))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ref.trained(tmp_path_factory.mktemp("multidevice_ce"), [RUN],
                       shape=(2, 513))[ref.run_id(RUN)]


@pytest.mark.parametrize("step", ref.STEPS)
def test_cross_entropy_beyond_one_chunk_trains_over_gloo(trained, step):
    """smollm-360m's smoke config at S = 513 (the cross-entropy's second
    chunk) over a gloo world of 2, the model axis 2: each of three AdamW
    steps' loss, grad norm and parameters as the reference's, at
    test_torch_train's tolerances (``check_step``)."""
    ref.check_step(RUN[0], *trained, step)
