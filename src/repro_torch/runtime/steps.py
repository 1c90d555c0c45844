"""Step builders: training loss/step, prefill, decode (the port of
``repro.runtime.steps``).

PyTorch runs eagerly, so a step is the model call itself: serving's under
``torch.no_grad``, training's one forward and backward through the model
(K7 and K8 in the forward on the card, their ``torch.autograd.Function``
backwards in plain torch) and an in-place AdamW update.
``make_train_step`` supports gradient accumulation (plan.microbatch > 1):
float32 gradients summed over the microbatches and averaged, as the
reference's ``lax.scan`` does.  A train step queues its work and returns
its metrics as 0-d tensors on the device; the only host syncs are the
caller's reads of them.

Batches are the model's (``models.model``): "tokens", or the audio
family's "embeddings" (B, S, media_embed_dim), and a vlm's "media" (B, M,
media_embed_dim), numpy arrays or tensors, which the model moves to its
device; training batches add "labels".  A decode step's inputs are
{"tokens": (B, 1)} or {"embeddings": (B, 1, media_embed_dim)}.

Under a multi-device plan (a distributed model: its parameters
DTensors, ``models.model``) every rank calls the step on the same whole
batch, and the model shards it.  Each gradient comes out of autograd
with the placements its last redistribution left (data-parallel
gradients are partial sums over the data axes) and is redistributed to
its parameter's placements before the update: the all-reduce over
``("pod", "data")``, FSDP's reduce-scatter over ``"data"``.  The metrics
are gathered whole on every rank (collectives).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.models.common import chunked_cross_entropy
from repro_torch.models.moe import moe_aux_total
from repro_torch.sharding import full, is_dtensor


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]    # the model's named parameters
    opt_state: Any
    step: torch.Tensor                 # () int32


def make_loss_fn(model):
    """loss_fn(batch) -> (loss, metrics) through the model's parameters;
    ``batch`` holds the model's inputs ("tokens", or "embeddings"; a vlm's
    "media") and "labels" (numpy or tensors).  A moe
    model's loss adds ``moe_aux_total`` of its aux losses, which join the
    metrics."""
    cfg = model.cfg

    def loss_fn(batch):
        hidden, aux, _ = model.forward(batch)
        h = model.final_hidden(hidden)
        head = model.embed.T if cfg.tie_embeddings else model.head
        labels = model.shard(model._index(batch["labels"]), ("batch", "seq"))
        tot, cnt = chunked_cross_entropy(h, head, labels, cfg=cfg,
                                         plan=model.plan)
        ce = tot / torch.clamp(cnt, min=1.0)
        loss = ce
        metrics = {"ce": ce, "tokens": cnt}
        if cfg.is_moe and aux:
            loss = loss + moe_aux_total(aux, cfg)
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def _split_microbatches(batch, n: int):
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} % microbatch {n} != 0")
        m = b // n
        return [x[i * m:(i + 1) * m] for i in range(n)]
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _placed_like(g, p):
    """A DTensor gradient redistributed to its parameter's placements
    (reducing partial sums); a plain one as it is."""
    if not is_dtensor(g) or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(model, optimizer):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``ce``, ``tokens``, ``grad_norm`` and ``lr`` (and a moe
    model's ``lb_loss``, ``z_loss`` and ``drop_frac``)."""
    loss_fn = make_loss_fn(model)
    plan = model.plan

    def grad_fn(params, batch):
        with torch.enable_grad():
            loss, metrics = loss_fn(batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        materialize_grads=True)
        grads = {k: _placed_like(g, params[k]) for k, g in zip(params, grads)}
        return grads, {k: full(v.detach()) for k, v in metrics.items()}

    def train_step(state: TrainState, batch):
        params = state.params
        if plan.microbatch > 1:
            grads, metrics = None, None
            for mb in _split_microbatches(batch, plan.microbatch):
                g, m = grad_fn(params, mb)
                if grads is None:
                    grads = {k: v.float() for k, v in g.items()}
                    metrics = m
                else:
                    for k, v in g.items():
                        grads[k] += v.float()
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = {k: g / plan.microbatch for k, g in grads.items()}
            metrics = {k: v / plan.microbatch for k, v in metrics.items()}
        else:
            grads, metrics = grad_fn(params, batch)
        _, opt_state, opt_m = optimizer.update(grads, state.opt_state,
                                               params)
        metrics.update(opt_m)
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def init_train_state(model, optimizer) -> TrainState:
    """The model's parameters (drawn from its seed on its device), the
    optimizer's state beside them, step 0."""
    params = dict(model.named_parameters())
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32,
                                  device=model.device))


def make_prefill_step(model, cache_len: Optional[int] = None):
    """prefill(batch) -> (last position's logits (B, V) float32, cache);
    ``batch`` is the model's inputs (a vlm's "media" with its "tokens",
    the audio family's "embeddings")."""
    def prefill(batch):
        with torch.no_grad():
            return model.prefill(batch, cache_len=cache_len)
    return prefill


def make_decode_step(model):
    """decode(cache, inputs, q_pos) -> (logits (B, V) float32, cache);
    ``inputs`` is {"tokens": (B, 1)} or the audio family's
    {"embeddings": (B, 1, media_embed_dim)}."""
    def decode(cache, inputs, q_pos):
        with torch.no_grad():
            return model.decode_step(cache, inputs, q_pos)
    return decode
