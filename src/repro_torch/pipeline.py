"""GPipe pipeline parallelism over a mesh axis, one process per stage, over
torch.distributed point-to-point (the port of ``repro.pipeline``).

The layer stack (L, ...) is split into ``n_stages`` contiguous stages
along the pipeline mesh axis (canonically "pod": the slow cross-pod link,
hidden behind microbatch compute, with TP/DP inside a pod).  Rank ``s``
of that axis runs layers ``s * L / n_stages .. (s + 1) * L / n_stages -
1``.

Schedule: classic GPipe fill-drain over T = n_micro + n_stages - 1 ticks.
Each tick every stage (a) runs its layers on its current microbatch,
(b) hands the activation to the next stage around the ring
(``RingPermute``, a ``torch.autograd.Function`` over
``batch_isend_irecv``, whose backward is the reverse permute).  Bubble
fraction = (n_stages - 1) / T.  As in the reference, every tick computes
on every stage and masks what is inactive (``torch.where``), so each
stage's autograd graph reaches every permute of the ring: every rank then
runs the reverse permutes in the same order, tick T - 2 down to 0, and
``loss.backward()`` through this function IS the GPipe backward
schedule.  The last tick's permute, whose result nothing reads, is left
out on every rank.

Inputs are the caller's plain tensors, the same on every rank of the
stage axis: the whole layer stack and the batch (a data-parallel caller
passes its own batch shard: the stages of one data rank pipeline it).
Their gradients are the sequential ones on every rank: ``_Replicated``
(identity forward) sums each rank's partial gradient over the stage axis
in its backward; the output leaves through ``_FromLastStage`` (the
reference's closing ``psum``: a sum over the stages, of which only the
last holds non-zeros), whose backward hands each rank's cotangent
through unchanged, since every rank computes the same loss from the same
replicated output (an all-reduce there would scale the gradients by the
stage count).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten


def _stage_ring(mesh, stage_axis: str):
    """(process group, n_stages, this rank's stage, next rank, previous
    rank) of the stage axis, ranks global."""
    group = mesh.get_group(stage_axis)
    n = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    s = mesh.get_local_rank(stage_axis)
    nxt = dist.get_global_rank(group, (s + 1) % n)
    prv = dist.get_global_rank(group, (s - 1) % n)
    return group, n, s, nxt, prv


def _exchange(send: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``send`` to rank ``to`` and receive a tensor like it from rank
    ``frm`` (ring neighbours: every rank calls it at once)."""
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send.contiguous(), to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    for r in reqs:
        r.wait()
    return recv


class RingPermute(torch.autograd.Function):
    """Stage s's tensor goes to stage s + 1 (mod n); the backward sends
    each cotangent the other way."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.ring = (group, nxt, prv)
        return _exchange(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, dy):
        group, nxt, prv = ctx.ring
        return _exchange(dy, prv, nxt, group), None, None, None


class _Replicated(torch.autograd.Function):
    """Tensors every rank of the stage axis holds alike: identity forward;
    the backward sums each rank's partial gradient over the axis (one
    flattened all-reduce for all of them)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out, i = [], 0
        for g in gs:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return (None, *out)


class _FromLastStage(torch.autograd.Function):
    """The last stage's result on every rank (a sum over the stage axis:
    the other stages hold zeros); the backward passes each rank's
    cotangent through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gpipe_apply(params_stacked: Any, x, body_fn: Callable, *,
                mesh, stage_axis: str = "pod", n_micro: int,
                data_axes=("data",)) -> torch.Tensor:
    """Run a homogeneous layer stack as a GPipe pipeline.

    params_stacked: pytree (dicts, tuples, lists) of tensors with leading
                    layer dim L (L % n_stages == 0), whole on every rank
    x:              (B, S, d) activations (B % n_micro == 0): this rank's
                    batch, the same on every stage (a data-parallel
                    caller's shard over ``data_axes``)
    body_fn(stage_params, x) -> x  — applies the stage's layers
    mesh:           a DeviceMesh with a ``stage_axis`` dim
    Returns (B, S, d) on every rank, with the semantics (values and
    gradients) of applying all L layers in sequence."""
    group, n_stages, stage, nxt, prv = _stage_ring(mesh, stage_axis)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} % n_micro {n_micro} != 0")
    mb = B // n_micro
    leaves, treedef = tree_flatten(params_stacked)
    L = leaves[0].shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers % {n_stages} stages != 0")
    per = L // n_stages
    *leaves, x = _Replicated.apply(group, *leaves, x)
    sp = tree_unflatten([a[stage * per:(stage + 1) * per] for a in leaves],
                        treedef)
    xs = x.reshape(n_micro, mb, *x.shape[1:])

    T = n_micro + n_stages - 1
    first = torch.tensor(stage == 0, device=x.device)
    zero = torch.zeros_like(xs[0])
    state = zero
    out = [zero] * n_micro
    for t in range(T):
        # stage 0 ingests microbatch t (clipped; masked when t >= n_micro)
        x_in = torch.where(first, xs[min(t, n_micro - 1)], state)
        active = stage <= t < stage + n_micro
        y = torch.where(torch.tensor(active, device=x.device),
                        body_fn(sp, x_in), zero)
        # the last stage banks its finished microbatch t - (n_stages - 1)
        i = min(max(t - (n_stages - 1), 0), n_micro - 1)
        bank = stage == n_stages - 1 and t >= n_stages - 1
        out[i] = torch.where(torch.tensor(bank, device=x.device), y, out[i])
        if t < T - 1:
            state = RingPermute.apply(y, group, nxt, prv) \
                if n_stages > 1 else y
    res = _FromLastStage.apply(torch.stack(out), group)
    return res.reshape(B, *x.shape[1:])
