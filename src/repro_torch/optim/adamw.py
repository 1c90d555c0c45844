"""AdamW with decoupled weight decay, global-norm clipping and a schedule
(the port of ``repro.optim.adamw``; not ``torch.optim.AdamW``, whose
update order and clipping differ).

The reference's defaults and order: compression -> global-norm clip ->
float32 moments -> bias correction -> decoupled decay.  Parameters,
gradients and moments are dicts of tensors keyed by parameter name (a
model's ``named_parameters()``); ``update`` writes the new parameters and
moments into those tensors in place with ``torch._foreach_*`` operations
and returns them, with the metrics as 0-d tensors on the device (no host
sync).  It updates the parameters a group of tensors at a time, at most
``GROUP_ELEMENTS`` elements a group (or one larger tensor), so its float32
temporaries stay that small whatever the model's size; every element's
arithmetic is the same in any grouping.

Under a multi-device plan the parameters, gradients (already placed like
their parameters, ``runtime.steps``) and moments are DTensors of one
placement each: the global norm reduces across the ranks, and the
update, elementwise, runs on each rank's shards in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.optim.compression import GradCompression
from repro_torch.sharding import is_dtensor, local

Tensors = Dict[str, torch.Tensor]

GROUP_ELEMENTS = 1 << 28       # 1 GiB of float32 per temporary list


class OptState(NamedTuple):
    step: torch.Tensor         # () int32
    m: Tensors                 # float32, keyed like the params
    v: Tensors
    err: Optional[Tensors] = None   # gradient-compression error feedback


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (a dict's values or a
    sequence), in float32.  Of DTensors on one mesh (Shard or Replicate
    placements), the norm of the whole tensors, the same on every rank:
    each rank squares its shards' norms, counting a tensor replicated
    over a mesh dim only at coordinate 0 of that dim, and one sum over
    the mesh adds them up (a collective: every rank calls it)."""
    leaves = list(tensors.values()) if isinstance(tensors, dict) \
        else list(tensors)
    norms = torch._foreach_norm([local(t).float() for t in leaves])
    if not leaves or not is_dtensor(leaves[0]):
        return torch.linalg.vector_norm(torch.stack(norms))
    from torch.distributed.tensor import DTensor, Partial
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    mine = []
    for t, n in zip(leaves, norms):
        if t.device_mesh != mesh or any(p.is_partial()
                                        for p in t.placements):
            raise ValueError("global_norm takes DTensors of one mesh, "
                             "sharded or replicated")
        if all(c == 0 for p, c in zip(t.placements, coord)
               if p.is_replicate()):
            mine.append(n * n)
    sq = torch.stack(mine).sum() if mine else norms[0].new_zeros(())
    total = DTensor.from_local(sq, mesh, [Partial()] * mesh.ndim)
    return torch.sqrt(total.full_tensor())


def _groups(names, params: Tensors):
    """``names`` cut into consecutive groups of at most ``GROUP_ELEMENTS``
    elements (a tensor larger than that is a group of its own)."""
    group, size = [], 0
    for k in names:
        n = params[k].numel()
        if group and size + n > GROUP_ELEMENTS:
            yield group
            group, size = [], 0
        group.append(k)
        size += n
    if group:
        yield group


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    compression: Optional[GradCompression] = None

    def init(self, params: Tensors) -> OptState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32,
                                        requires_grad=False)
                    for k, p in params.items()}
        err = self.compression.init(params) if self.compression else None
        dev = next(iter(params.values())).device if params else None
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        m=zeros(), v=zeros(), err=err)

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors
               ) -> Tuple[Tensors, OptState, dict]:
        step = state.step + 1
        err = state.err
        if self.compression is not None and self.compression.enabled:
            grads, err = self.compression.apply(grads, err)
        names = list(params)
        gnorm = global_norm([grads[k] for k in names])
        # elementwise from here: each rank's shards, in place
        ps = {k: local(params[k]) for k in names}
        gs = {k: local(grads[k]) for k in names}
        ms = {k: local(state.m[k]) for k in names}
        vs = {k: local(state.v[k]) for k in names}
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        t = step.to(torch.float32)
        mhat_c = 1.0 / (1 - torch.pow(b1, t))
        vhat_c = 1.0 / (1 - torch.pow(b2, t))
        lr = self._lr(step)
        for group in _groups(names, ps):
            g = [gs[k].float() for k in group]
            if scale is not None:
                g = torch._foreach_mul(g, scale)
            m = [ms[k] for k in group]
            v = [vs[k] for k in group]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(
                torch._foreach_mul(g, g), 1 - b2))
            del g
            p = [ps[k] for k in group]
            pf = [x.float() for x in p]
            den = torch._foreach_mul(v, vhat_c)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_mul(m, mhat_c)
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, torch._foreach_mul(pf, self.weight_decay))
            torch._foreach_mul_(u, lr)
            new = torch._foreach_sub(pf, u)
            for x, y in zip(p, new):
                x.copy_(y)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, OptState(step=step, m=state.m, v=state.v,
                                err=err), metrics
