"""Logical-axis sharding: parallelism plans -> DTensor placements (the port
of ``repro.sharding``).

Model code annotates tensors with *logical* axis names ("batch", "seq",
"embed", "heads", "kv", "ff", "experts", "vocab", "inner", ...).  A
``ParallelPlan`` maps logical names to mesh axes, giving DP / TP / SP /
FSDP(ZeRO) / EP as pure rule-sets, as the reference's does.  Where the
reference turns a rule-set into a ``PartitionSpec`` for GSPMD, the port
turns it into ``torch.distributed.tensor`` placements on a
``DeviceMesh`` whose dims are named like the reference's mesh axes
(``("pod", "data", "model")`` or ``("data", "model")``): ``spec`` gives
the tuple of mesh-axis assignments a ``PartitionSpec`` holds,
``placements`` the DTensor placements of that tuple (a tensor dim
assigned a tuple of axes is ``Shard`` on each of them, in mesh order, as
GSPMD nests them major to minor), and ``constrain`` redistributes a
DTensor to them (the identity on a plain tensor or under a disabled
plan, so one device runs exactly as before).  ``map_local`` runs a
function on each rank's local shards (as torch's ``local_map`` does,
for the kernels, which take raw pointers, and the moe FFN's per-group
work), giving each input's gradient ``Partial()`` where the ranks
computed different parts; ``map_channels`` places a per-channel
function's arguments by a (batch, sequence, channels) DTensor's
shards.

The tensor-parallel projections run in the plan's ``tp_mode``:
``"gspmd"`` is a matmul of DTensors and a constraint (DTensor picks the
collectives); ``"shard_map"`` is the reference's explicit Megatron g and
g-bar (``explicit_col_project``, ``explicit_row_project``): a
``map_local`` body on each rank's shards with its collectives written
out (``torch.distributed._functional_collectives``, whose autograd runs
the transposed collective in the backward).

A tensor dim sharded over several mesh dims (a serve plan's "kv_seq"
over ("data", "model")) is cut by DTensor's nested rule: ``shard_range``
gives a rank its chunk's global offset and length, ``zeros_sharded``
allocates a DTensor of which each rank holds only its own chunk, and
``all_reduce`` reduces a ``map_local`` body's partial results over mesh
dims.

``ParamDef``, ``stack_defs`` and ``init_from_defs`` are the single source
of truth for shapes, logical axes and initialisation; ``defs_to_specs``
and ``defs_to_shapes`` map a definition tree to its specs and to meta
tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

AxisAssignment = Union[None, str, Tuple[str, ...]]


def mesh_axes(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (a ``DeviceMesh``'s ``mesh_dim_names``)."""
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """A parallelism 'query plan' for one (arch x shape).

    rules: logical axis name -> mesh axis (or tuple of mesh axes, or None).
    When ``enabled`` is False every constraint is the identity (one
    device)."""
    name: str = "single"
    rules: Tuple[Tuple[str, AxisAssignment], ...] = ()
    enabled: bool = False
    # per layer: none | nothing_saveable (torch.utils.checkpoint) |
    # dots_saveable (a selective checkpoint that keeps matmul outputs)
    remat: str = "nothing_saveable"
    microbatch: int = 1               # gradient-accumulation steps
    seq_shard: bool = True            # Megatron-SP residual stream
    attention_schedule: str = "dense" # dense | causal_skip
    moe_group_size: int = 2048        # tokens routed together (a group)
    moe_target_groups: int = 1        # aim for >= this many groups
    # time steps the selective scan's backward recomputes at a time
    ssm_chunk: int = 256
    # gspmd: projections are matmuls of DTensors and a constraint, DTensor
    # picks the collectives; shard_map: the reference's explicit Megatron
    # g / g-bar, their collectives written out (module docstring)
    tp_mode: str = "gspmd"
    mesh: Any = None                  # the DeviceMesh the rules refer to
    # the reference's field, which no model path of it reads: every rank
    # trains the whole model (GPipe is pipeline.gpipe_apply)
    pipeline_stages: int = 1

    def rule(self, logical: Optional[str]) -> AxisAssignment:
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> tuple:
        """The mesh-axis assignment of each tensor dim (what the
        reference's ``PartitionSpec`` holds)."""
        return tuple(self.rule(a) for a in logical_axes)

    def placements(self, logical_axes: Sequence[Optional[str]], mesh=None):
        """DTensor placements on ``mesh`` (default the plan's) for a tensor
        whose dims carry ``logical_axes``: ``Shard(dim)`` on each mesh dim
        a tensor dim is assigned to, ``Replicate()`` on the others."""
        mesh = self.mesh if mesh is None else mesh
        names = mesh_axes(mesh)
        spec = self.spec(logical_axes)
        for dim, assign in enumerate(spec):
            for a in (assign,) if isinstance(assign, str) else (assign or ()):
                if a not in names and (self.mesh is None or
                                       mesh_shape(self.mesh).get(a) != 1):
                    # only an axis of size 1 may be left out (active_mesh)
                    raise ValueError(f"logical axis {logical_axes[dim]!r} "
                                     f"maps to {a!r}, not an axis of the "
                                     f"mesh {names}")
        return _on_mesh(mesh, spec)

    def divides(self, logical: Optional[str], n: int) -> bool:
        """Whether the mesh axes ``logical`` maps to split ``n`` evenly
        (always on one device or without a mesh)."""
        if not self.enabled or self.mesh is None:
            return True
        assign = self.rule(logical)
        axes = (assign,) if isinstance(assign, str) else (assign or ())
        sizes = mesh_shape(self.mesh)
        return n % math.prod(sizes.get(a, 1) for a in axes) == 0

    def constrain(self, x, logical_axes: Sequence[Optional[str]]):
        """Redistribute a DTensor to the plan's placements; the identity
        when the plan is disabled or ``x`` is no DTensor."""
        if not self.enabled or not is_dtensor(x):
            return x
        if len(logical_axes) != x.ndim:
            raise ValueError(f"{len(logical_axes)} logical axes "
                             f"{tuple(logical_axes)} for a tensor of shape "
                             f"{tuple(x.shape)}")
        return contiguous_shards(x.redistribute(
            x.device_mesh, self.placements(logical_axes, x.device_mesh)))

    def with_(self, **kw) -> "ParallelPlan":
        return dataclasses.replace(self, **kw)

    # ---------------------- tensor-parallel projections ------------------ #
    def _explicit(self, x, tp_mode) -> bool:
        """Whether a projection of ``x`` takes the explicit collectives:
        ``tp_mode`` (the plan's when None) is "shard_map" and ``x`` is a
        DTensor of an enabled plan."""
        mode = self.tp_mode if tp_mode is None else tp_mode
        if mode not in TP_MODES:
            raise ValueError(f"tp_mode={mode!r}; expected one of {TP_MODES}")
        return mode == "shard_map" and self.enabled and is_dtensor(x)

    def row_parallel_project(self, x, w, *, tp_mode=None):
        """y = x @ w with the contraction dim sharded over 'model'
        (Megatron's row-parallel half).  gspmd: the product, then the
        sequence-sharded constraint (a reduce-scatter of the partial sums
        onto the sequence); shard_map: ``explicit_row_project``.
        ``tp_mode`` overrides the plan's (where the reference writes a
        plain einsum, "gspmd"); a plain tensor gives ``x @ w``."""
        if self._explicit(x, tp_mode):
            return explicit_row_project(self, x, w)
        return self.constrain(x @ w.to(x.dtype), ("batch", "seq", None))

    def col_parallel_project(self, x, w, *, tp_mode=None):
        """y = x @ w with the output dim sharded over 'model' (Megatron's
        column-parallel half).  gspmd: the sequence-sharded input is
        gathered whole in the sequence first (Megatron-SP's all-gather),
        then the product; shard_map: ``explicit_col_project``."""
        if self._explicit(x, tp_mode):
            return explicit_col_project(self, x, w)
        x = self.constrain(x, ("batch", None, None))
        return x @ w.to(x.dtype)


TP_MODES = ("gspmd", "shard_map")


def _on_mesh(mesh, spec):
    """Placements on ``mesh`` of a tensor whose dim i is sharded over the
    mesh axes ``spec[i]`` (None, an axis or a tuple of axes); an axis the
    mesh lacks (a size-1 dim ``active_mesh`` dropped) shards nothing."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for dim, assign in enumerate(spec):
        for a in (assign,) if isinstance(assign, str) else (assign or ()):
            if a in names:
                out[names.index(a)] = Shard(dim)
    return out


def check_explicit_split(plan, B: int, S: int) -> None:
    """Raise ``ValueError`` where the explicit projections of a (B, S, ...)
    activation cannot place it as the reference's ``shard_map``
    ``in_specs`` do, which is where jax refuses them: the batch over the
    data axes ("pod", "data"), whatever the plan's "batch" rule (a serve
    plan's below a global batch of 16 leaves it whole, and the bodies
    split it all the same), and the sequence over "model" (the gather and
    the reduce-scatter tile it)."""
    sizes = mesh_shape(plan.mesh)
    dp = math.prod(n for a, n in sizes.items() if a in ("pod", "data"))
    if B % dp:
        raise ValueError(f"tp_mode='shard_map': a batch of {B} does not "
                         f"split over the data axes' {dp} ranks (the "
                         f"explicit projections split it over them)")
    tp = sizes.get("model", 1)
    if S % tp:
        raise ValueError(f"tp_mode='shard_map': a sequence of {S} does not "
                         f"split over a model axis of {tp} (the explicit "
                         f"projections scatter it over the ranks)")


def _explicit_axes(plan, x):
    """(the batch's mesh axes, the weight's FSDP axes on x's mesh, "model"
    if on it else None) for an explicit projection of DTensor ``x``;
    raises where x does not split as the bodies place it
    (``check_explicit_split``)."""
    names = mesh_axes(x.device_mesh)
    data = tuple(a for a in mesh_axes(plan.mesh) if a in ("pod", "data"))
    embed = plan.rule("embed")
    fsdp = tuple(a for a in ((embed,) if isinstance(embed, str)
                             else (embed or ())) if a in names)
    model = "model" if "model" in names else None
    check_explicit_split(plan, x.shape[0], x.shape[1])
    return data, fsdp, model


def _gather(t, dim: int, mesh, axis: str):
    """``t`` all-gathered along ``dim`` over the mesh axis ``axis`` (its
    backward: a reduce-scatter of the gradient)."""
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single_autograd", None) or \
        funcol.all_gather_tensor_autograd
    return funcol.wait_tensor(gather(t.contiguous(), dim,
                                     mesh.get_group(axis)))


def _scatter(t, dim: int, mesh, axis: str):
    """The sum of ``t`` over the mesh axis ``axis``, each rank keeping its
    slice along ``dim`` (its backward: an all-gather of the gradient)."""
    from torch.distributed import _functional_collectives as funcol
    scatter = getattr(funcol, "reduce_scatter_single_autograd", None) or \
        funcol.reduce_scatter_tensor_autograd
    return funcol.wait_tensor(scatter(t.contiguous(), "sum", dim,
                                      mesh.get_group(axis)))


def explicit_col_project(plan, x, w):
    """Megatron's g under ``tp_mode="shard_map"`` (the reference's
    ``col_parallel_project`` body): x (B, S, d) enters (batch, "model",
    None), sequence-sharded, and w (d, F) (embed, "model").  On each rank
    the weight's shard is cast to x's dtype and gathered over its FSDP
    axis ("data"), x is gathered over "model" along the sequence, then
    the local product; y leaves (batch, None, "model").  The weight's
    gradient is a partial sum over the batch's axes it is replicated on
    ("pod"), which ``map_local`` marks; over "data" and "model" the
    gathers' reduce-scatters sum it."""
    mesh = x.device_mesh
    data, fsdp, model = _explicit_axes(plan, x)

    def local(xl, wl):
        wl = wl.to(xl.dtype)
        for a in fsdp:
            wl = _gather(wl, 0, mesh, a)
        if model:
            xl = _gather(xl, 1, mesh, model)
        return (xl @ wl,)

    return map_local(local, (x, w),
                     (_on_mesh(mesh, (data, "model", None)),
                      _on_mesh(mesh, (fsdp, "model"))),
                     (_on_mesh(mesh, (data, None, "model")),), mesh)[0]


def explicit_row_project(plan, x, w):
    """Megatron's g-bar under ``tp_mode="shard_map"`` (the reference's
    ``row_parallel_project`` body): x (B, S, K) enters (batch, None,
    "model") and w (K, d) ("model", embed).  On each rank the weight's
    shard is cast to x's dtype and its FSDP columns gathered over
    "data", and the local partial product is reduce-scattered over
    "model" onto the sequence, in x's dtype; y leaves (batch, "model",
    None)."""
    mesh = x.device_mesh
    data, fsdp, model = _explicit_axes(plan, x)

    def local(xl, wl):
        wl = wl.to(xl.dtype)
        for a in fsdp:
            wl = _gather(wl, 1, mesh, a)
        part = xl @ wl
        return (_scatter(part, 1, mesh, model) if model else part,)

    return map_local(local, (x, w),
                     (_on_mesh(mesh, (data, None, "model")),
                      _on_mesh(mesh, ("model", fsdp))),
                     (_on_mesh(mesh, (data, "model", None)),), mesh)[0]


# --------------------------------------------------------------------------- #
# Canonical plans.  Mesh axes: ("pod", "data", "model") multi-pod,
# ("data", "model") single pod.
# --------------------------------------------------------------------------- #

def _base_rules(data_axes: Tuple[str, ...], fsdp: Tuple[str, ...],
                model: str, seq_shard: bool
                ) -> Tuple[Tuple[str, AxisAssignment], ...]:
    return (
        ("batch",   data_axes if len(data_axes) != 1 else data_axes[0]),
        ("seq",     model if seq_shard else None),      # residual-stream SP
        ("kv_seq",  model),                             # decode cache sequence shard
        ("kv_heads", None),                             # cache KV-head dim (seq takes 'model')
        ("tokens",  data_axes + (model,)),              # MoE pre-dispatch groups
        ("embed",   fsdp if len(fsdp) != 1 else (fsdp[0] if fsdp else None)),
        ("heads",   model),
        ("kv",      model),
        ("ff",      model),
        ("inner",   model),                             # mamba d_inner
        ("experts", model),
        ("ff_expert", None),        # flips to `model` when EP impossible
        ("vocab",   model),
        ("media",   None),
        ("state",   None),
    )


def moe_rules_for(plan: ParallelPlan, n_experts: int,
                  model_size: int) -> ParallelPlan:
    """Resolve expert sharding: EP over the model axis when divisible,
    otherwise TP-within-expert (shard the expert FFN dim)."""
    if n_experts % model_size == 0:
        return plan
    rules = tuple(
        (k, (None if k == "experts" else "model" if k == "ff_expert" else v))
        for k, v in plan.rules)
    return plan.with_(rules=rules)


def train_plan(mesh_axes: Sequence[str], *, fsdp: bool = True,
               seq_shard: bool = True, remat: str = "nothing_saveable",
               microbatch: int = 1, name: str = "") -> ParallelPlan:
    """Default training plan: DP over (pod,data), TP over model, Megatron-SP
    residuals, FSDP(ZeRO) param rows over data."""
    mesh_axes = tuple(mesh_axes)
    data_axes = tuple(a for a in mesh_axes if a in ("pod", "data"))
    fsdp_axes = ("data",) if fsdp and "data" in mesh_axes else ()
    return ParallelPlan(
        name=name or ("train_dp_tp_sp" + ("_fsdp" if fsdp else "")),
        rules=_base_rules(data_axes, fsdp_axes, "model", seq_shard),
        enabled=True,
        remat=remat,
        microbatch=microbatch,
        seq_shard=seq_shard,
    )


def serve_plan(mesh_axes: Sequence[str], *, global_batch: int,
               weight_mode: str = "stationary", name: str = "") -> ParallelPlan:
    """Serving plan.  KV cache: batch over data axes (when divisible),
    sequence over 'model' (flash-decoding / context parallelism).  Weights:
      stationary : params sharded over 'model' only (no per-layer gather)
      gathered   : params 2-D sharded (model x data), all-gathered per layer
    For batch < 16 (long-context) batch is left unsharded and the cache
    sequence is sharded over (data, model)."""
    mesh_axes = tuple(mesh_axes)
    data_axes = tuple(a for a in mesh_axes if a in ("pod", "data"))
    small_batch = global_batch < 16   # long-context: leave batch unsharded
    batch_assign: AxisAssignment = None if small_batch else (
        data_axes if len(data_axes) != 1 else data_axes[0])
    kv_seq_assign: AxisAssignment = (data_axes + ("model",)) if small_batch \
        else "model"
    fsdp_axes: Tuple[str, ...] = ("data",) if weight_mode == "gathered" \
        else ()
    rules = (
        ("batch",   batch_assign),
        ("seq",     None),
        ("kv_seq",  kv_seq_assign),
        ("kv_heads", None),
        ("tokens",  data_axes + ("model",) if not small_batch else None),
        ("embed",   fsdp_axes[0] if fsdp_axes else None),
        ("heads",   "model"),
        ("kv",      "model"),
        ("ff",      "model"),
        ("inner",   "model"),
        ("experts", "model"),
        ("ff_expert", None),
        ("vocab",   "model"),
        ("media",   None),
        ("state",   None),
    )
    return ParallelPlan(
        name=name or f"serve_{weight_mode}",
        rules=rules,
        enabled=True,
        remat="none",
        seq_shard=False,
    )


def single_device_plan() -> ParallelPlan:
    return ParallelPlan(name="single", enabled=False, remat="none",
                        seq_shard=False)


# --------------------------------------------------------------------------- #
# Param definitions: single source of truth for shapes, logical axes, init.
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | scaled | const
    scale: float = 0.02
    const: float = 0.0

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def map_defs(fn, tree):
    """``fn`` applied to every ParamDef leaf of a nested dict."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    return {k: map_defs(fn, v) for k, v in tree.items()}


def stack_defs(tree, n: int):
    """Prepend a stacked-layers dim of size n to every ParamDef leaf."""
    return map_defs(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, logical=(None,) + d.logical), tree)


def defs_to_specs(defs, plan: ParallelPlan):
    """Each leaf's ``plan.spec`` (a tuple of mesh-axis assignments)."""
    return map_defs(lambda d: plan.spec(d.logical), defs)


def defs_to_shapes(defs, dtype: torch.dtype):
    """Each leaf as a meta tensor of its shape and ``dtype`` (the
    reference's ``ShapeDtypeStruct``): no memory."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def init_from_defs(defs, generator: torch.Generator, dtype: torch.dtype,
                   device=None, place=None) -> Dict[str, Any]:
    """Materialise params from defs with the reference's distributions:
    normal x scale, normal x fan_in^-1/2 ("scaled", fan_in = shape[-2]),
    zeros, ones, const.  Leaves are drawn in sorted key order (the order
    jax flattens a dict) from ``generator``, which lives on ``device``;
    the numbers differ from jax.random's for the same seed.  ``place(def,
    leaf)``, when given, takes each leaf as soon as it is drawn (a
    distributed model keeps only its shard, so no more than one whole
    leaf is ever held)."""
    device = generator.device if device is None else torch.device(device)

    def draw(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        if d.init == "const":
            return torch.full(d.shape, d.const, dtype=dtype, device=device)
        out = torch.randn(d.shape, generator=generator, dtype=dtype,
                          device=device)
        if d.init == "scaled":   # fan-in scaled
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            return out.mul_(fan_in ** -0.5)
        return out.mul_(d.scale)

    def walk(tree):
        if isinstance(tree, ParamDef):
            return draw(tree) if place is None else place(tree, draw(tree))
        return {k: walk(tree[k]) for k in sorted(tree)}

    return walk(defs)


def distribute(t: torch.Tensor, mesh, placements):
    """``t``, which every rank holds whole and equal, as a DTensor of
    ``placements`` on ``mesh``: each rank keeps its own shard, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def active_mesh(mesh):
    """The submesh of ``mesh``'s dims of size > 1 (its last dim when all
    are 1), where a distributed model's DTensors live: a placement on a
    dim of size 1 shards nothing, and each dim more multiplies the
    placement strategies DTensor's sharding propagation weighs for every
    new operator (a first training step of minutes on a 3-D mesh, of
    seconds on its 2-D submesh).  ``ParallelPlan.placements`` skips the
    size-1 axes a rule names."""
    names = mesh_axes(mesh)
    keep = tuple(n for n, size in zip(names, mesh.shape) if size > 1) \
        or names[-1:]
    if keep == names:
        return mesh
    return mesh[keep[0]] if len(keep) == 1 else mesh[keep]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def placements_like(like, keep: Sequence[int], dims: Sequence[Optional[int]]):
    """Placements on ``like``'s mesh for a tensor that carries, at its
    dims ``dims``, the roles of ``like``'s dims ``keep`` (None: it lacks
    that one): ``Shard`` of its dim on each mesh dim on which ``like`` is
    ``Shard`` of a dim in ``keep``, ``Replicate()`` on every other mesh
    dim (a shard of ``like``'s other dims is gathered)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in like.placements:
        role = keep.index(p.dim) if isinstance(p, Shard) and \
            p.dim in keep else None
        d = None if role is None else dims[role]
        out.append(Replicate() if d is None else Shard(d))
    return out


def map_local(fn, args, in_placements, out_placements, mesh,
              out_shapes=None):
    """``fn`` (returning a tuple) on each rank's local shards of the
    DTensors ``args``, redistributed to ``in_placements``, its outputs
    DTensors of ``out_placements`` (torch's ``local_map`` does the same
    where every shard is even: a kernel that takes raw pointers never
    sees a DTensor).  An input's gradient takes its placements, except
    ``Partial()`` on each mesh dim over which the input is replicated and
    an output is not: the ranks computed different parts there, so each
    holds a part of the gradient.  ``out_shapes`` gives the outputs'
    global shapes where a shard is uneven (heads the model axis does not
    divide); by default a rank's local size times the mesh's."""
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor, Partial, Replicate
    split = {i for pl in out_placements for i, p in enumerate(pl)
             if not isinstance(p, Replicate)}
    local = []
    for a, pl in zip(args, in_placements):
        if is_dtensor(a):
            pl = tuple(pl)
            grad = tuple(Partial() if i in split and isinstance(p, Replicate)
                         else p for i, p in enumerate(pl))
            if a.placements != pl:
                a = a.redistribute(mesh, pl)
            a = a.to_local(grad_placements=grad)
            if isinstance(a, AsyncCollectiveTensor):
                a = a.wait()
        local.append(a)
    outs = fn(*local)
    shapes = out_shapes or (None,) * len(outs)
    return tuple(DTensor.from_local(
        o, mesh, tuple(pl), run_check=False,
        shape=None if shp is None else torch.Size(shp),
        stride=None if shp is None else
        tuple(math.prod(shp[d + 1:]) for d in range(len(shp))))
        if isinstance(o, torch.Tensor) else o
        for o, pl, shp in zip(outs, out_placements, shapes))


def map_channels(fn, args, dims, out_dims, like):
    """``map_local`` of a function that acts on each batch row and channel
    on its own (a depthwise conv, a selective scan, Mamba2's SSD over its
    heads): ``like`` is (B, S, C, ...), and each of ``args`` and of
    ``fn``'s outputs carries its batch and channel roles at its dims in
    ``dims`` / ``out_dims`` (``placements_like``), so each rank computes
    its own batch rows and channels, with the sequence gathered."""
    pls = [placements_like(like, (0, 2), d) for d in dims]
    outs = [placements_like(like, (0, 2), d) for d in out_dims]
    return map_local(fn, args, pls, outs, like.device_mesh)


def contiguous_shards(t):
    """DTensor ``t`` with a contiguous local shard (a copy only where it
    is not): DTensor unpads a gather of uneven shards (a prompt the mesh
    does not split evenly) by ``narrow``, and torch 2.11's matmul of
    DTensors then refuses to ``view`` the local tensor."""
    from torch.distributed.tensor import DTensor
    local = t.to_local()
    if local.is_contiguous():
        return t
    return DTensor.from_local(local.contiguous(), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def chunk_range(length: int, n: int, i: int) -> Tuple[int, int]:
    """(offset, length) of piece ``i`` of ``length`` elements cut into
    ``n`` as ``torch.chunk`` cuts them: ceil-sized pieces, the last short,
    the pieces beyond it empty.  That is how DTensor's ``Shard`` lays out
    a dim over one mesh dim, and jax's padded split tiles it the same."""
    size = -(-length // n)
    start = min(i * size, length)
    return start, min(size, length - start)


def shard_range(length: int, mesh, placements, dim: int) -> Tuple[int, int]:
    """(global offset, length) of this rank's chunk of a tensor dim of
    ``length`` elements that ``placements`` on ``mesh`` shard: over each
    mesh dim in order on which it is ``Shard(dim)``, the chunk so far is
    cut by ``chunk_range``, which is how DTensor lays out its local
    shards.  On one mesh dim that is jax's split too; over two, DTensor
    nests the cuts (22 over 2 x 2: 6, 5, 6, 5) where jax cuts once (6, 6,
    6, 4)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    offset = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            start, length = chunk_range(length, mesh.size(i), coord[i])
            offset += start
    return offset, length


def zeros_sharded(shape, dtype, mesh, placements, fill=0, device=None):
    """A DTensor of ``shape`` and ``placements`` on ``mesh`` (its shards
    on ``device``, default the mesh's device type), every element
    ``fill``, for which each rank allocates only its own shard
    (``shard_range`` of each sharded dim): no rank ever holds the whole
    tensor, as a serve plan's cache needs."""
    from torch.distributed.tensor import DTensor
    local_shape = list(shape)
    for d in range(len(shape)):
        local_shape[d] = shard_range(shape[d], mesh, placements, d)[1]
    t = torch.full(local_shape, fill, dtype=dtype,
                   device=device or mesh.device_type)
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def all_reduce(t, op: str, mesh, dims: Sequence[int]):
    """``t`` reduced (``op``: "sum" or "max") over the mesh dims ``dims``
    of ``mesh``, one collective a dim (for use in a ``map_local`` body)."""
    from torch.distributed import _functional_collectives as funcol
    for i in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, mesh.get_group(i)))
    return t


def replicate(t):
    """A DTensor's ``Partial()`` placements reduced (an all-reduce over
    each of their mesh dims); a plain tensor as it is."""
    from torch.distributed.tensor import Partial, Replicate
    if not is_dtensor(t) or not any(isinstance(p, Partial)
                                    for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


def full(t):
    """A DTensor gathered whole on every rank (a collective: every rank
    of its mesh must call it); a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def local(t):
    """This rank's shard of a DTensor (sharing its storage when
    gradients are off); a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t
