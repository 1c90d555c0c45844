"""Per-device step statistics for the roofline: dot FLOPs, memory traffic
and collectives of one rank's step (the port's twin of
``repro.launch.hlo_analysis``).

The reference compiles a step and parses the HLO text, because XLA's own
cost analysis counts a ``while`` body once.  PyTorch runs eagerly, so
there is no HLO text to parse: this module watches the step run instead,
under a ``TorchDispatchMode`` (``StepAnalysis``), and counts every aten
operation as it executes, each loop iteration with it (hence the name:
it analyses a step, not an HLO module, as ``analysis.surface_lint`` is
``jaxpr_lint``'s twin).  Under the dry run (``launch.dryrun``) the
tensors are fake (``FakeTensorMode``) and the process group is the
"fake" backend, so a step of a 256- or 512-device mesh runs on one CPU
without memory or communication.

What it counts, per device, on the rank's local shards:

  * **dot FLOPs**: the matrix products (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``; what ``einsum``, ``@`` and ``F.linear`` reach), as the
    reference counts a ``dot``: 2 * numel(result) * contracted size.
    On fake tensors the analysis swaps the kernels' entry points for
    their shape-only paths (``launch.shape_only``), which report the
    work of their plain versions here.
  * **traffic**: operand plus result bytes of every local operation but
    views (``_unsafe_view`` among them), waits and metadata queries.
    Eager torch fuses nothing, so this is the reference's perfect-fusion
    estimate without the fusion: an upper bound on what a fused program
    moves.
  * **collectives** by the reference's kinds, with operand bytes, counts,
    the group's size (from the process group) and ring-model wire bytes;
    ``top_collectives`` keeps the reference's tuple (kind, dtype, dims,
    mult = 1, bytes, op), ``op`` the innermost function of the port that
    issued it (``module.function``, looking through the sharding helpers
    to their caller; the model's blocks are functions over parameter
    dicts, never called as ``nn.Module``s, so a module tracker would see
    only the model).

Local, not global: an operation on DTensors is not counted where it is
issued (the mode returns ``NotImplemented`` for it) but where DTensor
runs it on the local shards, and the operations that DTensor's sharding
propagation runs at the global shapes to learn the output's metadata
(``ShardingPropagator._propagate_tensor_meta_non_cached``, once per op
schema, on the outer fake mode) are not counted at all.

A shard-to-shard redistribution is counted as the all-to-all that NCCL
runs.  The dry run's mesh is a CPU mesh (a "cuda" mesh needs a CUDA
build of torch, and the dry run must run without a GPU), and on a CPU
mesh DTensor replaces the all-to-all by an all-gather and a chunk
(``placement_types.shard_dim_alltoall``, "CPU process group does not
support alltoall yet").  The mode recognises that fallback by wrapping
the function while it is active: the call counts as one all-to-all of
its input's bytes, and the gather and chunk inside it are not counted.

The peak of live bytes that the step allocates (``peak_bytes``: every
new storage from its first operation to its last reference) is the dry
run's ``temp_bytes`` (the arguments were allocated before the step).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from collections import defaultdict
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.bfloat16: 2, torch.float16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# torch's collective op names (functional and c10d) -> the reference's
_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("send", "collective-permute"), ("recv", "collective-permute"))
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}   # name -> lhs arg
_TOP = 24


def shape_bytes(dtype: torch.dtype, dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def _bytes(t) -> int:
    return shape_bytes(t.dtype, t.shape) if isinstance(t, torch.Tensor) \
        else 0


def _wire_factor(kind: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind in ("all-gather", "reduce-scatter"):
        return (g - 1) / g
    if kind == "all-to-all":
        return (g - 1) / g
    return 1.0            # collective-permute


@dataclasses.dataclass
class StepStats:
    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    # wire bytes: ring-model bytes actually crossing links per device
    wire_bytes: float = 0.0
    # (kind, dtype, dims, mult, bytes, op), the largest first
    top_collectives: list = dataclasses.field(default_factory=list)
    # the total of torch.utils.flop_counter's registry (every op it knows)
    flops: float = 0.0
    # dot FLOPs by the port function that issued them (``_site``)
    dot_flops_by_site: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    peak_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


# modules whose frames a site looks through to their caller: this one
# and the sharding helpers
_THROUGH = (__name__, "repro_torch.sharding")


def _site(name=None) -> str:
    """``module.function`` of the innermost frame of the port outside
    ``_THROUGH`` (or ``name``, a kernel's entry point), prefixed "bwd "
    inside a backward that the autograd engine runs (there the innermost
    frame is the caller of ``torch.autograd.grad`` for autograd's own
    products, the model's function for a rematerialised forward, the
    kernel's backward)."""
    graph_task = getattr(torch._C, "_current_graph_task_id", lambda: -1)
    tag = "bwd " if graph_task() != -1 else ""
    if name is not None:
        return tag + name
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch") and mod not in _THROUGH:
            return f"{tag}{mod[len('repro_torch.'):]}.{f.f_code.co_name}"
        f = f.f_back
    return f"{tag}?"


def _kind(name: str):
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except Exception:       # not a group's name
                continue
        if hasattr(a, "size") and not isinstance(a, torch.Tensor):
            return a.size()
    return 1


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, type) and issubclass(t, DTensor)


class StepAnalysis(TorchDispatchMode):
    """Fills ``self.stats`` (``StepStats``) with the local operations run
    while it is active (module docstring); with ``shape_only`` the
    kernels' fake inputs take their shape-only path
    (``launch.shape_only``)."""

    def __init__(self, shape_only: bool = True):
        super().__init__()
        self._shape_only = shape_only
        self.stats = StepStats()
        self._quiet = 0                # > 0: inside work not to count
        self._live = 0
        self._seen = weakref.WeakSet()
        self._patches = contextlib.ExitStack()

    # -------------------------------------------------------------- #
    def __enter__(self):
        self._patch()
        return super().__enter__()

    def __exit__(self, *exc):
        self._patches.close()
        return super().__exit__(*exc)

    def _patch(self):
        """Leave the sharding propagation's global-shape ops uncounted,
        count the CPU mesh's all-to-all fallback as an all-to-all, and
        (``shape_only``) swap in the kernels' shape-only paths."""
        from torch.distributed.tensor import _sharding_prop, placement_types
        from torch.distributed.tensor import _collective_utils, _redistribute
        prop = _sharding_prop.ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        if hasattr(prop, name):
            orig = getattr(prop, name)

            def propagate(*a, **k):
                with self.quiet():
                    return orig(*a, **k)
            self._patches.enter_context(_swap(prop, name, propagate))
        fallback = _collective_utils.shard_dim_alltoall

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            local = input.wait() if hasattr(input, "wait") else input
            if not self._quiet:
                self._collective("all-to-all", [local],
                                 mesh.size(mesh_dim), _bytes(local))
            with self.quiet():
                return fallback(input, gather_dim, shard_dim, mesh, mesh_dim)
        for mod in (placement_types, _redistribute, _collective_utils):
            if getattr(mod, "shard_dim_alltoall", None) is fallback:
                self._patches.enter_context(
                    _swap(mod, "shard_dim_alltoall", alltoall))
        if self._shape_only:
            from repro_torch.launch import shape_only
            for mod, name, fn in shape_only.entries(self):
                self._patches.enter_context(_swap(mod, name, fn))

    # -------------------------------------------------------------- #
    @contextlib.contextmanager
    def quiet(self):
        """Count nothing of what runs inside."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    @property
    def quieted(self) -> bool:
        return self._quiet > 0

    def report(self, dot_flops: float, traffic_bytes: float, flops: float,
               site: str) -> None:
        """A kernel's shape-only path (entry point ``site``) reports its
        plain version's work."""
        if self._quiet:
            return
        s = self.stats
        s.dot_flops += dot_flops
        s.traffic_bytes += traffic_bytes
        s.flops += flops
        s.dot_flops_by_site[_site(site)] += dot_flops

    def _collective(self, kind, operands, g, nbytes):
        s = self.stats
        s.collective_bytes[kind] += nbytes
        s.collective_counts[kind] += 1
        s.wire_bytes += nbytes * _wire_factor(kind, g)
        t = operands[0] if operands else None
        s.top_collectives.append(
            (kind, str(t.dtype).replace("torch.", "") if t is not None
             else "?", tuple(t.shape) if t is not None else (), 1,
             nbytes, _site()))
        s.top_collectives.sort(key=lambda c: -c[4])
        del s.top_collectives[_TOP:]

    def track(self, out) -> None:
        """Hold ``out``'s new storages in the live bytes until freed."""
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(st)
            self._live += n
            weakref.finalize(st, self._free, n)
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)

    def _free(self, n: int) -> None:
        self._live -= n

    # -------------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        s = self.stats
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                  "_dtensor"):
            if name == "wait_tensor":
                return
            kind = _kind(name)
            if kind is not None:
                ops = [t for t in tree_flatten((args, kwargs))[0]
                       if isinstance(t, torch.Tensor)]
                nbytes = sum(_bytes(t) for t in ops)
                s.traffic_bytes += nbytes + sum(
                    _bytes(t) for t in tree_flatten(out)[0])
                self._collective(kind, ops, _group_size(args), nbytes)
                return
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not outs or func.is_view or name in (
                "detach", "alias", "_unsafe_view", "lift_fresh"):
            return              # metadata (prim.device, sizes) and views
        self.track(out)
        s.traffic_bytes += sum(_bytes(t) for t in tree_flatten(
            (args, kwargs))[0]) + sum(_bytes(t) for t in outs)
        if name in _DOTS:
            lhs = args[_DOTS[name]]
            f = 2.0 * out.numel() * lhs.shape[-1]
            s.dot_flops += f
            s.dot_flops_by_site[_site()] += f
        if func._overloadpacket in flop_registry:
            try:
                s.flops += flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out)
            except Exception:       # a signature the registry lacks
                pass


@contextlib.contextmanager
def _swap(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def analyze(fn, *args, **kwargs) -> Tuple[object, StepStats]:
    """(fn(*args, **kwargs), its ``StepStats``)."""
    with StepAnalysis() as mode:
        out = fn(*args, **kwargs)
    return out, mode.stats
