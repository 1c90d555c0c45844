"""The port's step analysis (``repro_torch.launch.step_analysis``): per-device
dot FLOPs, bytes and collectives of a step, the twins of
``tests/test_hlo_analysis.py`` where the idea carries over, and its own
cases: local counts of DTensor operations, the CPU mesh's all-to-all
fallback counted as an all-to-all, and the kernels' shape-only path on
fake tensors (``launch.shape_only``) counting exactly what their plain
versions count.

``test_parse_tuple_result_while`` has no twin: it tests the parsing of
HLO text, and the port has no HLO text to parse (the mode watches the
operations run).  The scan tests' twins are loops: eager torch has no
loop body to under-count, but the count must follow every iteration.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import step_analysis as H
from repro_torch.launch.mesh import fake_world, make_mesh
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)


def _stats(fn, *args):
    return H.analyze(fn, *args)[1]


def test_single_matmul_flops():
    x, w = torch.randn(128, 256), torch.randn(256, 64)
    s = _stats(lambda a, b: a @ b, x, w)
    assert s.dot_flops == 2 * 128 * 256 * 64


def test_loop_multiplies_flops():
    x, ws = torch.randn(128, 128), torch.randn(10, 128, 128)

    def looped(c, ws):
        for w in ws:
            c = c @ w
        return c
    assert _stats(looped, x, ws).dot_flops == 10 * 2 * 128 ** 3


def test_nested_loop_multiplies():
    x, ws = torch.randn(64, 64), torch.randn(4, 3, 64, 64)

    def nested(c, ws):
        for group in ws:
            for w in group:
                c = torch.einsum("ij,jk->ik", c, w)
        return c
    assert _stats(nested, x, ws).dot_flops == 12 * 2 * 64 ** 3


def test_dtype_bytes():
    assert H.shape_bytes(torch.bfloat16, (2, 3)) == 12
    assert H.shape_bytes(torch.float32, ()) == 4
    assert H.shape_bytes(torch.bool, (8,)) == 8


def test_collective_bytes_and_wire_factor():
    from torch.distributed import _functional_collectives as funcol
    with fake_world(4):
        a = torch.ones(8, 128, dtype=torch.bfloat16)
        s = _stats(lambda t: funcol.wait_tensor(
            funcol.all_reduce(t, "sum", dist.group.WORLD)), a)
    b = 8 * 128 * 2
    assert s.collective_bytes["all-reduce"] == b
    assert s.collective_counts["all-reduce"] == 1
    assert s.wire_bytes == pytest.approx(b * 2 * 3 / 4)


def test_single_device_step_counts_no_collective():
    s = _stats(lambda a: a.sum(), torch.randn(64))
    assert s.total_collective_bytes == 0
    assert not s.collective_counts


def test_dtensor_product_counts_local_shapes():
    """A (64, 128) @ (128, 32) product with rows sharded 8 ways counts the
    local product, 2 * 8 * 128 * 32, on its first call (when DTensor's
    sharding propagation runs the global product on a fake mode) and on
    its second; FlopCounterMode at the top counts the global 524,288."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with fake_world(8):
        mesh = make_mesh((8,), ("model",))
        x = distribute_tensor(torch.randn(64, 128), mesh, [Shard(0)])
        w = distribute_tensor(torch.randn(128, 32), mesh, [Replicate()])
        first = _stats(torch.mm, x, w)
        second = _stats(torch.mm, x, w)
    assert first.dot_flops == second.dot_flops == 65_536


def test_shard_to_shard_counts_one_all_to_all():
    from torch.distributed.tensor import Shard, distribute_tensor
    with fake_world(4):
        mesh = make_mesh((4,), ("model",))
        x = distribute_tensor(torch.randn(16, 32), mesh, [Shard(0)])
        s = _stats(lambda t: t.redistribute(mesh, [Shard(1)]).to_local(), x)
    assert dict(s.collective_counts) == {"all-to-all": 1}
    assert s.collective_bytes["all-to-all"] == 4 * 32 * 4
    assert s.wire_bytes == pytest.approx(4 * 32 * 4 * 3 / 4)


# ---------------- the kernels' shape-only path on fake tensors ------------ #
def _fake_counts(fn, *args):
    """Counts of ``fn`` on fake copies of ``args`` (the shape-only path)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = [None if a is None else mode.from_tensor(a) for a in args]
        s = _stats(fn, *fake)
    return s.dot_flops, s.traffic_bytes, s.flops


def _real_counts(fn, *args):
    s = _stats(fn, *args)
    return s.dot_flops, s.traffic_bytes, s.flops


ATTN = [dict(causal=True), dict(causal=False),
        dict(causal=True, window=3, attn_softcap=5.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", ATTN, ids=["causal", "full", "window_cap"])
def test_attention_shape_only_counts_the_plain_version(dtype, opts):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 4, 8, generator=g).to(dtype)
    k, v = (torch.randn(2, 7, 2, 8, generator=g).to(dtype) for _ in "kv")
    real = _real_counts(lambda *a: attention_ref(*a, **opts), q, k, v)
    fake = _fake_counts(lambda *a: fa.flash_attention(*a, **opts), q, k, v)
    assert real[0] > 0 and fake == real
    out = attention_ref(q, k, v, **opts)
    real = _real_counts(lambda *a: fa.attention_backward(*a, **opts),
                        q, k, v, out, out)
    fake = _fake_counts(lambda *a: fa.attention_backward(*a, **opts),
                        q, k, v, out, out)
    assert real[0] > 0 and fake == real


def _scan_inputs(dtype, S, with_h0):
    g = torch.Generator().manual_seed(1)
    B, D, N = 2, 6, 4
    u = torch.randn(B, S, D, generator=g).to(dtype)
    dt = torch.rand(B, S, D, generator=g).to(dtype)
    A = -torch.rand(D, N, generator=g)
    Bm, Cm = (torch.randn(B, S, N, generator=g).to(dtype) for _ in "BC")
    h0 = torch.randn(B, D, N, generator=g) if with_h0 else None
    return u, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0none", "h0"])
@pytest.mark.parametrize("S", [1, 2, 9, 12])
def test_scan_shape_only_counts_the_plain_version(dtype, with_h0, S):
    """K8's forward at S, and its backward at S with chunks of 4: one
    chunk at S <= 2, at 9 two whole chunks and one of a step, at 12 three
    whole chunks (a last chunk beyond 3 steps, counted by the linear
    fit)."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels.ref import selective_scan_ref
    args = _scan_inputs(dtype, S, with_h0)
    real = _real_counts(selective_scan_ref, *args)
    fake = _fake_counts(lambda *a: ms.selective_scan(*a), *args)
    assert real[0] > 0 and fake == real
    y, h = selective_scan_ref(*args)

    def bwd(*a):
        return ms.selective_scan_backward(*a, chunk=4)
    real = _real_counts(bwd, *args, y, h)
    fake = _fake_counts(bwd, *args, y, h)
    assert real[0] > 0 and fake == real


def test_fake_world_is_destroyed_on_exit():
    with fake_world(512, rank=3):
        assert dist.get_world_size() == 512 and dist.get_rank() == 3
    assert not dist.is_initialized()
