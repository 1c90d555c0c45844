"""The PyTorch port stands alone: it imports neither jax nor the JAX
reference package, and its entry points refuse to drift to the CPU.

On a host without a GPU the default backend (``"cuda"``) must raise
``RuntimeError`` from every entry point instead of quietly planning on
the CPU; ``backend="torch"`` is how a caller asks for the CPU.  The same
holds for serving: ``build_model`` and ``serve`` default to the GPU and
``device="cpu"`` / ``--device cpu`` asks for the CPU, and for the
streaming planner service, whose default broker is the CUDA backend's.
So does training: ``launch.train`` and ``launch.elastic`` take
``--device cpu``, and ``init_train_state`` keeps the model's device.
The port's examples (``examples/port_*.py``) import neither package
either, and default to the GPU too.
The port computes attention, the selective scan and the joins in its own
kernels, never through a library's fused call, sort or search.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("port_*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    root = mod.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_port_import_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.kernels.plan_scan, repro_torch.kernels.build, "
            "repro_torch.obs, repro_torch.configs, repro_torch.sharding, "
            "repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.mamba_scan, repro_torch.models.common, "
            "repro_torch.models.attention, repro_torch.models.ssm, "
            "repro_torch.models.moe, "
            "repro_torch.models.transformer, repro_torch.models.model, "
            "repro_torch.runtime.steps, repro_torch.launch.serve, "
            "repro_torch.kernels.hash_join, repro_torch.kernels.merge_join, "
            "repro_torch.service, repro_torch.service.admission, "
            "repro_torch.service.traces, repro_torch.launch.mesh, "
            "repro_torch.core.roofline, repro_torch.core.sharding_planner, "
            "repro_torch.core.decision_tree, repro_torch.optim, "
            "repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.launch.train, repro_torch.launch.elastic, "
            "repro_torch.launch.dryrun, repro_torch.launch.step_analysis, "
            "repro_torch.launch.shape_only; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")


def test_default_backend_raises_without_gpu(no_gpu):
    from repro_torch.core.planning_backend import get_backend
    from repro_torch.kernels.plan_scan import CudaPlanBackend
    for make in (lambda: get_backend(None), lambda: get_backend("cuda"),
                 lambda: CudaPlanBackend()):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make()


def test_entry_points_raise_without_gpu(no_gpu):
    from repro_torch.core.cluster import paper_cluster
    from repro_torch.core.cost_model import simulator_cost_models
    from repro_torch.core.plan_broker import PlanBroker
    from repro_torch.core.plans import OperatorCosting
    from repro_torch.core.raqo import RAQO
    from repro_torch.core.schema import random_query, random_schema
    schema = random_schema(6, seed=0)
    queries = [random_query(schema, 3, seed=q) for q in range(2)]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        RAQO(schema, models=simulator_cost_models(),
             resource_planning="batched").plan_queries(queries)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PlanBroker()
    costing = OperatorCosting(models=simulator_cost_models(),
                              cluster=paper_cluster(),
                              resource_planning="batched")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        costing.plan_resources("SMJ", 1.0, 10.0)
    # asking for the CPU explicitly works
    plans = RAQO(schema, models=simulator_cost_models(),
                 resource_planning="batched",
                 backend="torch").plan_queries(queries)
    assert all(jp.plan is not None for jp in plans)


def test_sharding_planner_raises_without_gpu(no_gpu):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.sharding_planner import ShardingPlanner
    cfg, shape = get_config("smollm-360m"), get_shape("train_4k")
    for call in (lambda p: p.joint(cfg, shape),
                 lambda p: p.replan(cfg, shape, lost_chips=128)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call(ShardingPlanner())
    # asking for the CPU explicitly works
    assert ShardingPlanner(backend="torch").joint(cfg, shape).resources


def test_streaming_service_raises_without_gpu(no_gpu):
    from repro_torch.core.raqo import RAQO
    from repro_torch.core.schema import random_query, random_schema
    from repro_torch.service import StreamingPlannerService
    schema = random_schema(6, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        StreamingPlannerService(RAQO(schema))
    # asking for the CPU explicitly works
    svc = StreamingPlannerService(RAQO(schema, backend="torch"))
    ticket = svc.submit(random_query(schema, 3, seed=0))
    svc.drain()
    assert ticket.done and ticket.joint.plan is not None


def test_serve_and_build_model_raise_without_gpu(no_gpu):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models.model import build_model
    argv = ["--arch", "smollm-360m", "--smoke", "--requests", "1",
            "--max-new", "2"]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_model(get_config("falcon-mamba-7b").smoke())
    # asking for the CPU explicitly works
    assert main(argv + ["--device", "cpu"]) == 0


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_media_families_build_on_the_cpu_only_when_asked(no_gpu, arch):
    """The vlm and audio families build on the CPU when asked for it and
    raise without a GPU otherwise, as every other family does."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, check_supported
    check_supported(get_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_model(get_config(arch).smoke())
    assert build_model(get_config(arch).smoke(),
                       device="cpu").final_ln.device.type == "cpu"


def test_training_entry_points_raise_without_gpu(no_gpu, tmp_path,
                                                 monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import elastic, train
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state
    cfg = get_config("smollm-360m").smoke()
    argv = ["--arch", "smollm-360m", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "16"]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        elastic.main(argv[:5] + ["--ckpt-dir", str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        init_train_state(build_model(cfg), AdamW())
    assert not (tmp_path / "a").exists()
    # asking for the CPU explicitly works (the supervisor's trainer
    # subprocess finds the package on PYTHONPATH)
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    assert train.main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                              "--device", "cpu"]) == 0
    assert elastic.main(argv[:5] + ["--ckpt-dir", str(tmp_path / "b"),
                                    "--device", "cpu", "--", "--batch", "2",
                                    "--seq", "16"]) == 0
    state = init_train_state(build_model(cfg, device="cpu"), AdamW())
    assert state.params["embed"].device.type == "cpu"


def test_examples_raise_without_gpu(no_gpu, tmp_path):
    """The port's examples default to the GPU too: without one the
    planning example and the quickstart raise before they plan or write
    a checkpoint."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import port_quickstart
        import port_raqo_plan
    finally:
        sys.path.remove(str(ROOT / "examples"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_raqo_plan.main([])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_quickstart.main(["--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


LIBRARY_KERNELS = ("scaled_dot_product_attention", "flash_attn",
                   "selective_scan_fn", "mamba_ssm")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         sorted(PORT.rglob("*.cu")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_scan(path):
    text = path.read_text()
    bad = [name for name in LIBRARY_KERNELS if name in text]
    assert not bad, f"{path} calls {bad}"


# the join kernels sort and search by hand; only their plain versions in
# kernels/ref.py may call the library's
LIBRARY_SORT_SEARCH = ("searchsorted", "argsort", "torch.sort", "unique",
                       "thrust::", "cub::")
JOIN_KERNEL_FILES = [PORT / "kernels" / name for name in
                     ("hash_join.py", "merge_join.py", "csrc/hash_join.cu",
                      "csrc/merge_join.cu")]


@pytest.mark.parametrize("path", JOIN_KERNEL_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_join_kernels_call_no_library_sort_or_search(path):
    text = path.read_text()
    bad = [name for name in LIBRARY_SORT_SEARCH if name in text]
    assert not bad, f"{path} calls {bad}"
