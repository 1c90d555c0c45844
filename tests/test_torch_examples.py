"""The port's examples (``examples/port_*.py``) on the CPU
(``--device cpu``), each beside the reference example it follows.

- ``port_raqo_plan.py`` prints, line for line, what the reference's
  ``examples/raqo_plan.py`` prints (run in a subprocess under
  ``JAX_PLATFORMS=cpu``), apart from the ``planner ... ms`` field: the
  exact torch backend plans and costs as the reference's numpy backend
  does, bit for bit.  On the float32 CUDA backend (the card's; here its
  kernels' plain versions) its DB domain prints the reference's pallas
  backend's lines instead: Q3's root join takes another config of the
  same time in float32.
- ``port_serve_batch.py`` serves its 8 requests of 16 tokens.
- ``port_quickstart.py``: the loss falls and two checkpoints remain.  It
  runs in-process at 40 steps of 2 x 32 (the reference's 200 of 8 x 128
  take ~30 s on a CPU), logging every 10 and checkpointing every 20.
- ``port_elastic_train.py`` crashes at step 15, replans, resumes from
  step 15 and exits 0, at the reference's arguments.

The card's twin is ``chip_smoke.py``'s phase 17, which runs all four at
the reference's sizes on the GPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    """Two threads a process (this one's and the examples' subprocesses'):
    the suite runs beside other workers, and the smoke models gain
    nothing from more."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def examples():
    sys.path.insert(0, str(EXAMPLES))
    try:
        import port_elastic_train
        import port_quickstart
        import port_raqo_plan
        import port_serve_batch
    finally:
        sys.path.remove(str(EXAMPLES))
    return {"raqo_plan": port_raqo_plan, "quickstart": port_quickstart,
            "serve_batch": port_serve_batch,
            "elastic_train": port_elastic_train}


def _untimed(lines):
    return [re.sub(r"planner [0-9.]+ms", "planner <ms>", line)
            for line in lines]


def test_raqo_plan_prints_the_reference_lines(examples, capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(EXAMPLES / "raqo_plan.py")],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert examples["raqo_plan"].main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    want = proc.stdout.splitlines()
    assert len(want) == 24
    assert _untimed(got) == _untimed(want)
    # the timing field is the only one masked
    assert sum(a != b for a, b in zip(got, want)) <= 1


def _module(path, name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_raqo_plan_on_the_kernels_plain_versions(examples, capsys):
    """What ``port_raqo_plan.py`` prints on the card: its DB domain on
    the float32 CUDA backend (here ``CudaPlanBackend(device="cpu")``, the
    kernels' plain versions, which the card's kernels equal bit for bit)
    prints the reference example's DB lines on the reference's pallas
    backend.  Both pick another of the configs whose time ties in float32
    on Q3's root join than the exact backends do: (100, 3) for $0.0550,
    not (100, 10) for $0.1951, after 5,144 configs, not 1,727.  The
    other lines are the exact backend's."""
    import functools
    from repro.core import RAQO as RRAQO
    from repro_torch.kernels.plan_scan import CudaPlanBackend
    ref = _module(EXAMPLES / "raqo_plan.py", "ref_raqo_plan")
    ref.RAQO = functools.partial(RRAQO, backend="pallas")
    ref.db_domain()
    want = capsys.readouterr().out.splitlines()
    examples["raqo_plan"].db_domain(CudaPlanBackend(device="cpu"))
    got = capsys.readouterr().out.splitlines()
    assert _untimed(got) == _untimed(want)
    assert "$0.0550" in got[3] and "configs 5144" in got[3]
    assert got[4].startswith("SMJ r=(100, 3) cost=12.12s total=15.34s")
    examples["raqo_plan"].db_domain("torch")
    exact = capsys.readouterr().out.splitlines()
    assert [i for i, (a, b) in enumerate(zip(_untimed(got),
                                             _untimed(exact)))
            if a != b] == [3, 4, 5]


def test_serve_batch_finishes_its_requests(examples, capfd):
    assert examples["serve_batch"].main(["--device", "cpu"]) == 0
    out = capfd.readouterr().out
    assert len(re.findall(r"rid=\d+ done: .*\(16 toks\)", out)) == 8
    assert "[serve] served 8 requests" in out


def test_quickstart_loss_falls_and_checkpoints(examples, capsys, tmp_path):
    ckpt = tmp_path / "ckpt"
    assert examples["quickstart"].main(
        ["--device", "cpu", "--steps", "40", "--batch", "2", "--seq", "32",
         "--log-every", "10", "--ckpt-every", "20",
         "--ckpt-dir", str(ckpt)]) == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert "done — checkpoints: [20, 40]" in out
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_20", "step_40"]


def test_elastic_train_resumes_after_its_crash(examples, capfd, tmp_path):
    assert examples["elastic_train"].main(
        ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")]) == 0
    out = capfd.readouterr().out
    for line in ("[train] SIMULATED FAILURE at step 15",
                 "[elastic] exit=1; lost chips so far: 128; replanning",
                 "[train] resumed from step 15",
                 "[train] done: 30 steps",
                 "[elastic] training completed"):
        assert line in out, out
