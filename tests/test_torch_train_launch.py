"""The port's training launcher and elastic supervisor on the CPU
(``--device cpu``): the counterparts of ``tests/test_system.py``'s
crash/resume, SIGTERM and elastic tests, run as subprocesses."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "PYTHONUNBUFFERED": "1"}
SMOKE = ["--arch", "smollm-360m", "--smoke", "--device", "cpu"]


def _run(args, timeout=600):
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, env=ENV, cwd=ROOT)


def _final(out):
    return [l for l in out.splitlines() if "done" in l][-1]


def _crash_resume_identical(tmp_path, arch):
    base = ["-m", "repro_torch.launch.train", "--arch", arch,
            *SMOKE[2:], "--steps", "20",
            "--batch", "2", "--seq", "32", "--ckpt-every", "5",
            "--log-every", "20"]
    r1 = _run(base + ["--ckpt-dir", str(tmp_path / "a")])
    assert r1.returncode == 0, r1.stdout + r1.stderr
    r2 = _run(base + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at", "12"])
    assert r2.returncode == 1, r2.stdout + r2.stderr
    assert "SIMULATED FAILURE at step 12" in r2.stdout
    r3 = _run(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert r3.returncode == 0, r3.stdout + r3.stderr
    assert "resumed from step 10" in r3.stdout
    final_a, final_b = _final(r1.stdout), _final(r3.stdout)
    assert final_a.startswith("[train] done: 20 steps, final loss")
    assert final_a.split("loss")[-1] == final_b.split("loss")[-1]


def test_train_crash_resume_identical(tmp_path):
    """Training with a mid-run crash + resume reaches the same final loss
    as an uninterrupted run (deterministic data + checkpointing)."""
    _crash_resume_identical(tmp_path, "smollm-360m")


def test_moe_train_crash_resume_identical(tmp_path):
    """The same for the moe family (its aux losses in the loss)."""
    _crash_resume_identical(tmp_path, "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_media_families_train_crash_resume_identical(tmp_path, arch):
    """The same for the vlm (batches with media; its cross blocks' 0-d
    gates checkpointed and restored) and the audio family (batches of
    frame embeddings, no embed)."""
    _crash_resume_identical(tmp_path, arch)


def test_sigterm_checkpoint_then_exit(tmp_path):
    """SIGTERM after the first logged step: checkpoint, then exit 17."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *SMOKE,
         "--steps", "5000000", "--batch", "2", "--seq", "32",
         "--ckpt-every", "1000000", "--log-every", "2",
         "--ckpt-dir", str(tmp_path)],
        env=ENV, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        lines = []
        for line in proc.stdout:             # wait for a logged step
            lines.append(line)
            if line.startswith("[train] step"):
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
    out = "".join(lines) + out
    assert proc.returncode == 17, out        # PREEMPT_EXIT
    assert "checkpoint-then-exit" in out and "preempted" in out
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())


def test_elastic_supervisor_replans(tmp_path):
    r = _run(["-m", "repro_torch.launch.elastic", "--arch", "smollm-360m",
              "--smoke", "--device", "cpu", "--steps", "16",
              "--max-restarts", "2", "--ckpt-dir", str(tmp_path), "--",
              "--fail-at", "9", "--batch", "2", "--seq", "32",
              "--ckpt-every", "4", "--log-every", "8"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert "initial RAQO decision" in r.stdout
    assert "exit=1; lost chips so far: 128" in r.stdout
    assert "new RAQO decision" in r.stdout
    assert "resumed from step 8" in r.stdout
    assert "training completed" in r.stdout


def test_default_ckpt_dir_never_resumes(tmp_path, monkeypatch, capsys):
    """Without --ckpt-dir each run checkpoints into a new temporary
    directory: a second run starts at step 0 instead of resuming from
    the first run's checkpoints."""
    import tempfile
    from repro_torch.launch import train
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = SMOKE + ["--steps", "2", "--batch", "2", "--seq", "16",
                    "--ckpt-every", "1", "--log-every", "1"]
    dirs = []
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    for _ in range(2):
        try:
            assert train.main(argv) == 0
        finally:                    # the trainer installs its own
            for s, h in handlers.items():
                signal.signal(s, h)
        out = capsys.readouterr().out
        assert "resumed from step" not in out
        dirs.append(out.split("[train] checkpoints in ")[1].split()[0])
    assert dirs[0] != dirs[1]
    assert all(Path(d).parent == tmp_path and
               any(Path(d).glob("step_2")) for d in dirs)
