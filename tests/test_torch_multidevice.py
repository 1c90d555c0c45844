"""The port's multi-device training on the CPU: worlds of processes over
gloo (``fixtures_torch_multidevice``), held against the reference.

- **Training at three meshes** (pod, data, model) (1, 2, 2), (2, 2, 1)
  and (1, 1, 4): three AdamW steps of the smoke smollm-360m (float32,
  4 q heads over 2 KV heads, so (1, 1, 4) holds one q head a rank) under
  ``plan_for``'s train plan (DP over pod and data, TP and sequence
  sharding over model, FSDP over data, remat nothing_saveable), from the
  reference's parameters carried across with ``load_jax_params``, on one
  batch of B=4, S=48 with 3 pads: each step's loss and grad norm, and
  every parameter after it, equal the reference's single-device JAX
  trajectory at test_torch_train.py's tolerances (LOSS_TOL, GRAD_TOL,
  PARAM_TOL).  K7 runs through ``local_map`` on each rank's heads.  Also
  microbatch 2 at (1, 2, 2) against the reference's microbatch-2 step.
  At each mesh ``global_norm`` makes one reduction a mesh dim of size >
  1, and every parameter's shard owns its storage (the model is placed
  leaf by leaf, holding no whole tensor alive).
- **``gpipe_apply``** at 2 stages (on a (2, 2, 1) mesh) and 4 (4, 1, 1)
  on the reference's own case (test_pipeline.py: L=8, B=8, S=16, d=32,
  tanh layers, n_micro=4, jax.random's numbers): the output equals the
  reference's sequential ``lax.scan`` to 1e-5 and the gradients of its sum
  (layers, biases, input) equal ``jax.grad``'s to 1e-4, on every rank.
- **A checkpoint** written at world 2 (mesh (1, 1, 2)) holds the whole
  state; it restores at world 2 into a model drawn from another seed
  exactly, and into a single-device state exactly.  That other model,
  drawn from its seed at world 2, equals the single-device model of the
  seed exactly.
- **``torchrun --nproc_per_node 2 -m repro_torch.launch.train --device
  cpu --smoke``**: the ``[raqo]`` line names 2 chips; crashed at step 12
  and resumed from the step-10 checkpoint, it reaches the uninterrupted
  run's final loss (test_system.py's case for the reference).
- **Preemption at world 2**: SIGTERM to rank 1 alone stops both ranks
  at one step with exit code 17 and that step's checkpoint; relaunched,
  the world reaches the uninterrupted run's final loss.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fixtures_torch_multidevice as fx
from repro.models import build_model as rbuild
from repro.optim import AdamW as RAdamW
from repro.runtime.steps import TrainState as RTrainState
from repro.runtime.steps import make_train_step as rmake_train_step
from repro.sharding import single_device_plan as rsingle_device_plan
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.model import build_model, load_jax_params
from repro_torch.optim import AdamW
from repro_torch.runtime.steps import init_train_state
from test_torch_train import (GRAD_TOL, LOSS_TOL, LR, PARAM_TOL, _batch,
                              _cfgs)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m"
B, S = 4, 48
MESHES = [(1, 2, 2), (2, 2, 1), (1, 1, 4)]
RUNS = [(m, 1) for m in MESHES] + [((1, 2, 2), 2)]        # (mesh, microbatch)
STEPS = range(1, fx.STEPS + 1)
GPIPE_STAGES = {2: (2, 2, 1), 4: (4, 1, 1)}
TORCHRUN = ["--arch", ARCH, "--smoke", "--steps", "20", "--batch", "2",
            "--seq", "32", "--ckpt-every", "5", "--log-every", "20",
            "--device", "cpu"]
assert (fx.LR, fx.LOSS_TOL, fx.GRAD_TOL, fx.PARAM_TOL) == \
    (LR, LOSS_TOL, GRAD_TOL, PARAM_TOL)


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's parameters and the batch as files, and its
    trajectory: {microbatch: [(loss, grad norm, params in the port's
    names) after each step]}."""
    d = tmp_path_factory.mktemp("multidevice")
    rcfg, cfg = _cfgs(ARCH)
    params = rbuild(rcfg).init(jax.random.PRNGKey(0))
    batch = _batch(cfg, B=B, S=S)
    np.savez(d / "params.npz", **_flat_tree(params))
    np.savez(d / "batch.npz", **batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    trajectories = {}
    for mb in sorted({mb for _, mb in RUNS}):
        rmodel = rbuild(rcfg, rsingle_device_plan().with_(microbatch=mb))
        opt = RAdamW(lr=LR)
        state = RTrainState(params, opt.init(params),
                            jnp.zeros((), jnp.int32))
        step = jax.jit(rmake_train_step(rmodel, opt))
        traj = []
        for _ in STEPS:
            state, m = step(state, jbatch)
            traj.append((float(m["loss"]), float(m["grad_norm"]),
                         load_jax_params(jax.tree_util.tree_map(
                             np.asarray, state.params), cfg)))
        trajectories[mb] = traj
    return d, trajectories


@pytest.fixture(scope="module")
def trained(inputs):
    """One world a run of RUNS: {(mesh, microbatch): its results}."""
    d, _ = inputs
    out = {}
    for mesh, mb in RUNS:
        path = d / f"train_{''.join(map(str, mesh))}_mb{mb}.npz"
        fx.spawn(fx.train_worker, int(np.prod(mesh)), mesh,
                 str(d / "params.npz"), str(d / "batch.npz"), str(path), mb)
        with np.load(path) as f:
            out[(mesh, mb)] = dict(f)
    return out


def _run_id(run):
    mesh, mb = run
    return "x".join(map(str, mesh)) + (f"-mb{mb}" if mb > 1 else "")


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_training_matches_reference(inputs, trained, run, step):
    rloss, rgnorm, rparams = inputs[1][run[1]][step - 1]
    got = trained[run]
    assert abs(float(got[f"loss_{step}"]) / rloss - 1) <= LOSS_TOL
    assert abs(float(got[f"grad_norm_{step}"]) / rgnorm - 1) <= GRAD_TOL
    names = sorted(k[len(f"p{step}/"):] for k in got
                   if k.startswith(f"p{step}/"))
    assert names == sorted(rparams)
    for name in names:
        np.testing.assert_allclose(got[f"p{step}/{name}"],
                                   rparams[name].numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_parameters_are_sharded_by_the_plan(trained, mesh):
    """The embedding (vocab over model, d over data) and a wq (d over
    data, heads over model) are DTensors on the mesh's dims of size > 1."""
    embed, wq = trained[(mesh, 1)]["placements"]
    want = {(1, 2, 2): ("(Shard(dim=1), Shard(dim=0))",
                        "(Shard(dim=0), Shard(dim=1))"),
            (2, 2, 1): ("(Replicate(), Shard(dim=1))",
                        "(Replicate(), Shard(dim=0))"),
            (1, 1, 4): ("(Shard(dim=0),)", "(Shard(dim=1),)")}[mesh]
    assert (str(embed), str(wq)) == want


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_global_norm_is_one_sum_over_the_mesh(trained, mesh):
    """One reduction a mesh dim of size > 1, not one a parameter."""
    want = sum(1 for n in mesh if n > 1)
    assert int(trained[(mesh, 1)]["norm_collectives"]) == want


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_parameter_shards_hold_no_whole_tensor(trained, mesh):
    """Each rank's shard owns its storage: the whole tensor it was cut
    from is freed as the model is built."""
    assert bool(trained[(mesh, 1)]["own_storage"])


@pytest.fixture(scope="module")
def gpipe(tmp_path_factory):
    """The reference's case and its sequential output and gradients, and
    each stage count's gpipe_apply results."""
    d = tmp_path_factory.mktemp("gpipe")
    key = jax.random.PRNGKey(0)
    L, Bp, Sp, dm = 8, 8, 16, 32
    ws = jax.random.normal(key, (L, dm, dm)) * 0.2
    bs = jax.random.normal(key, (L, dm)) * 0.1
    x = jax.random.normal(key, (Bp, Sp, dm))

    def seq(params, x):
        def one(h, p):
            wi, bi = p
            return jnp.tanh(h @ wi + bi), None
        return jax.lax.scan(one, x, params)[0]

    want = {"out": seq((ws, bs), x)}
    (want["gw"], want["gb"]), want["gx"] = jax.grad(
        lambda p, x: seq(p, x).sum(), argnums=(0, 1))((ws, bs), x)
    np.savez(d / "case.npz", ws=np.asarray(ws), bs=np.asarray(bs),
             x=np.asarray(x))
    got = {}
    for n, mesh in GPIPE_STAGES.items():
        path = d / f"gpipe_{n}.npz"
        fx.spawn(fx.gpipe_worker, int(np.prod(mesh)), mesh,
                 str(d / "case.npz"), str(path), 4)
        with np.load(path) as f:
            got[n] = dict(f)
    return {k: np.asarray(v) for k, v in want.items()}, got


@pytest.mark.parametrize("stages", sorted(GPIPE_STAGES))
def test_gpipe_forward_matches_sequential(gpipe, stages):
    want, got = gpipe
    assert np.abs(got[stages]["out"] - want["out"]).max() < 1e-5
    assert float(got[stages]["spread_out"]) == 0.0


@pytest.mark.parametrize("stages", sorted(GPIPE_STAGES))
def test_gpipe_gradients_match_sequential(gpipe, stages):
    want, got = gpipe
    for k in ("gw", "gb", "gx"):
        assert np.abs(got[stages][k] - want[k]).max() < 1e-4, k
        assert float(got[stages][f"spread_{k}"]) == 0.0, k


@pytest.fixture(scope="module")
def checkpointed(inputs):
    d, _ = inputs
    ckpt_dir, path = d / "ckpt", d / "ckpt_out.npz"
    fx.spawn(fx.checkpoint_worker, 2, (1, 1, 2), str(d / "params.npz"),
             str(d / "batch.npz"), str(ckpt_dir), str(path))
    with np.load(path) as f:
        return ckpt_dir, dict(f)


def test_checkpoint_round_trip_at_world_two(inputs, checkpointed):
    ckpt_dir, got = checkpointed
    assert list(got["steps"]) == [0, 1]
    _, cfg = _cfgs(ARCH)
    with np.load(inputs[0] / "params.npz") as f:
        initial = load_jax_params(fx.unflatten(dict(f)), cfg)
    keys = [k[len("stepped/"):] for k in got if k.startswith("stepped/")]
    for k in keys:
        part, name = k.split("/", 1)
        # step 0: the parameters it was given, zero moments
        want0 = initial[name].numpy() if part == "p" else 0.0
        np.testing.assert_array_equal(got[f"restored0/{k}"],
                                      np.broadcast_to(want0, got[
                                          f"restored0/{k}"].shape), k)
        np.testing.assert_array_equal(got[f"restored1/{k}"],
                                      got[f"stepped/{k}"], k)
    # the step it took is the reference's first
    rparams = inputs[1][1][0][2]
    for name in rparams:
        np.testing.assert_allclose(got[f"stepped/p/{name}"],
                                   rparams[name].numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=name)


def test_seeded_build_at_world_two_equals_one_device(checkpointed):
    """Drawn leaf by leaf and placed as drawn, a distributed model holds
    the single-device model's numbers for the same seed."""
    _, got = checkpointed
    _, cfg = _cfgs(ARCH)
    model = build_model(cfg, device="cpu", seed=7)
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(k[len("drawn7/"):] for k in got
                                   if k.startswith("drawn7/"))
    for name, p in names.items():
        np.testing.assert_array_equal(got[f"drawn7/{name}"],
                                      p.detach().numpy(), name)


def test_checkpoint_from_world_two_restores_on_one_device(checkpointed):
    ckpt_dir, got = checkpointed
    _, cfg = _cfgs(ARCH)
    model = build_model(cfg, device="cpu", seed=5)
    state, extras = CheckpointManager(str(ckpt_dir)).restore(
        init_train_state(model, AdamW(lr=LR)))
    assert extras["data_step"] == 1
    for part, tree in (("p", state.params), ("m", state.opt_state.m),
                       ("v", state.opt_state.v)):
        for name, t in tree.items():
            np.testing.assert_array_equal(t.detach().numpy(),
                                          got[f"stepped/{part}/{name}"])


@pytest.fixture(scope="module")
def torchrun_runs(tmp_path_factory):
    """The trainer under torchrun at world 2: whole, crashed at step 12,
    resumed."""
    d = tmp_path_factory.mktemp("torchrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
             *TORCHRUN, *extra], capture_output=True, text=True,
            timeout=300, env=env, cwd=ROOT)

    whole = run("--ckpt-dir", str(d / "a"))
    crashed = run("--ckpt-dir", str(d / "b"), "--fail-at", "12")
    resumed = run("--ckpt-dir", str(d / "b"))
    return whole, crashed, resumed


def _final(out):
    return [l for l in out.splitlines() if "done:" in l][-1].split("loss")[-1]


def test_torchrun_trains_on_the_planned_mesh(torchrun_runs):
    whole = torchrun_runs[0]
    assert whole.returncode == 0, whole.stdout + whole.stderr[-3000:]
    raqo = [l for l in whole.stdout.splitlines() if l.startswith("[raqo]")]
    assert len(raqo) == 1 and "(2 chips)" in raqo[0], whole.stdout
    assert "[train] mesh pod x data x model = (1, 1, 2) over 2 of 2 ranks" \
        in whole.stdout
    # rank 0 alone logs
    assert whole.stdout.count("[train] done:") == 1


def test_torchrun_crash_then_resume_reaches_the_same_loss(torchrun_runs):
    whole, crashed, resumed = torchrun_runs
    assert crashed.returncode == 1, crashed.stdout + crashed.stderr[-3000:]
    assert "SIMULATED FAILURE at step 12" in crashed.stdout
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr[-3000:]
    assert "resumed from step 10" in resumed.stdout
    assert _final(resumed.stdout) == _final(whole.stdout)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def preempted_runs(tmp_path_factory):
    """The trainer at world 2, each rank started as torchrun starts it
    (so each rank's exit code is seen), SIGTERM sent to rank 1 alone once
    rank 0 has logged its first step; then the world relaunched."""
    import signal
    d = tmp_path_factory.mktemp("preempt")
    args = [*TORCHRUN, "--log-every", "1", "--ckpt-dir", str(d / "ck")]

    def world():
        port = _free_port()
        procs = []
        for rank in range(2):
            env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
                   "OMP_NUM_THREADS": "1", "RANK": str(rank),
                   "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
                   "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *args],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=ROOT))
        return procs

    procs = world()
    head = []
    for line in procs[0].stdout:
        head.append(line)
        if line.startswith("[train] step"):
            procs[1].send_signal(signal.SIGTERM)
            break
    outs = [p.communicate(timeout=300)[0] for p in procs]
    outs[0] = "".join(head) + outs[0]
    stopped = [(p.returncode, o) for p, o in zip(procs, outs)]
    saved = CheckpointManager(str(d / "ck")).latest_step()
    procs = world()
    resumed = [(p.returncode, o) for p, o in
               ((p, p.communicate(timeout=300)[0]) for p in procs)]
    return saved, stopped, resumed


def _stopped_at(out: str) -> int:
    done = [l for l in out.splitlines() if "preempted at step" in l]
    assert len(done) == 1, out
    return int(done[0].split("preempted at step")[1].split(";")[0])


def test_sigterm_on_one_rank_stops_the_world_at_one_step(preempted_runs):
    saved, stopped, _ = preempted_runs
    for rc, out in stopped:
        assert rc == 17, out[-3000:]
    step = _stopped_at(stopped[0][1])
    assert step < 20
    assert saved == step


def test_preempted_world_resumes_to_the_uninterrupted_loss(preempted_runs,
                                                          torchrun_runs):
    _, stopped, resumed = preempted_runs
    for rc, out in resumed:
        assert rc == 0, out[-3000:]
    step = _stopped_at(stopped[0][1])
    assert f"resumed from step {step}\n" in resumed[0][1]
    assert _final(resumed[0][1]) == _final(torchrun_runs[0].stdout)
