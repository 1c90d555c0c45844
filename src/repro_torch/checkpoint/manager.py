"""Fault-tolerant checkpointing (the port of ``repro.checkpoint.manager``).

Layout per step:  <dir>/step_<n>/{manifest.json, arrays.npz}  written to a
tmp dir first and atomically renamed (a crash mid-save never corrupts the
latest checkpoint).  ``keep`` bounds disk; ``save_async`` offloads the host
write to a thread (the device-to-host copy is synchronous, the disk write
is not).

A state is a tree of tensors: NamedTuples (``TrainState``, ``OptState``),
tuples, lists and dicts (flattened in sorted key order, as jax flattens a
dict), ``None`` an empty subtree.  Leaves are numbered in that order, as
the reference numbers its pytree's leaves.  ``restore`` copies each saved
leaf into the matching tensor of the target, in place (so a model's
parameters stay the model's), and refuses a checkpoint whose leaf count or
shapes differ from the target's.  bfloat16 leaves are stored as float32
(numpy has no bfloat16) and cast back on restore.

Under torch.distributed (a world of more than one process, or the ranks
of ``group``) every rank calls ``save`` and ``restore`` alike: a DTensor
leaf is gathered whole on every rank (``full_tensor``, a collective) one
leaf at a time, only the first rank keeps the gathered leaves and writes,
and the ranks wait at a barrier until the step is published.
``restore`` copies each rank's shard of the saved whole
tensor into a DTensor target (its placements, the plan's), so a
checkpoint restores at any mesh, or on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.sharding import distribute, full, is_dtensor


def _flatten(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    raise TypeError(f"checkpoint leaves are tensors, got {type(tree)}")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = full(t.detach())
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, group=None):
        """``group``: the process group whose ranks save together
        (default: the whole world, when torch.distributed runs)."""
        self.group = group
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, state: Any, extras: Optional[dict] = None,
             async_: bool = False) -> Path:
        if self._shared():
            import torch.distributed as dist
            writer = dist.get_rank(self.group) == 0
            # every rank gathers each leaf (a collective); the writer
            # alone keeps them on the host
            host_leaves = [h for h in map(_to_host, _flatten(state))
                           if writer]
            if writer:
                self._write(step, host_leaves, extras)
            dist.barrier(self.group)
            return self.dir / f"step_{step}"
        host_leaves = [_to_host(l) for l in _flatten(state)]  # device->host
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, extras),
                daemon=True)
            self._thread.start()
            return self.dir / f"step_{step}"
        return self._write(step, host_leaves, extras)

    def _write(self, step: int, host_leaves, extras) -> Path:
        final = self.dir / f"step_{step}"
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}_{time.time_ns()}"
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{f"leaf_{i}": l for i, l in enumerate(host_leaves)})
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "shapes": [list(l.shape) for l in host_leaves],
            "dtypes": [str(l.dtype) for l in host_leaves],
            "extras": extras or {},
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic publish
        self._gc()
        return final

    def _shared(self) -> bool:
        """Whether more than one rank saves this state."""
        import torch.distributed as dist
        return dist.is_available() and dist.is_initialized() and \
            dist.get_world_size(self.group) > 1

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------ #
    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, target: Any, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        """Copy checkpoint ``step`` (default: the latest) into the tensors
        of ``target``, in place; returns (target, extras)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        leaves = _flatten(target)
        if len(leaves) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, target has "
                f"{len(leaves)} — architecture mismatch")
        shapes = [list(l.shape) for l in leaves]
        if shapes != manifest["shapes"]:
            bad = [i for i, (a, b) in enumerate(zip(shapes,
                                                    manifest["shapes"]))
                   if a != b]
            raise ValueError(
                f"checkpoint leaf {bad[0]} has shape "
                f"{manifest['shapes'][bad[0]]}, target has {shapes[bad[0]]}"
                f" — architecture mismatch")
        with np.load(path / "arrays.npz") as data, torch.no_grad():
            for i, tgt in enumerate(leaves):
                src = torch.from_numpy(data[f"leaf_{i}"])
                if is_dtensor(tgt):
                    src = distribute(src.to(tgt.device, tgt.dtype),
                                     tgt.device_mesh, tgt.placements)
                tgt.copy_(src)
        return target, manifest["extras"]
