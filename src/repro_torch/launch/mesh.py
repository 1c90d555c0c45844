"""Plan devices: the GPUs the planning backend shards its grid scans over.

The port's counterpart of the plan part of ``repro.launch.mesh``
(``plan_device_count`` and ``REPRO_PLAN_DEVICES``), without the
reference's production meshes.  ``REPRO_PLAN_DEVICES`` caps how many
visible GPUs planning uses; ``1`` turns sharding off.  One process drives
every plan device, so there is no mesh object: ``plan_devices()`` is the
ordered device list whose order is the flat-row order of the shards.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

PLAN_DEVICES_ENV = "REPRO_PLAN_DEVICES"


def plan_device_count() -> int:
    """Visible GPUs the planning backend shards its scans over, capped by
    ``REPRO_PLAN_DEVICES`` (a malformed value is ignored); never below 1,
    and 1 on a host without a GPU.  1 means the sharded code paths are
    bypassed, so ``REPRO_PLAN_DEVICES=1`` is the rollback switch."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    cap = os.environ.get(PLAN_DEVICES_ENV, "").strip()
    if cap:
        try:
            n = min(n, int(cap))
        except ValueError:
            pass
    return max(1, n)


def plan_devices(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first ``n_devices`` GPUs (``plan_device_count()`` of them by
    default), in shard order."""
    n = plan_device_count() if n_devices is None else max(1, int(n_devices))
    return [torch.device("cuda", i) for i in range(n)]
