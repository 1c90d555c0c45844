"""Entry points of the port: the serving loop (``launch.serve``), the
training driver (``launch.train``) and its elastic supervisor
(``launch.elastic``), and the plan devices the planning backend shards
its scans over (``launch.mesh``)."""
from repro_torch.launch.mesh import (PLAN_DEVICES_ENV,  # noqa: F401
                                     plan_device_count, plan_devices)
