"""The optimizer substrate of the port (the port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamW, OptState, global_norm  # noqa: F401
from repro_torch.optim.compression import GradCompression  # noqa: F401
from repro_torch.optim.schedule import (cosine_schedule,  # noqa: F401
                                        linear_warmup)
