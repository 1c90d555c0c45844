"""Streaming planner service: live arrival traffic over one session
broker (see repro_torch/core/selinger.py's ADMISSION docstring section)."""
from repro_torch.service.admission import (QueryTicket,
                                           StreamingPlannerService)
from repro_torch.service.traces import (Arrival, bursty_trace, diurnal_trace,
                                        poisson_trace)

__all__ = ["Arrival", "QueryTicket", "StreamingPlannerService",
           "bursty_trace", "diurnal_trace", "poisson_trace"]
