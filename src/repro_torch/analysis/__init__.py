"""plan-lint for the port: static and dynamic analysis that certifies the
planning path's host-sync, cost-surface and grid-memo contracts
(``python -m repro_torch.analysis``).

Only the dependency-free registration surface and ``Finding`` are
exported eagerly — importing ``repro_torch.analysis`` must stay free for
the core modules that decorate hot paths and register cost surfaces at
import time.  The passes (``surface_lint``, ``recompile_audit``,
``hotpath_lint``) import torch and ``repro_torch.core`` and load on
demand, by the CLI or by explicit submodule import.
"""
from repro_torch.analysis.registry import (CostSurface, hot_path,
                                           iter_cost_surfaces,
                                           register_cost_surface,
                                           surface_names)
from repro_torch.analysis.report import Finding

__all__ = ["CostSurface", "Finding", "hot_path", "iter_cost_surfaces",
           "register_cost_surface", "surface_names"]
