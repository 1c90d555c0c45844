"""Static-analysis hooks of the port (only the ``hot_path`` marker so far)."""
from repro_torch.analysis.registry import hot_path

__all__ = ["hot_path"]
