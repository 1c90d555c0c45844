"""PyTorch + CUDA port of the RAQO reproduction (``repro``).

Module for module it mirrors ``repro``; it imports torch, numpy and the
standard library, never jax or ``repro``.  The planning entry points run
on the GPU unless the caller asks for the CPU (``backend="torch"``).
"""
