"""Hand-written Hopper kernels of the port (``csrc/``), their plain torch
versions, and the builder that compiles them on first use."""
