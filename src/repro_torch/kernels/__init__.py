"""Hand-written Hopper kernels of the port (Triton, built at first use)."""
