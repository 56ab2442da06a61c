"""Hand-written CUDA kernels for the solver hot path (sources in csrc/)."""
