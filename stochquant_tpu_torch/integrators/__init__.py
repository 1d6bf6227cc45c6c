"""Langevin integrators: the plain PyTorch chain path and its accumulators."""
