"""Hand-written CUDA kernels (built at first launch, never at import)."""
