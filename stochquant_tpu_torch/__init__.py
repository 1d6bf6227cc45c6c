"""stochquant_tpu_torch — the PyTorch + CUDA port of ``stochquant_tpu``.

Parisi–Wu stochastic quantization with batched 1-D Langevin chains, D-dim
scalar-field lattices, lattice gauge links and complex Langevin on an NVIDIA
Hopper GPU: plain PyTorch around hand-written CUDA kernels (``kernels/csrc/``),
with the JAX package as the reference it is tested against.  Importing the package imports neither JAX nor Triton and
builds nothing; the kernels are compiled at their first launch.
"""

from stochquant_tpu_torch import rng  # noqa: F401
from stochquant_tpu_torch.config import (  # noqa: F401
    PRESETS,
    BoundaryCondition,
    ChainConfig,
    FieldConfig,
    Formulation,
    Scheme,
    Sweep,
)

__version__ = "0.1.0"
