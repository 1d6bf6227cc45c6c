"""Action abstraction (port of ``stochquant_tpu.actions.base``).

Every model is one class: potential ``V``, its derivatives (hand-derived
where hot, ``torch.func.grad``-derived by default), the classical
background ``x_cl(t, ω)`` of the fluctuation formulation and the zero-mode
normalization of the collective coordinate.  Methods take and return
tensors and keep the input's dtype and device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch.func import grad, vmap

_REGISTRY: Dict[str, Callable[..., "QMAction"]] = {}


def register(name: str):
    def wrap(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return wrap


def get(name: str, **params) -> "QMAction":
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown action {name!r}; known: {sorted(_REGISTRY)}")
    return cls(**params)


def names():
    return sorted(_REGISTRY)


def true_divide(a, b):
    """``a / b`` with IEEE division on every device.

    A Python-float operand becomes a 0-d tensor of the other operand's dtype
    and device (rounded to float32 as the JAX package rounds its weak-typed
    scalars): PyTorch's CUDA division by, or of, a Python scalar multiplies
    by a reciprocal instead, one rounding more than the JAX package and the
    CUDA kernels."""
    ref = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=ref.dtype, device=ref.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=ref.dtype, device=ref.device)
    return a / b


def _elementwise_grad(f):
    """Derivative of a scalar→scalar function, applied elementwise."""
    g = vmap(grad(f))

    def apply(x):
        return g(x.reshape(-1)).reshape(x.shape)

    return apply


@dataclasses.dataclass(frozen=True)
class QMAction:
    """1-D Euclidean-time quantum mechanics:

        S[x] = Σ_i Δt [ (m/2)((x_{i+1}-x_i)/Δt)² + V(x_i) ].

    Subclasses define ``V`` and may override ``dV`` / ``ddV`` with
    hand-derived forms; the defaults differentiate ``V`` with
    ``torch.func.grad`` (checked against the overrides in
    tests/test_torch_actions.py).
    """

    mass: float = 1.0

    def V(self, x):
        raise NotImplementedError

    def dV(self, x):
        return _elementwise_grad(self.V)(x)

    def ddV(self, x):
        return _elementwise_grad(lambda y: self.dV(y))(x)

    has_zero_mode: bool = dataclasses.field(default=False, init=False)

    def x_cl(self, t, omega):
        """Classical background at Euclidean time t, collective coord ω
        (trivial by default: zeros of the broadcast shape)."""
        t, omega = torch.as_tensor(t), torch.as_tensor(omega)
        shape = torch.broadcast_shapes(t.shape, omega.shape)
        return torch.zeros(shape, dtype=omega.dtype, device=omega.device)

    def boundary_asymptote(self, side: int):
        """Background value pinned at the lattice edges for FIXED_BG BCs
        (side = -1 left, +1 right)."""
        return 0.0

    def zero_mode_const(self) -> float:
        """Normalization of the translational zero mode (the collective
        coordinate's noise amplitude)."""
        return 0.0
