"""D-dimensional scalar field actions on a periodic lattice (port of
``stochquant_tpu.actions.phi4``).

Every expression keeps the JAX package's operand order: Python-float
constants fold first (``lam / 6.0``, ``0.5 * m2``) and round once to float32
where they meet a tensor, so both packages evaluate the same float32
program.  Leading tensor axes are the chain batch; the trailing ``ndim``
axes are the lattice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from stochquant_tpu_torch.actions.base import _elementwise_grad

_FIELD_REGISTRY: Dict[str, Callable[..., "FieldAction"]] = {}


def register_field(name: str):
    def wrap(cls):
        _FIELD_REGISTRY[name] = cls
        cls.name = name
        return cls

    return wrap


def get_field(name: str, **params) -> "FieldAction":
    try:
        cls = _FIELD_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown field action {name!r}; known: {sorted(_FIELD_REGISTRY)}")
    return cls(**params)


def field_names():
    return sorted(_FIELD_REGISTRY)


def _lattice_dims(phi: torch.Tensor, ndim: int):
    return range(phi.dim() - ndim, phi.dim())


def periodic_laplacian(phi, spacing: float, ndim: int):
    """Nearest-neighbour lattice Laplacian over the trailing ``ndim`` axes,
    periodic: Σ_d (φ(x−d̂) + φ(x+d̂) − 2φ(x)), summed from zero in axis
    order, times 1/a²."""
    inv_a2 = 1.0 / (spacing * spacing)
    lap = torch.zeros_like(phi)
    for d in _lattice_dims(phi, ndim):
        lap = lap + (torch.roll(phi, 1, dims=d) + torch.roll(phi, -1, dims=d) - 2.0 * phi)
    return lap * inv_a2


@dataclasses.dataclass(frozen=True)
class FieldAction:
    """S[φ] = Σ_x a^D [ ½ Σ_μ ((φ(x+μ̂)−φ(x))/a)² + V(φ(x)) ], periodic.

    ``drift`` returns the drift density ∇²φ − V'(φ); the Langevin update is
    φ += Δτ·drift + √(2Δτ/a^D)·η.  The default ``dV`` differentiates ``V``
    with ``torch.func.grad``.
    """

    def V(self, phi):
        raise NotImplementedError

    def dV(self, phi):
        return _elementwise_grad(self.V)(phi)

    def action_density(self, phi, spacing: float, ndim: int):
        """Per-site action density: forward-difference kinetic term + V."""
        kin = torch.zeros_like(phi)
        inv_a2 = 1.0 / (spacing * spacing)
        for d in _lattice_dims(phi, ndim):
            diff = torch.roll(phi, -1, dims=d) - phi
            kin = kin + 0.5 * diff * diff * inv_a2
        return kin + self.V(phi)

    def action(self, phi, spacing: float, ndim: int):
        dens = self.action_density(phi, spacing, ndim)
        return spacing**ndim * torch.sum(dens, dim=tuple(_lattice_dims(phi, ndim)))

    def drift(self, phi, spacing: float, ndim: int):
        return periodic_laplacian(phi, spacing, ndim) - self.dV(phi)

    def dV_int(self, phi):
        """Non-Gaussian part of V′: dV(φ) − m²·φ (needs an ``m2`` attribute)."""
        return self.dV(phi) - self.m2 * phi


@register_field("phi4")
@dataclasses.dataclass(frozen=True)
class ScalarPhi4(FieldAction):
    """V(φ) = ½·m²·φ² + (λ/4!)·φ⁴."""

    m2: float = 1.0
    lam: float = 1.0

    def V(self, phi):
        p2 = phi * phi
        return 0.5 * self.m2 * p2 + (self.lam / 24.0) * p2 * p2

    def dV(self, phi):
        return self.m2 * phi + (self.lam / 6.0) * phi * phi * phi

    def dV_int(self, phi):
        return (self.lam / 6.0) * phi * phi * phi


@register_field("free_field")
@dataclasses.dataclass(frozen=True)
class FreeField(FieldAction):
    """Gaussian fixed point V = ½·m²·φ²."""

    m2: float = 1.0

    def V(self, phi):
        return 0.5 * self.m2 * phi * phi

    def dV(self, phi):
        return self.m2 * phi

    def dV_int(self, phi):
        return torch.zeros_like(phi)
