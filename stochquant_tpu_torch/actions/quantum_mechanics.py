"""Registered 1-D quantum-mechanical actions (port of
``stochquant_tpu.actions.quantum_mechanics``).

Parameter defaults and every expression keep the JAX package's operand
order: Python-float constants fold first and round once to float32 where
they meet a tensor, so both packages evaluate the same float32 program.
Divisions go through ``true_divide`` (IEEE division on every device).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from stochquant_tpu_torch.actions.base import QMAction, register, true_divide


@register("harmonic")
@dataclasses.dataclass(frozen=True)
class HarmonicOscillator(QMAction):
    """V(x) = ½·k·x² (k=2: angular frequency ω₀ = √(k/m) = √2)."""

    k: float = 2.0

    def V(self, x):
        return 0.5 * self.k * x * x

    def dV(self, x):
        return self.k * x

    def ddV(self, x):
        return torch.full_like(x, self.k)

    @property
    def omega0(self) -> float:
        return math.sqrt(self.k / self.mass)


@register("double_well")
@dataclasses.dataclass(frozen=True)
class DoubleWell(QMAction):
    """V(x) = V₀·((x/η)² − 1)², with the kink background
    x_cl(t, ω) = η·tanh(√(2V₀/m)·(t−ω)/η) and zero-mode normalization
    √3·2^(−5/4)·V₀^(−1/4)/√η."""

    v0: float = 2.0
    eta: float = 0.8
    has_zero_mode = True

    def V(self, x):
        u = true_divide(x, self.eta) ** 2 - 1.0
        return self.v0 * u * u

    def dV(self, x):
        e2 = self.eta * self.eta
        return true_divide(4.0 * self.v0 * x * (x * x - e2), e2 * e2)

    def ddV(self, x):
        e2 = self.eta * self.eta
        return true_divide(true_divide(12.0 * self.v0 * x * x, e2) - 4.0 * self.v0, e2)

    def x_cl(self, t, omega):
        w = math.sqrt(2.0 * self.v0 / self.mass) / self.eta
        return self.eta * torch.tanh(w * (t - omega))

    def boundary_asymptote(self, side: int):
        return side * self.eta

    def zero_mode_const(self) -> float:
        return (
            math.sqrt(3.0)
            * 2.0 ** (-5.0 / 4.0)
            * self.v0 ** (-1.0 / 4.0)
            / math.sqrt(self.eta)
        )


@register("anharmonic")
@dataclasses.dataclass(frozen=True)
class AnharmonicOscillator(QMAction):
    """V(x) = ½·μ²·x² + λ·x⁴ (the λφ⁴ quartic oscillator)."""

    mu2: float = 1.0
    lam: float = 1.0

    def V(self, x):
        x2 = x * x
        return 0.5 * self.mu2 * x2 + self.lam * x2 * x2

    def dV(self, x):
        return self.mu2 * x + 4.0 * self.lam * x * x * x

    def ddV(self, x):
        return self.mu2 + 12.0 * self.lam * x * x


@register("poeschl_teller")
@dataclasses.dataclass(frozen=True)
class PoeschlTeller(QMAction):
    """V(x) = −V₀ / cosh²(x/a).  Derivatives via autodiff."""

    v0: float = 1.0
    a: float = 1.0

    def V(self, x):
        c = torch.cosh(true_divide(x, self.a))
        return true_divide(-self.v0, c * c)
