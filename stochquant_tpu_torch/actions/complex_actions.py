"""Complex actions for complex Langevin (port of
``stochquant_tpu.actions.complex_actions``).

For a holomorphic action S(z) the complex-Langevin update evolves z = x + iy
with drift −∂S/∂z and *real* noise on the real part; expectation values of
holomorphic observables converge to the complex-weight averages ∫O·e^{−S}.

Every method takes and returns float32 real and imaginary parts, ``(zr, zi)``
→ ``(re, im)``: complex64 lives only at the state and disk boundary.  A
product is written out as (a+bi)(c+di) = (ac − bd) + (ad + bc)i in the
operand order of the JAX expression, the split XLA's complex lowering uses;
a complex64 product inside one PyTorch CUDA kernel may be contracted into
FMAs, which would part the card from the CPU.  ``z**3`` is XLA's
``integer_pow``: z·(z·z).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

_COMPLEX_REGISTRY: Dict[str, Callable[..., "ComplexAction"]] = {}

__all__ = ["ComplexAction", "ComplexGaussian", "ComplexQuartic", "register_complex",
           "get_complex", "complex_names", "cmul"]


def register_complex(name: str):
    def wrap(cls):
        _COMPLEX_REGISTRY[name] = cls
        cls.name = name
        return cls

    return wrap


def get_complex(name: str, **params) -> "ComplexAction":
    try:
        cls = _COMPLEX_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown complex action {name!r}; known: {sorted(_COMPLEX_REGISTRY)}")
    return cls(**params)


def complex_names():
    return sorted(_COMPLEX_REGISTRY)


def cmul(a, b):
    """(ar + i·ai)(br + i·bi) on parts; either factor may be a pair of
    Python floats (a complex64 constant's parts)."""
    (ar, ai), (br, bi) = a, b
    return ar * br - ai * bi, ar * bi + ai * br


def _c64(re: float, im: float):
    """The parts of ``jnp.complex64(complex(re, im))`` as Python floats."""
    return float(np.float32(re)), float(np.float32(im))


@dataclasses.dataclass(frozen=True)
class ComplexAction:
    """Holomorphic single-site (0-D) or chain site potential."""

    def S(self, zr, zi):
        raise NotImplementedError

    def dS(self, zr, zi):
        """Holomorphic derivative ∂S/∂z (hand-derived) as (re, im)."""
        raise NotImplementedError


@register_complex("complex_gaussian")
@dataclasses.dataclass(frozen=True)
class ComplexGaussian(ComplexAction):
    """S(z) = ½·σ·z² with complex σ = σ_re + i·σ_im.

    Exact: ⟨z²⟩ = 1/σ, the known answer of the complex-Langevin integrator.
    Requires Re(σ) > 0."""

    sigma_re: float = 1.0
    sigma_im: float = 0.5

    @property
    def sigma(self):
        return complex(self.sigma_re, self.sigma_im)

    def S(self, zr, zi):
        s = _c64(self.sigma_re, self.sigma_im)
        hs = cmul((0.5, 0.0), s)
        return cmul(cmul(hs, (zr, zi)), (zr, zi))

    def dS(self, zr, zi):
        return cmul(_c64(self.sigma_re, self.sigma_im), (zr, zi))


@register_complex("complex_quartic")
@dataclasses.dataclass(frozen=True)
class ComplexQuartic(ComplexAction):
    """S(z) = ½·σ·z² + (λ/4)·z⁴ with complex σ: the standard complex-Langevin
    benchmark model (exact ⟨z²⟩ by quadrature)."""

    sigma_re: float = 1.0
    sigma_im: float = 1.0
    lam: float = 1.0

    @property
    def sigma(self):
        return complex(self.sigma_re, self.sigma_im)

    def S(self, zr, zi):
        s = _c64(self.sigma_re, self.sigma_im)
        z = (zr, zi)
        z2 = cmul(z, z)
        quad = cmul(cmul(cmul((0.5, 0.0), s), z), z)
        quart = cmul((0.25 * self.lam, 0.0), cmul(z2, z2))  # integer_pow 4: (z·z)·(z·z)
        return quad[0] + quart[0], quad[1] + quart[1]

    def dS(self, zr, zi):
        z = (zr, zi)
        sz = cmul(_c64(self.sigma_re, self.sigma_im), z)
        z3 = cmul(z, cmul(z, z))
        lz3 = cmul((float(np.float32(self.lam)), 0.0), z3)
        return sz[0] + lz3[0], sz[1] + lz3[1]
