"""Complexified gauge actions for complex Langevin (port of
``stochquant_tpu.actions.gauge_complex``): ℂ* (complexified U(1), ``cu1``)
and SL(N,ℂ) (complexified SU(N), ``csu2`` / ``csu3``) Wilson theories with
a complex coupling β = beta + i·beta_im and gauge cooling.

The drift is the holomorphic derivative of the analytically continued
Wilson action S[U] = β Σ_p (1 − (1/2N)(Tr U_p + Tr U_p⁻¹)), daggers → inverses:

    H(x,μ) = (iβ/(4N))·traceless[ M − M̃ ],  M = U_μ(x)·V_μ(x),  M̃ = W_μ(x)·U_μ(x)⁻¹,

V the staple sum with inverses, W the sum of inverse staples.  Gauge cooling
(Seiler–Sexty–Stamatescu) applies G(x) = exp(−ε·V_gc(x)) along the gradient
of the unitarity norm N_u = ⟨(1/N)Tr[UU† + (UU†)⁻¹ − 2]⟩; for U(1) it is a
plain gradient step on Im θ.

Arithmetic.  Links are complex64 at the state and disk boundary (``cu1``
``(C, D, *L)``, ``csuN`` ``(C, D, *L, N, N)``); every product, quotient and
transcendental is written out on float32 parts, so no complex64 product can
be contracted into an FMA inside one PyTorch CUDA kernel and no ``matmul`` /
``einsum`` can go to a library:

* a matrix is a pair ``(re, im)`` of float32 ``(..., N, N)`` tensors;
  A·B sums k = 0, 1[, 2] of (a+bi)(c+di) = (ac − bd) + (ad + bc)i on whole
  tensors (the order of ``actions.gauge._smul``, one op per term for all
  N² entries);
* a quotient is Smith's algorithm, XLA's complex division; by a real
  number it divides each part;
* ``inv33`` takes its cofactors from cyclic shifts of the matrix, which
  are, entry for entry, the products of the JAX package's adjugate;
* sin, cos, exp and log of complex numbers go on parts
  (sin(a+bi) = sin a·cosh b + i·cos a·sinh b, log z = log|z| + i·atan2);
* ``expm_taylor``'s ``/ order`` and ``/ k`` divide each part (IEEE).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.actions.gauge import (
    GaugeAction,
    _bcast,
    _cadd,
    _chain_mean,
    _cmul,
    _csub,
    _noise_h,
    register_gauge,
    shift,
)

__all__ = [
    "ComplexU1Wilson",
    "ComplexSUNWilson",
    "ComplexSU2Wilson",
    "ComplexSU3Wilson",
    "expm_taylor",
    "inv22",
    "inv33",
    "mmul",
]


# ---------------------------------------------------------------------------
# split-complex matrices: a pair (re, im) of float32 (..., N, N) tensors
# ---------------------------------------------------------------------------


def _split(x: torch.Tensor):
    r = torch.view_as_real(x)
    return r[..., 0], r[..., 1]


def _join(p) -> torch.Tensor:
    return torch.complex(p[0].contiguous(), p[1].contiguous())


def _c64(z: complex):
    """The float32 parts of ``jnp.complex64(z)`` as Python floats."""
    return float(np.float32(z.real)), float(np.float32(z.imag))


def _pmul(A, B):
    """A·B on the trailing axes, k summed 0 → N−1."""
    acc = None
    for k in range(A[0].shape[-1]):
        t = _cmul((A[0][..., :, k:k + 1], A[1][..., :, k:k + 1]),
                  (B[0][..., k:k + 1, :], B[1][..., k:k + 1, :]))
        acc = t if acc is None else _cadd(acc, t)
    return acc


def _pdag(A):
    return A[0].transpose(-1, -2), -A[1].transpose(-1, -2)


def _ptrace(A):
    """Tr A, diagonal summed 0 → N−1, as a pair of (...) tensors."""
    t = (A[0][..., 0, 0], A[1][..., 0, 0])
    for i in range(1, A[0].shape[-1]):
        t = _cadd(t, (A[0][..., i, i], A[1][..., i, i]))
    return t


def _ptraceless(A, n: int):
    """A − (Tr A/N)·1."""
    tr = _ptrace(A)
    eye = torch.eye(n, dtype=A[0].dtype, device=A[0].device)
    return (A[0] - true_divide(tr[0], float(n))[..., None, None] * eye,
            A[1] - true_divide(tr[1], float(n))[..., None, None] * eye)


def _eye_plus(A):
    """1 + A (the imaginary parts unchanged)."""
    return A[0] + torch.eye(A[0].shape[-1], dtype=A[0].dtype, device=A[0].device), A[1]


def _cdiv(a, b):
    """a / b by Smith's algorithm (the branch on |Re b| < |Im b|), as XLA
    divides complex numbers."""
    (ar, ai), (br, bi) = a, b
    small = torch.abs(br) < torch.abs(bi)
    r1 = br / bi
    d1 = bi + br * r1
    r2 = bi / br
    d2 = br + bi * r2
    re = torch.where(small, (ar * r1 + ai) / d1, (ar + ai * r2) / d2)
    im = torch.where(small, (ai * r1 - ar) / d1, (ai - ar * r2) / d2)
    return re, im


def _pdet(A, cof=None):
    """det A of a 2×2 or 3×3 matrix; 3×3 by the expansion along row 0 with
    the cofactors ``cof`` (computed when omitted), as the JAX package's."""
    if A[0].shape[-1] == 2:
        e = lambda i, j: (A[0][..., i, j], A[1][..., i, j])  # noqa: E731
        return _csub(_cmul(e(0, 0), e(1, 1)), _cmul(e(0, 1), e(1, 0)))
    cof = _cofactors3(A) if cof is None else cof
    det = None
    for j in range(3):
        t = _cmul((A[0][..., 0, j], A[1][..., 0, j]), (cof[0][..., 0, j], cof[1][..., 0, j]))
        det = t if det is None else _cadd(det, t)
    return det


def _cofactors3(A):
    """Cofactor matrix of 3×3 matrices: C_ij = a_{i+1,j+1}·a_{i+2,j+2} −
    a_{i+1,j+2}·a_{i+2,j+1} (indices mod 3)."""
    def rolled(di, dj):
        return tuple(torch.roll(p, shifts=(-di, -dj), dims=(-2, -1)) for p in A)

    return _csub(_cmul(rolled(1, 1), rolled(2, 2)), _cmul(rolled(1, 2), rolled(2, 1)))


def _pinv(A):
    """Closed-form inverse of 2×2 or 3×3 matrices: adjugate / det."""
    if A[0].shape[-1] == 2:
        adj = (torch.stack([torch.stack([A[0][..., 1, 1], -A[0][..., 0, 1]], dim=-1),
                            torch.stack([-A[0][..., 1, 0], A[0][..., 0, 0]], dim=-1)], dim=-2),
               torch.stack([torch.stack([A[1][..., 1, 1], -A[1][..., 0, 1]], dim=-1),
                            torch.stack([-A[1][..., 1, 0], A[1][..., 0, 0]], dim=-1)], dim=-2))
        det = _pdet(A)
    else:
        cof = _cofactors3(A)
        adj = (cof[0].transpose(-1, -2), cof[1].transpose(-1, -2))
        det = _pdet(A, cof)
    return _cdiv(adj, (det[0][..., None, None], det[1][..., None, None]))


def _pexpm(A, order: int = 12):
    """exp(A) by Horner-evaluated Taylor series (``expm_taylor``)."""
    out = _eye_plus((true_divide(A[0], float(order)), true_divide(A[1], float(order))))
    for k in range(order - 1, 0, -1):
        m = _pmul(A, out)
        out = _eye_plus((true_divide(m[0], float(k)), true_divide(m[1], float(k))))
    return out


def _pshift(A, d: int, sign: int):
    """A(x + sign·d̂) of a per-direction (C, *L, N, N) field."""
    return tuple(torch.roll(p, -sign, dims=1 + d) for p in A)


def _sum_lattice(x, C):
    return torch.sum(x.reshape(C, -1), dim=1)


def expm_taylor(a: torch.Tensor, order: int = 12) -> torch.Tensor:
    """exp(A) for small batched complex square matrices (trailing axes): the
    order-12 Taylor series by Horner, exact to float32 for ‖A‖ ≲ 0.5."""
    return _join(_pexpm(_split(a), order))


def inv22(u: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched complex 2×2 matrices."""
    return _join(_pinv(_split(u)))


def inv33(u: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched complex 3×3 matrices via the adjugate."""
    return _join(_pinv(_split(u)))


def mmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched complex matrix product on the trailing axes (any N)."""
    return _join(_pmul(_split(a), _split(b)))


# ---------------------------------------------------------------------------
# complex functions of complex arguments, on parts
# ---------------------------------------------------------------------------


def csin(a, b):
    """sin(a + ib) = sin a·cosh b + i·cos a·sinh b."""
    return torch.sin(a) * torch.cosh(b), torch.cos(a) * torch.sinh(b)


def ccos(a, b):
    """cos(a + ib) = cos a·cosh b − i·sin a·sinh b."""
    return torch.cos(a) * torch.cosh(b), -(torch.sin(a) * torch.sinh(b))


def cexp(a, b):
    """exp(a + ib) = e^a·(cos b + i·sin b)."""
    e = torch.exp(a)
    return e * torch.cos(b), e * torch.sin(b)


def clog(a, b):
    """Principal log(a + ib) = log|z| + i·atan2(b, a)."""
    return torch.log(torch.hypot(a, b)), torch.atan2(b, a)


@register_gauge("cu1")
@dataclasses.dataclass(frozen=True)
class ComplexU1Wilson(GaugeAction):
    """Complexified compact U(1): links e^{iθ}, θ ∈ ℂ, state complex64
    (C, D, *L); coupling β = beta + i·beta_im.  The drift is the analytic
    continuation of U(1)'s; the mean plaquette ⟨cos P⟩ is complex."""

    beta_im: float = 0.0
    obs_dtype = "complex64"

    @property
    def beta_c(self):
        return _c64(complex(self.beta, self.beta_im))

    def plaquette_angle(self, theta, mu: int, nu: int, ndim: int):
        """P_{μν}(x), complex (additions are exact part by part)."""
        t_mu, t_nu = theta[:, mu], theta[:, nu]
        return t_mu + shift(t_nu, mu, +1, 1) - shift(t_mu, nu, +1, 1) - t_nu

    def _cos_plaquette(self, theta, mu, nu, ndim):
        return ccos(*_split(self.plaquette_angle(theta, mu, nu, ndim)))

    def action(self, theta, ndim: int):
        C = theta.shape[0]
        s = (torch.zeros((C,), dtype=torch.float32, device=theta.device),) * 2
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                cr, ci = self._cos_plaquette(theta, mu, nu, ndim)
                s = _cadd(s, (_sum_lattice(1.0 - cr, C), _sum_lattice(-ci, C)))
        return _join(_cmul(self.beta_c, s))

    def drift(self, theta, ndim: int):
        """−∂S/∂θ_μ(x) = −β Σ_{ν≠μ}[ sin P_{μν}(x) − sin P_{μν}(x−ν̂) ], holomorphic."""
        nb = tuple(-v for v in self.beta_c)
        out = []
        for mu in range(ndim):
            acc = (torch.zeros_like(theta[:, mu].real),) * 2
            for nu in range(ndim):
                if nu == mu:
                    continue
                sp = csin(*_split(self.plaquette_angle(theta, mu, nu, ndim)))
                acc = _csub(_cadd(acc, sp), tuple(shift(p, nu, -1, 1) for p in sp))
            out.append(_join(_cmul(nb, acc)))
        return torch.stack(out, dim=1)

    def mean_plaquette(self, theta, ndim: int):
        C = theta.shape[0]
        tot = (torch.zeros((C,), dtype=torch.float32, device=theta.device),) * 2
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                cr, ci = self._cos_plaquette(theta, mu, nu, ndim)
                tot = _cadd(tot, (_chain_mean(cr), _chain_mean(ci)))
                n += 1
        return _join((true_divide(tot[0], float(n)), true_divide(tot[1], float(n))))

    def init_links(self, shape, device=None):
        return torch.zeros(shape, dtype=torch.complex64, device=device)

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice)

    def noise_to_tangent(self, eta):
        return torch.complex(eta, torch.zeros_like(eta))

    def omega(self, f, eta, dtau_eff):
        """Δτ_eff·F + √(2Δτ_eff)·η with real noise on the real part."""
        fr, fi = _split(f)
        d = _bcast(dtau_eff, f.dim())
        return torch.complex(d * fr + torch.sqrt(2.0 * d) * eta, d * fi)

    def drift_magnitude(self, f):
        return torch.hypot(*_split(f))

    def apply_update(self, theta, omega):
        """θ ← θ + ω, the real part wrapped to (−π, π] rounding half to even
        (the imaginary part is the non-compact direction: left to cooling
        and the runaway detector)."""
        tr, ti = _split(theta + omega)
        two_pi = float(np.float32(2.0 * np.pi))
        return torch.complex(tr - two_pi * torch.round(true_divide(tr, two_pi)), ti.contiguous())

    def hot_start(self, theta, eta):
        return self.noise_to_tangent(float(np.float32(np.pi)) * torch.tanh(eta))

    def lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))  # (C, D, *L)

    def noise_lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))

    def plaquette_site(self, theta, mu, nu, ndim):
        return _join(self._cos_plaquette(theta, mu, nu, ndim))

    # -- complex-Langevin safety surface ------------------------------------

    def unitarity_norm(self, theta, ndim: int):
        """Mean Im(θ)² per chain: 0 iff the configuration is unitary."""
        im = theta.imag
        return _chain_mean(im * im)

    def cool(self, theta, ndim: int, rate: float, steps: int):
        """Gauge-cooling gradient steps on Im θ: b(x) = −ε·Σ_μ[Imθ_μ(x) −
        Imθ_μ(x−μ̂)], Im θ_μ(x) += b(x) − b(x+μ̂); Re θ untouched.  ε is
        clamped to 1/(4·ndim), the monotone-descent bound."""
        eff = min(float(rate), 1.0 / (4.0 * ndim))
        for _ in range(steps):
            tr, im = _split(theta)
            div = torch.zeros_like(im[:, 0])
            for mu in range(ndim):
                div = div + im[:, mu] - shift(im[:, mu], mu, -1, 1)
            b = -eff * div  # (C, *L)
            delta = torch.stack([b - shift(b, mu, +1, 1) for mu in range(ndim)], dim=1)
            theta = torch.complex(tr.contiguous(), im + delta)
        return theta


def _tangent_pauli(e):
    """Σ_a η_a σ_a/2 for the three real noise tensors e[0..2]."""
    z = torch.zeros_like(e[0])
    return [
        [(0.5 * e[2], z), (0.5 * e[0], -0.5 * e[1])],
        [(0.5 * e[0], 0.5 * e[1]), (-0.5 * e[2], z)],
    ]


def _stack_matrix(M):
    """Nested N×N lists of (re, im) tensors → a pair of (..., N, N) tensors."""
    return tuple(torch.stack([torch.stack([M[i][j][p] for j in range(len(M))], dim=-1)
                              for i in range(len(M))], dim=-2) for p in (0, 1))


@dataclasses.dataclass(frozen=True)
class ComplexSUNWilson(GaugeAction):
    """SL(N,ℂ) Wilson theory (complexified SU(N)): matrix links, state
    (C, D, *L, N, N) complex64, β = beta + i·beta_im, action
    S = β Σ_p (1 − (1/2N)(Tr U_p + Tr U_p⁻¹)), which agrees with the
    Wilson action on SU(N)."""

    beta_im: float = 0.0
    N: int = 3
    obs_dtype = "complex64"

    @property
    def beta_c(self):
        return _c64(complex(self.beta, self.beta_im))

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice) + (self.N, self.N)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, self.N * self.N - 1, ndim) + tuple(lattice)

    def _tangent(self, eta):
        """(C, N²−1, D, *L) real → pair (C, D, *L, N, N) of Σ_a η_a T_a."""
        e = [eta[:, a] for a in range(self.N * self.N - 1)]
        return _stack_matrix(_tangent_pauli(e) if self.N == 2 else _noise_h(e))

    def noise_to_tangent(self, eta):
        return _join(self._tangent(eta))

    def omega(self, f, eta, dtau_eff):
        F, nt = _split(f), self._tangent(eta)
        d = _bcast(dtau_eff, f.dim())
        na = torch.sqrt(2.0 * d)
        return _join((d * F[0] + na * nt[0], d * F[1] + na * nt[1]))

    def init_links(self, shape, device=None):
        eye = torch.eye(self.N, dtype=torch.complex64, device=device)
        return eye.expand(shape).contiguous()

    def _plaquette(self, links, mu: int, nu: int):
        """U_{μν}(x) with inverses in place of daggers, a pair (C, *L, N, N)."""
        u_mu, u_nu = _split(links[:, mu]), _split(links[:, nu])
        return _pmul(_pmul(u_mu, _pshift(u_nu, mu, +1)),
                     _pmul(_pinv(_pshift(u_mu, nu, +1)), _pinv(u_nu)))

    def plaquette(self, links, mu: int, nu: int):
        return _join(self._plaquette(links, mu, nu))

    def _tr_sym(self, p):
        """(1/2N)(Tr U_p + Tr U_p⁻¹), the holomorphic plaquette observable."""
        t = _cadd(_ptrace(p), _ptrace(_pinv(p)))
        return true_divide(t[0], 2.0 * self.N), true_divide(t[1], 2.0 * self.N)

    def action(self, links, ndim: int):
        C = links.shape[0]
        s = (torch.zeros((C,), dtype=torch.float32, device=links.device),) * 2
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                wr, wi = self._tr_sym(self._plaquette(links, mu, nu))
                s = _cadd(s, (_sum_lattice(1.0 - wr, C), _sum_lattice(-wi, C)))
        return _join(_cmul(self.beta_c, s))

    def mean_plaquette(self, links, ndim: int):
        C = links.shape[0]
        tot = (torch.zeros((C,), dtype=torch.float32, device=links.device),) * 2
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                wr, wi = self._tr_sym(self._plaquette(links, mu, nu))
                tot = _cadd(tot, (_chain_mean(wr), _chain_mean(wi)))
                n += 1
        return _join((true_divide(tot[0], float(n)), true_divide(tot[1], float(n))))

    def _staples(self, links, mu: int, ndim: int):
        """(V, W): V the staple sum with inverses (Σ Tr U_p = Tr[U_μ V]), W the
        inverse-staple sum (Σ Tr U_p⁻¹ = Tr[W U_μ⁻¹])."""
        sh, inv = _pshift, _pinv
        u_mu = _split(links[:, mu])
        v = w = None
        for nu in range(ndim):
            if nu == mu:
                continue
            u_nu = _split(links[:, nu])
            # forward: U_ν(x+μ̂) U_μ⁻¹(x+ν̂) U_ν⁻¹(x)
            fv = _pmul(_pmul(sh(u_nu, mu, +1), inv(sh(u_mu, nu, +1))), inv(u_nu))
            # backward: U_ν⁻¹(x+μ̂−ν̂) U_μ⁻¹(x−ν̂) U_ν(x−ν̂)
            bv = _pmul(_pmul(inv(sh(sh(u_nu, mu, +1), nu, -1)), inv(sh(u_mu, nu, -1))),
                       sh(u_nu, nu, -1))
            term_v = _cadd(fv, bv)
            term_w = _cadd(inv(fv), inv(bv))
            v = term_v if v is None else _cadd(v, term_v)
            w = term_w if w is None else _cadd(w, term_w)
        return v, w

    def drift(self, links, ndim: int):
        """H = (iβ/(4N))·traceless[U V − W U⁻¹], (C, D, *L, N, N)."""
        br, bi = self.beta_c
        four_n = np.float32(4.0 * self.N)
        coef = (float(np.float32(-bi) / four_n), float(np.float32(br) / four_n))
        per_mu = []
        for mu in range(ndim):
            u = _split(links[:, mu])
            v, w = self._staples(links, mu, ndim)
            g = _csub(_pmul(u, v), _pmul(w, _pinv(u)))
            per_mu.append(_join(_cmul(coef, _ptraceless(g, self.N))))
        return torch.stack(per_mu, dim=1)

    def drift_magnitude(self, f):
        """√(2·Σ_ij |H_ij|²) per link."""
        a = torch.hypot(*_split(f))
        return torch.sqrt(2.0 * torch.sum(a * a, dim=(-2, -1)))

    def apply_update(self, links, omega):
        """U ← exp(iΩ)U by the Taylor exponential, then U ← U/det(U)^{1/N}
        (the principal log: det stays near 1)."""
        o = _split(omega)
        u = _pmul(_pexpm((-o[1], o[0])), _split(links))
        lr, li = clog(*_pdet(u))
        rr, ri = cexp(true_divide(lr, float(self.N)), true_divide(li, float(self.N)))
        return _join(_cdiv(u, (rr[..., None, None], ri[..., None, None])))

    def lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))  # (C, D, *L, N, N)

    def noise_lattice_axes(self, ndim):
        return tuple(range(3, 3 + ndim))  # (C, N²−1, D, *L)

    def plaquette_site(self, links, mu, nu, ndim):
        return _join(self._tr_sym(self._plaquette(links, mu, nu)))

    # -- complex-Langevin safety surface ------------------------------------

    def unitarity_norm(self, links, ndim: int):
        """N_u = ⟨(1/N)Tr[UU† + (UU†)⁻¹ − 2]⟩ ≥ 0, = 0 iff unitary."""
        u = _split(links)
        uu = _pmul(u, _pdag(u))
        tr = _ptrace(uu)[0]
        tri = _ptrace(_pinv(uu))[0]
        return _chain_mean(true_divide(tr + tri - 2.0 * self.N, float(self.N)))

    def _cooling_force(self, links, ndim: int):
        """Hermitian traceless V_gc(x) = Σ_μ [UU†−(UU†)⁻¹]_μ(x) −
        [U†U−(U†U)⁻¹]_μ(x−μ̂), the gradient of N_u along the gauge orbit."""
        acc = None
        for mu in range(ndim):
            u = _split(links[:, mu])
            uu = _pmul(u, _pdag(u))
            a = _csub(uu, _pinv(uu))
            uu_b = _pmul(_pdag(u), u)
            b = _csub(uu_b, _pinv(uu_b))
            term = _csub(a, tuple(torch.roll(p, 1, dims=1 + mu) for p in b))  # b at x−μ̂
            acc = term if acc is None else _cadd(acc, term)
        return _ptraceless(acc, self.N)

    def cool(self, links, ndim: int, rate: float, steps: int):
        """SSS gauge cooling U_μ(x) ← G(x) U_μ(x) G(x+μ̂)⁻¹, G = exp(−ε V_gc),
        with the adaptive step ε = rate / max(1, ‖V_gc‖_F) per site; exactly
        gauge, so every holomorphic observable is invariant."""
        for _ in range(steps):
            vr, vi = self._cooling_force(links, ndim)
            a = torch.hypot(vr, vi)
            vnorm = torch.sqrt(torch.sum(a * a, dim=(-2, -1), keepdim=True))
            eps = true_divide(float(rate), torch.clamp(vnorm, min=1.0))
            g = _pexpm((-eps * vr, -eps * vi))
            gi = _pexpm((eps * vr, eps * vi))
            new = []
            for mu in range(ndim):
                gi_up = tuple(torch.roll(p, -1, dims=mu + 1) for p in gi)  # G⁻¹(x+μ̂)
                new.append(_join(_pmul(_pmul(g, _split(links[:, mu])), gi_up)))
            links = torch.stack(new, dim=1)
        return links


@register_gauge("csu2")
@dataclasses.dataclass(frozen=True)
class ComplexSU2Wilson(ComplexSUNWilson):
    N: int = 2


@register_gauge("csu3")
@dataclasses.dataclass(frozen=True)
class ComplexSU3Wilson(ComplexSUNWilson):
    N: int = 3
