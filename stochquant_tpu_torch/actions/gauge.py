"""Compact lattice gauge actions (port of ``stochquant_tpu.actions.gauge``):
link variables and Wilson plaquette actions for U(1), SU(2) and SU(3) with
their hand-derived Langevin drifts.

Layouts are the JAX package's:

* U(1): angles θ_μ(x), float32 ``(C, D, *L)``;
* SU(2): quaternions q = (w, x, y, z) for U = w + i(x σ₁ + y σ₂ + z σ₃),
  float32 ``(C, 4, D, *L)``;
* SU(3): complex64 3×3 matrices on the two trailing axes,
  ``(C, D, *L, 3, 3)``.

Wilson action (each unordered plaquette once):

    S[U] = β Σ_x Σ_{μ<ν} ( 1 − (1/N) Re Tr U_{μν}(x) ).

Every expression keeps the JAX package's operand order.  SU(3) arithmetic
is written out on float32 real and imaginary parts (complex64 lives only in
the state layout): a complex64 product inside one PyTorch CUDA kernel may be
contracted into FMAs, and ``matmul``/``einsum`` may go to a library in
another summation order, either of which would part the plain version from
the CUDA kernel.  Products sum k = 0, 1, 2 with (a+bi)(c+di) =
(ac − bd) + (ad + bc)i, the split XLA's complex lowering uses; exponentials
and phases are ``cos``/``sin``/``atan2`` of real arguments; every division
by a Python float goes through :func:`~stochquant_tpu_torch.actions.base.true_divide`.
Two expressions differ from the JAX package by float32 rounding only:
(c₁/3)^1.5 is ``c₁/3 · √(c₁/3)`` (exactly rounded operations in place of
``pow``) and a complex number over a real one divides each part.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from stochquant_tpu_torch.actions.base import true_divide

_GAUGE_REGISTRY: Dict[str, Callable[..., "GaugeAction"]] = {}


def register_gauge(name: str):
    def wrap(cls):
        _GAUGE_REGISTRY[name] = cls
        cls.name = name
        return cls

    return wrap


def get_gauge(name: str, **params) -> "GaugeAction":
    try:
        cls = _GAUGE_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown gauge action {name!r}; known: {sorted(_GAUGE_REGISTRY)}")
    return cls(**params)


def gauge_names():
    return sorted(_GAUGE_REGISTRY)


def shift(arr, d: int, sign: int, lat_start: int):
    """arr(x + sign·d̂): roll by −sign along lattice axis d (axes start at
    ``lat_start``)."""
    return torch.roll(arr, -sign, dims=lat_start + d)


def _chain_max(x: torch.Tensor) -> torch.Tensor:
    """Per-chain max over every axis but the first (NaN propagates)."""
    return torch.amax(x.reshape(x.shape[0], -1), dim=1)


def _chain_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x.reshape(x.shape[0], -1), dim=1)


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (C,) per-chain value shaped to broadcast against ``ndim`` axes."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


# ---------------------------------------------------------------------------
# quaternion algebra for SU(2):  U = w + i(x σ₁ + y σ₂ + z σ₃)
# ---------------------------------------------------------------------------


def qmul(a, b):
    """Quaternion product; a, b are (w, x, y, z) tuples of tensors."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + bw * ax - (ay * bz - az * by),
        aw * by + bw * ay - (az * bx - ax * bz),
        aw * bz + bw * az - (ax * by - ay * bx),
    )


def qconj(a):
    """U† (the inverse of a unit quaternion)."""
    aw, ax, ay, az = a
    return (aw, -ax, -ay, -az)


def qnormalize(a, eps=1e-30):
    aw, ax, ay, az = a
    inv = true_divide(1.0, torch.sqrt(aw * aw + ax * ax + ay * ay + az * az + eps))
    return (aw * inv, ax * inv, ay * inv, az * inv)


def qexp_su2(vx, vy, vz):
    """exp(i v⃗·σ/2) as a quaternion (Rodrigues): (cos|v|/2, sin(|v|/2)·v̂),
    with the JAX package's series below |v|² = 1e-12."""
    n2 = vx * vx + vy * vy + vz * vz
    ns = torch.sqrt(torch.maximum(n2, torch.full((), 1e-24, dtype=n2.dtype, device=n2.device)))
    half = 0.5 * ns
    small = n2 < 1e-12
    s = torch.where(small, 0.5 - true_divide(n2, 48.0), torch.sin(half) / ns)
    w = torch.where(small, 1.0 - true_divide(n2, 8.0), torch.cos(half))
    return (w, s * vx, s * vy, s * vz)


# ---------------------------------------------------------------------------
# split-complex 3×3 algebra for SU(3): a matrix is a 3×3 nested list of
# (re, im) float32 tensors of one shape
# ---------------------------------------------------------------------------


def _cmul(a, b):
    (ar, ai), (br, bi) = a, b
    return (ar * br - ai * bi, ar * bi + ai * br)


def _cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _smul(A, B):
    """A·B, k summed 0 → 2."""
    out = []
    for i in range(3):
        row = []
        for j in range(3):
            s = _cmul(A[i][0], B[0][j])
            s = _cadd(s, _cmul(A[i][1], B[1][j]))
            s = _cadd(s, _cmul(A[i][2], B[2][j]))
            row.append(s)
        out.append(row)
    return out


def _sdag(A):
    return [[(A[j][i][0], -A[j][i][1]) for j in range(3)] for i in range(3)]


def _sadd(A, B):
    return [[_cadd(A[i][j], B[i][j]) for j in range(3)] for i in range(3)]


def _split(x: torch.Tensor):
    """complex (..., 3, 3) → split matrix of (re, im) views."""
    r = torch.view_as_real(x)
    return [[(r[..., i, j, 0], r[..., i, j, 1]) for j in range(3)] for i in range(3)]


def _join(A) -> torch.Tensor:
    """split matrix → complex64 (..., 3, 3)."""
    parts = [
        torch.stack([torch.stack([A[i][j][p] for j in range(3)], dim=-1) for i in range(3)],
                    dim=-2)
        for p in (0, 1)
    ]
    return torch.complex(*parts)


def _sretr(A):
    return A[0][0][0] + A[1][1][0] + A[2][2][0]


def mmul(a, b):
    """Batched 3×3 complex product on the trailing axes."""
    return _join(_smul(_split(a), _split(b)))


def dag(a):
    """Hermitian conjugate on the trailing axes."""
    return torch.conj(torch.swapaxes(a, -1, -2)).resolve_conj()


def retr(a):
    """Re Tr on the trailing axes."""
    return _sretr(_split(a))


# Gell-Mann generators T_a = λ_a/2 (Tr T_aT_b = δ_ab/2), constant (8,3,3).
_S3 = 1.0 / np.sqrt(3.0)
_GELLMANN = 0.5 * np.array(
    [
        [[0, 1, 0], [1, 0, 0], [0, 0, 0]],
        [[0, -1j, 0], [1j, 0, 0], [0, 0, 0]],
        [[1, 0, 0], [0, -1, 0], [0, 0, 0]],
        [[0, 0, 1], [0, 0, 0], [1, 0, 0]],
        [[0, 0, -1j], [0, 0, 0], [1j, 0, 0]],
        [[0, 0, 0], [0, 0, 1], [0, 1, 0]],
        [[0, 0, 0], [0, 0, -1j], [0, 1j, 0]],
        [[_S3, 0, 0], [0, _S3, 0], [0, 0, -2 * _S3]],
    ],
    dtype=np.complex64,
)
_T8 = float(_GELLMANN[7, 0, 0].real)    # float32(1/(2√3))
_T8_33 = float(_GELLMANN[7, 2, 2].real)  # float32(−1/√3)


def _noise_h(e):
    """Σ_a η_a T_a for the eight real noise tensors e[0..7] (zero terms of
    the generator sum dropped; the remaining terms are added in a order)."""
    z = torch.zeros_like(e[0])
    return [
        [(0.5 * e[2] + _T8 * e[7], z), (0.5 * e[0], -0.5 * e[1]), (0.5 * e[3], -0.5 * e[4])],
        [(0.5 * e[0], 0.5 * e[1]), (-0.5 * e[2] + _T8 * e[7], z), (0.5 * e[5], -0.5 * e[6])],
        [(0.5 * e[3], 0.5 * e[4]), (0.5 * e[5], 0.5 * e[6]), (_T8_33 * e[7], z)],
    ]


def _sexpi(Q):
    """exp(iQ) for split hermitian traceless Q: the Cayley–Hamilton closed
    form of ``stochquant_tpu.actions.gauge.expi_su3`` (Morningstar &
    Peardon, hep-lat/0311018 §III) with its branches and its Taylor series
    below c₁ = 1e-8."""
    q2 = _smul(Q, Q)
    q3 = _smul(q2, Q)
    c1 = 0.5 * _sretr(q2)
    c0 = true_divide(_sretr(q3), 3.0)

    small = c1 < 1e-8
    c1s = torch.where(small, 1.0, c1)
    c0a = torch.abs(c0)
    c1_3 = true_divide(c1s, 3.0)
    c0max = 2.0 * (c1_3 * torch.sqrt(c1_3))
    theta = torch.acos(torch.clamp(c0a / c0max, 0.0, 1.0 - 1e-6))
    theta_3 = true_divide(theta, 3.0)
    u = torch.sqrt(c1_3) * torch.cos(theta_3)
    w = torch.sqrt(c1s) * torch.sin(theta_3)

    w2 = w * w
    tiny = w2 < 1e-4
    series = 1.0 - true_divide(w2, 6.0) * (
        1.0 - true_divide(w2, 20.0) * (1.0 - true_divide(w2, 42.0)))
    xi0 = torch.where(tiny, series, torch.sin(w) / torch.where(tiny, 1.0, w))
    cosw = torch.cos(w)
    e2iu = (torch.cos(2.0 * u), torch.sin(2.0 * u))
    emiu = (torch.cos(u), -torch.sin(u))
    u2 = u * u

    uw = u2 - w2
    h0 = _cadd((uw * e2iu[0], uw * e2iu[1]),
               _cmul(emiu, (8.0 * u2 * cosw, 2.0 * u * (3.0 * u2 + w2) * xi0)))
    tu = 2.0 * u
    h1 = _csub((tu * e2iu[0], tu * e2iu[1]),
               _cmul(emiu, (tu * cosw, -((3.0 * u2 - w2) * xi0))))
    h2 = _csub(e2iu, _cmul(emiu, (cosw, 3.0 * u * xi0)))

    denom = 9.0 * u2 - w2
    f0 = (h0[0] / denom, h0[1] / denom)
    f1 = (h1[0] / denom, h1[1] / denom)
    f2 = (h2[0] / denom, h2[1] / denom)
    # c0 < 0: f_j(c0) = (−1)^j conj(f_j(|c0|))
    neg = c0 < 0.0
    f0 = (f0[0], torch.where(neg, -f0[1], f0[1]))
    f1 = (torch.where(neg, -f1[0], f1[0]), f1[1])
    f2 = (f2[0], torch.where(neg, -f2[1], f2[1]))

    out = []
    for r in range(3):
        row = []
        for c in range(3):
            closed = _cmul(f1, Q[r][c])
            if r == c:
                closed = _cadd(f0, closed)
            closed = _cadd(closed, _cmul(f2, q2[r][c]))
            # Q → 0: 1 + iQ − Q²/2 − (i/6)Q³
            one = 1.0 if r == c else 0.0
            tay = (
                (one - Q[r][c][1]) - 0.5 * q2[r][c][0] + q3[r][c][1] * (1.0 / 6.0),
                (Q[r][c][0] - 0.5 * q2[r][c][1]) - q3[r][c][0] * (1.0 / 6.0),
            )
            row.append((torch.where(small, tay[0], closed[0]),
                        torch.where(small, tay[1], closed[1])))
        out.append(row)
    return out


def _sproject(U):
    """One Newton step toward the nearest unitary, U ← U(3·1 − U†U)/2, then
    the det phase divided out (``project_su3``)."""
    W = _smul(_sdag(U), U)
    X = [[((1.5 if r == c else 0.0) - 0.5 * W[r][c][0], -0.5 * W[r][c][1])
          for c in range(3)] for r in range(3)]
    v = _smul(U, X)
    m0 = _csub(_cmul(v[1][1], v[2][2]), _cmul(v[1][2], v[2][1]))
    m1 = _csub(_cmul(v[1][0], v[2][2]), _cmul(v[1][2], v[2][0]))
    m2 = _csub(_cmul(v[1][0], v[2][1]), _cmul(v[1][1], v[2][0]))
    d = _cadd(_csub(_cmul(v[0][0], m0), _cmul(v[0][1], m1)), _cmul(v[0][2], m2))
    ang = torch.atan2(d[1], d[0]) * (-1.0 / 3.0)
    ph = (torch.cos(ang), torch.sin(ang))
    return [[_cmul(v[r][c], ph) for c in range(3)] for r in range(3)]


def expi_su3(q):
    """exp(iQ) for hermitian traceless complex (..., 3, 3) Q."""
    return _join(_sexpi(_split(q)))


def project_su3(u):
    """Nudge complex (..., 3, 3) links back onto SU(3)."""
    return _join(_sproject(_split(u)))


# ---------------------------------------------------------------------------
# actions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GaugeAction:
    """Wilson plaquette action; β multiplies Σ_p (1 − (1/N)ReTr U_p).

    The integrator (``integrators/gauge.py``) holds no per-group code:
    ``state_shape``/``noise_shape`` fix the layouts, ``drift`` returns the
    tangent force, ``omega`` forms the Langevin step Δτ_eff·F + √(2Δτ_eff)·η
    from it, ``apply_update`` is the exact group step ``U ← exp(iω)U`` and
    ``drift_norm`` is the per-chain max generator-space magnitude.
    """

    beta: float = 1.0
    #: dtype of the scalar observables (``plaq_mean``); the complexified
    #: groups of ``actions.gauge_complex`` report complex plaquettes
    obs_dtype = "float32"

    def init_links(self, shape, device=None):
        raise NotImplementedError

    def action(self, links, ndim: int):
        raise NotImplementedError

    def drift(self, links, ndim: int):
        raise NotImplementedError

    def mean_plaquette(self, links, ndim: int):
        raise NotImplementedError

    def state_shape(self, n_chains: int, ndim: int, lattice) -> tuple:
        raise NotImplementedError

    def noise_shape(self, n_chains: int, ndim: int, lattice) -> tuple:
        """Shape of the iid-N(0,1) real noise drawn per micro-step."""
        raise NotImplementedError

    def noise_to_tangent(self, eta):
        """Real noise components → the tangent object ``drift`` returns."""
        return eta

    def omega(self, f, eta, dtau_eff):
        """Δτ_eff·F + √(2Δτ_eff)·η with per-chain ``dtau_eff`` (C,)."""
        d = _bcast(dtau_eff, f.dim())
        return d * f + torch.sqrt(2.0 * d) * self.noise_to_tangent(eta)

    def drift_magnitude(self, f):
        """Per-link generator-space magnitude of the drift, (C, D, *L)."""
        raise NotImplementedError

    def drift_norm(self, f):
        """Per-chain max of :meth:`drift_magnitude` (NaN propagates)."""
        return _chain_max(self.drift_magnitude(f))

    def apply_update(self, links, omega):
        raise NotImplementedError

    # --- domain-decomposition support (parallel/gauge_halo.py): the state
    # layouts differ per group, so the halo runner asks each action where the
    # lattice dims live and for a per-site plaquette density it can cut to
    # the owned sites and sum across shards.

    def lattice_axes(self, ndim: int) -> tuple:
        """Axes of the state array holding the lattice dims."""
        raise NotImplementedError

    def noise_lattice_axes(self, ndim: int) -> tuple:
        """Axes of the ``noise_shape`` array holding the lattice dims."""
        raise NotImplementedError

    def plaquette_site(self, links, mu: int, nu: int, ndim: int):
        """(C, *L) plaquette observable (1/N)ReTr U_{μν}(x)."""
        raise NotImplementedError

    def plaquette_site_mean(self, links, ndim: int):
        """(C, *L) local plaquette density: the per-site mean over unordered
        orientations of the observable whose lattice mean is
        ``mean_plaquette``."""
        acc, n = None, 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = self.plaquette_site(links, mu, nu, ndim)
                acc = w if acc is None else acc + w
                n += 1
        return true_divide(acc, float(n))

    def hot_start(self, links, eta):
        """Randomized links from identity ``links`` and one noise draw."""
        return self.apply_update(links, self.noise_to_tangent(eta))

    def unitarity_norm(self, links, ndim: int):
        """Distance from the unitary submanifold, (C,) ≥ 0: identically 0 for
        the compact groups; the complexified ones override it."""
        return torch.zeros((links.shape[0],), dtype=torch.float32, device=links.device)


def _sum_pairs(ndim, fn, dtype, device, C):
    """Σ over unordered (μ<ν) of fn(μ, ν) (C,) started from zeros, and the
    number of pairs."""
    tot = torch.zeros((C,), dtype=dtype, device=device)
    n = 0
    for mu in range(ndim):
        for nu in range(mu + 1, ndim):
            tot = tot + fn(mu, nu)
            n += 1
    return tot, n


@register_gauge("u1")
@dataclasses.dataclass(frozen=True)
class U1Wilson(GaugeAction):
    """Compact U(1): links e^{iθ}, state = θ of shape (C, D, *L)."""

    def plaquette_angle(self, theta, mu: int, nu: int, ndim: int):
        """P_{μν}(x) = θ_μ(x) + θ_ν(x+μ̂) − θ_μ(x+ν̂) − θ_ν(x)."""
        t_mu, t_nu = theta[:, mu], theta[:, nu]
        return t_mu + shift(t_nu, mu, +1, 1) - shift(t_mu, nu, +1, 1) - t_nu

    def action(self, theta, ndim: int):
        s, _ = _sum_pairs(
            ndim,
            lambda mu, nu: torch.sum(
                (1.0 - torch.cos(self.plaquette_angle(theta, mu, nu, ndim))).reshape(
                    theta.shape[0], -1), dim=1),
            theta.dtype, theta.device, theta.shape[0])
        return self.beta * s

    def drift(self, theta, ndim: int):
        """−∂S/∂θ_μ(x) = −β Σ_{ν≠μ}[ sin P_{μν}(x) − sin P_{μν}(x−ν̂) ]."""
        out = []
        for mu in range(ndim):
            acc = torch.zeros_like(theta[:, mu])
            for nu in range(ndim):
                if nu == mu:
                    continue
                sp = torch.sin(self.plaquette_angle(theta, mu, nu, ndim))
                acc = acc + sp - shift(sp, nu, -1, 1)
            out.append(-self.beta * acc)
        return torch.stack(out, dim=1)

    def mean_plaquette(self, theta, ndim: int):
        tot, n = _sum_pairs(
            ndim, lambda mu, nu: _chain_mean(torch.cos(self.plaquette_angle(theta, mu, nu, ndim))),
            theta.dtype, theta.device, theta.shape[0])
        return true_divide(tot, float(n))

    def init_links(self, shape, device=None):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice)

    def drift_magnitude(self, f):
        return torch.abs(f)

    def lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))  # (C, D, *L)

    def noise_lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))

    def plaquette_site(self, theta, mu, nu, ndim):
        return torch.cos(self.plaquette_angle(theta, mu, nu, ndim))

    def apply_update(self, theta, omega):
        """θ ← wrap(θ + ω), rounding half to even."""
        t = theta + omega
        two_pi = float(np.float32(2.0 * np.pi))
        return t - two_pi * torch.round(true_divide(t, two_pi))

    def hot_start(self, theta, eta):
        return float(np.float32(np.pi)) * torch.tanh(eta)


@register_gauge("su2")
@dataclasses.dataclass(frozen=True)
class SU2Wilson(GaugeAction):
    """SU(2) Wilson: quaternion links, state shape (C, 4, D, *L)."""

    @staticmethod
    def _link(q, mu: int):
        return tuple(q[:, c, mu] for c in range(4))

    def _staple_sum(self, q, mu: int, ndim: int):
        """Σ_{ν≠μ} forward + backward staples V with Tr(U_μ(x)·V) summing
        every plaquette that holds the link (x, μ)."""
        sh = lambda t, d, s: tuple(shift(c, d, s, 1) for c in t)  # noqa: E731
        u_mu = self._link(q, mu)
        acc = None
        for nu in range(ndim):
            if nu == mu:
                continue
            u_nu = self._link(q, nu)
            f = qmul(qmul(sh(u_nu, mu, +1), qconj(sh(u_mu, nu, +1))), qconj(u_nu))
            b = qmul(qmul(qconj(sh(sh(u_nu, mu, +1), nu, -1)), qconj(sh(u_mu, nu, -1))),
                     sh(u_nu, nu, -1))
            term = tuple(ff + bb for ff, bb in zip(f, b))
            acc = term if acc is None else tuple(a + t for a, t in zip(acc, term))
        return acc

    def drift(self, q, ndim: int):
        """f_a = −(β/2)·vec_a(U·V), shape (C, 3, D, *L)."""
        coef = -0.5 * self.beta
        per_mu = []
        for mu in range(ndim):
            w = qmul(self._link(q, mu), self._staple_sum(q, mu, ndim))
            per_mu.append(torch.stack([coef * w[1], coef * w[2], coef * w[3]], dim=1))
        return torch.stack(per_mu, dim=2)

    def plaquette(self, q, mu: int, nu: int):
        """½Tr U_{μν}(x), (C, *L)."""
        sh = lambda t, d, s: tuple(shift(c, d, s, 1) for c in t)  # noqa: E731
        u_mu, u_nu = self._link(q, mu), self._link(q, nu)
        return qmul(qmul(u_mu, sh(u_nu, mu, +1)), qmul(qconj(sh(u_mu, nu, +1)), qconj(u_nu)))[0]

    def action(self, q, ndim: int):
        s, _ = _sum_pairs(
            ndim, lambda mu, nu: torch.sum((1.0 - self.plaquette(q, mu, nu)).reshape(
                q.shape[0], -1), dim=1),
            q.dtype, q.device, q.shape[0])
        return self.beta * s

    def mean_plaquette(self, q, ndim: int):
        tot, n = _sum_pairs(ndim, lambda mu, nu: _chain_mean(self.plaquette(q, mu, nu)),
                            q.dtype, q.device, q.shape[0])
        return true_divide(tot, float(n))

    def apply_update(self, q, omega):
        """U ← exp(i ω⃗·σ/2) U, then one rsqrt re-normalization."""
        r = qexp_su2(omega[:, 0], omega[:, 1], omega[:, 2])
        new = qnormalize(qmul(r, tuple(q[:, c] for c in range(4))))
        return torch.stack(new, dim=1)

    def init_links(self, shape, device=None):
        q = torch.zeros(shape, dtype=torch.float32, device=device)
        q[:, 0] = 1.0
        return q

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, 4, ndim) + tuple(lattice)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, 3, ndim) + tuple(lattice)

    def drift_magnitude(self, f):
        """√(Σ_a f_a²) per link; f is (C, 3, D, *L)."""
        return torch.sqrt(f[:, 0] * f[:, 0] + f[:, 1] * f[:, 1] + f[:, 2] * f[:, 2])

    def lattice_axes(self, ndim):
        return tuple(range(3, 3 + ndim))  # (C, 4, D, *L)

    def noise_lattice_axes(self, ndim):
        return tuple(range(3, 3 + ndim))  # (C, 3, D, *L)

    def plaquette_site(self, q, mu, nu, ndim):
        return self.plaquette(q, mu, nu)


@register_gauge("su3")
@dataclasses.dataclass(frozen=True)
class SU3Wilson(GaugeAction):
    """SU(3) Wilson: matrix links, state shape (C, D, *L, 3, 3) complex64.

    Drift H = (β/(4N))·[G − (Tr G/N)·1] with G = i(M − M†), M = U_μ·V_μ
    (V the staple sum); update U ← exp(iΩ)U by the Cayley–Hamilton
    exponential, then one Newton step back onto SU(3)."""

    N: int = 3

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice) + (3, 3)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, 8, ndim) + tuple(lattice)

    def noise_to_tangent(self, eta):
        """(C, 8, D, *L) real → (C, D, *L, 3, 3) hermitian Σ_a η_a T_a."""
        return _join(_noise_h([eta[:, a] for a in range(8)]))

    def omega(self, f, eta, dtau_eff):
        F = _split(f)
        nt = _noise_h([eta[:, a] for a in range(8)])
        d = _bcast(dtau_eff, f.dim() - 2)
        na = torch.sqrt(2.0 * d)
        return _join([[(d * F[r][c][0] + na * nt[r][c][0], d * F[r][c][1] + na * nt[r][c][1])
                       for c in range(3)] for r in range(3)])

    def init_links(self, shape, device=None):
        eye = torch.eye(3, dtype=torch.complex64, device=device)
        return eye.expand(shape).contiguous()

    @staticmethod
    def _shifted(u, d, sign):
        """u(x + sign·d̂) for a (C, *L, 3, 3) per-direction field."""
        return torch.roll(u, -sign, dims=1 + d)

    def _plaquette_split(self, links, mu: int, nu: int):
        sh = self._shifted
        u_mu, u_nu = links[:, mu], links[:, nu]
        return _smul(_smul(_split(u_mu), _split(sh(u_nu, mu, +1))),
                     _smul(_sdag(_split(sh(u_mu, nu, +1))), _sdag(_split(u_nu))))

    def plaquette(self, links, mu: int, nu: int):
        """U_{μν}(x) as matrices, (C, *L, 3, 3)."""
        return _join(self._plaquette_split(links, mu, nu))

    def _retr_n(self, links, mu, nu):
        return true_divide(_sretr(self._plaquette_split(links, mu, nu)), float(self.N))

    def action(self, links, ndim: int):
        s, _ = _sum_pairs(
            ndim, lambda mu, nu: torch.sum((1.0 - self._retr_n(links, mu, nu)).reshape(
                links.shape[0], -1), dim=1),
            torch.float32, links.device, links.shape[0])
        return self.beta * s

    def mean_plaquette(self, links, ndim: int):
        tot, n = _sum_pairs(ndim, lambda mu, nu: _chain_mean(self._retr_n(links, mu, nu)),
                            torch.float32, links.device, links.shape[0])
        return true_divide(tot, float(n))

    def _staple_sum(self, links, mu: int, ndim: int):
        """Σ_{ν≠μ} forward + backward staples V_μ(x), split."""
        sh = self._shifted
        u_mu = links[:, mu]
        acc = None
        for nu in range(ndim):
            if nu == mu:
                continue
            u_nu = links[:, nu]
            f = _smul(_smul(_split(sh(u_nu, mu, +1)), _sdag(_split(sh(u_mu, nu, +1)))),
                      _sdag(_split(u_nu)))
            b = _smul(_smul(_sdag(_split(sh(sh(u_nu, mu, +1), nu, -1))),
                            _sdag(_split(sh(u_mu, nu, -1)))),
                      _split(sh(u_nu, nu, -1)))
            term = _sadd(f, b)
            acc = term if acc is None else _sadd(acc, term)
        return acc

    def drift(self, links, ndim: int):
        """Tangent force H = Σ_a f_a T_a, (C, D, *L, 3, 3) hermitian traceless."""
        coef = self.beta / (4.0 * self.N)
        per_mu = []
        for mu in range(ndim):
            m = _smul(_split(links[:, mu]), self._staple_sum(links, mu, ndim))
            # G = i(M − M†)
            g = [[(-(m[r][c][1] + m[c][r][1]), m[r][c][0] - m[c][r][0]) for c in range(3)]
                 for r in range(3)]
            tr = _cadd(_cadd(g[0][0], g[1][1]), g[2][2])
            tr_n = (true_divide(tr[0], float(self.N)), true_divide(tr[1], float(self.N)))
            h = [[(coef * (g[r][c][0] - tr_n[0] if r == c else g[r][c][0]),
                   coef * (g[r][c][1] - tr_n[1] if r == c else g[r][c][1]))
                  for c in range(3)] for r in range(3)]
            per_mu.append(_join(h))
        return torch.stack(per_mu, dim=1)

    def drift_magnitude(self, f):
        """√(2·Σ_ij |H_ij|²) per link."""
        F = _split(f)
        frob = None
        for r in range(3):
            for c in range(3):
                v = F[r][c][0] * F[r][c][0] + F[r][c][1] * F[r][c][1]
                frob = v if frob is None else frob + v
        return torch.sqrt(2.0 * frob)

    def lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))  # (C, D, *L, 3, 3)

    def noise_lattice_axes(self, ndim):
        return tuple(range(3, 3 + ndim))  # (C, 8, D, *L)

    def plaquette_site(self, links, mu, nu, ndim):
        return self._retr_n(links, mu, nu)

    def apply_update(self, links, omega):
        """U ← exp(iΩ)U, exact group exponential + re-unitarization."""
        return _join(_sproject(_smul(_sexpi(_split(omega)), _split(links))))
