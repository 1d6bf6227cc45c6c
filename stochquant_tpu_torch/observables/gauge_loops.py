"""Gauge observables beyond the plaquette (port of
``stochquant_tpu.observables.gauge_loops``): Wilson and Polyakov loops, the
Creutz ratio and the Wilson gradient flow.

Every group (u1, su2, su3 and the complexified cu1, csu2, csu3) shares one
implementation through a per-group algebra adapter (product, inverse,
lattice shift, normalized trace) over the per-direction link fields; on the
complexified groups daggers become inverses and the traces are the
holomorphic continuations (valid complex-Langevin observables).  Loops are
measurement-time code on the plain PyTorch path; matrix products are the
split-complex products of ``actions.gauge`` and ``actions.gauge_complex``.

* ``wilson_loop`` — ⟨(1/N)ReTr W_{R×T}⟩ per chain over every position;
* ``polyakov_loop`` — (Re, Im) of the trace of the winding line;
* ``creutz_ratio`` — the string-tension estimator from a loop table;
* ``wilson_flow`` — the gradient flow dU/dt = Z(U)·U by Lüscher's 3-stage
  Runge–Kutta (Commun. Math. Phys. 293 (2010) 899), on the action's own
  ``drift`` / ``apply_update``.
"""

from __future__ import annotations

import numpy as np
import torch

from stochquant_tpu_torch.actions import gauge as ga
from stochquant_tpu_torch.actions import gauge_complex as gc
from stochquant_tpu_torch.actions.base import true_divide

__all__ = ["wilson_loop", "wilson_loop_table", "polyakov_loop", "creutz_ratio", "wilson_flow"]


class _Algebra:
    """Per-group view of a link state as D per-direction fields."""

    def select(self, links, mu):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def inv(self, a):
        raise NotImplementedError

    def shift(self, a, d, n):
        """a(x + n·d̂); lattice axes start at 1 on per-direction fields."""
        raise NotImplementedError

    def trace_over_n(self, a):
        """(1/N)·(ReTr, ImTr) as a pair of real (C, *L) tensors."""
        raise NotImplementedError


class _U1(_Algebra):
    # e^{iθ} carried additively in the angle
    def select(self, links, mu):
        return links[:, mu]

    def mul(self, a, b):
        return a + b

    def inv(self, a):
        return -a

    def shift(self, a, d, n):
        return torch.roll(a, -n, dims=1 + d)

    def trace_over_n(self, a):
        return torch.cos(a), torch.sin(a)


class _SU2(_Algebra):
    # quaternion tuples (w, x, y, z); links (C, 4, D, *L)
    def select(self, links, mu):
        return tuple(links[:, c, mu] for c in range(4))

    def mul(self, a, b):
        return ga.qmul(a, b)

    def inv(self, a):
        return ga.qconj(a)

    def shift(self, a, d, n):
        return tuple(torch.roll(c, -n, dims=1 + d) for c in a)

    def trace_over_n(self, a):
        return a[0], torch.zeros_like(a[0])


class _SU3(_Algebra):
    # complex 3×3 matrices on the trailing axes; links (C, D, *L, 3, 3)
    def select(self, links, mu):
        return links[:, mu]

    def mul(self, a, b):
        return ga.mmul(a, b)

    def inv(self, a):
        return ga.dag(a)

    def shift(self, a, d, n):
        return torch.roll(a, -n, dims=1 + d)

    def trace_over_n(self, a):
        s = ga._split(a)
        tr = ga._cadd(ga._cadd(s[0][0], s[1][1]), s[2][2])
        return true_divide(tr[0], 3.0), true_divide(tr[1], 3.0)


class _CU1(_U1):
    # complexified U(1): θ ∈ ℂ carried additively; the trace is the
    # holomorphic e^{iθ}
    def trace_over_n(self, a):
        r = torch.view_as_real(a)
        return gc.cexp(-r[..., 1], r[..., 0])  # exp(i(ar + i·ai))


class _CSUN(_SU3):
    # SL(N,ℂ) matrix links, the SU(3) layout with daggers → inverses
    def __init__(self, n: int):
        self.n = n

    def mul(self, a, b):
        return gc.mmul(a, b)

    def inv(self, a):
        return gc.inv22(a) if self.n == 2 else gc.inv33(a)

    def trace_over_n(self, a):
        tr = gc._ptrace(gc._split(a))
        return true_divide(tr[0], float(self.n)), true_divide(tr[1], float(self.n))


def _algebra(action: ga.GaugeAction) -> _Algebra:
    if isinstance(action, gc.ComplexU1Wilson):
        return _CU1()
    if isinstance(action, gc.ComplexSUNWilson):
        return _CSUN(action.N)
    for cls, alg in ((ga.U1Wilson, _U1), (ga.SU2Wilson, _SU2), (ga.SU3Wilson, _SU3)):
        if isinstance(action, cls):
            return alg()
    raise TypeError(f"no loop algebra for {type(action).__name__}")


def _line(alg: _Algebra, u_mu, mu: int, length: int):
    """Π_{k<length} U_μ(x + k·μ̂) from every x at once, by doubling."""
    assert length >= 1
    prod, done = u_mu, 1
    while done < length:
        step = min(done, length - done)
        tail = prod if step == done else _line(alg, u_mu, mu, step)
        prod = alg.mul(prod, alg.shift(tail, mu, done))
        done += step
    return prod


def wilson_loop(action, links, mu: int, nu: int, R: int, T: int):
    """⟨(1/N)ReTr W_{R×T}(μ,ν)⟩ per chain over all lattice positions, (C,)."""
    alg = _algebra(action)
    u_mu, u_nu = alg.select(links, mu), alg.select(links, nu)
    bottom = _line(alg, u_mu, mu, R)
    right = alg.shift(_line(alg, u_nu, nu, T), mu, R)
    top = alg.inv(alg.shift(bottom, nu, T))
    left = alg.inv(_line(alg, u_nu, nu, T))
    w = alg.mul(alg.mul(bottom, right), alg.mul(top, left))
    re, _ = alg.trace_over_n(w)
    return ga._chain_mean(re)


def wilson_loop_table(action, links, mu: int, nu: int, rmax: int, tmax: int):
    """W(R, T) for 1 ≤ R ≤ rmax, 1 ≤ T ≤ tmax; shape (C, rmax, tmax)."""
    return torch.stack([
        torch.stack([wilson_loop(action, links, mu, nu, r, t) for t in range(1, tmax + 1)],
                    dim=-1)
        for r in range(1, rmax + 1)
    ], dim=-2)


def polyakov_loop(action, links, axis: int):
    """(C, 2): [Re, Im] of ⟨(1/N)Tr P⟩ of the straight winding line along
    lattice ``axis``, averaged over the transverse volume."""
    alg = _algebra(action)
    u = alg.select(links, axis)
    ref = u[0] if isinstance(u, tuple) else u
    line = _line(alg, u, axis, ref.shape[1 + axis])
    re, im = alg.trace_over_n(line)
    return torch.stack([ga._chain_mean(re), ga._chain_mean(im)], dim=-1)


def creutz_ratio(w_table, r: int, t: int):
    """χ(r,t) = −log[W(r,t)·W(r−1,t−1) / (W(r,t−1)·W(r−1,t))], the lattice
    string-tension estimator; ``w_table`` is :func:`wilson_loop_table`'s
    output (1-indexed in R and T), r, t ≥ 2."""
    w = w_table
    i, j = r - 1, t - 1
    return -torch.log((w[..., i, j] * w[..., i - 1, j - 1])
                      / (w[..., i, j - 1] * w[..., i - 1, j]))


def _scaled(c: float, x):
    """float32(c)·x, on each part of a complex tensor."""
    c = float(np.float32(c))
    if x.is_complex():
        return torch.view_as_complex(c * torch.view_as_real(x))
    return c * x


def wilson_flow(action, links, ndim: int, eps: float, steps: int):
    """``steps`` steps of size ``eps`` in flow time of the Wilson gradient
    flow, by Lüscher's 3-stage Runge–Kutta:

        Z_i = ε·Z(W_i);  W₁ = e^{(1/4)Z₀}W₀;
        W₂ = e^{(8/9)Z₁ − (17/36)Z₀}W₁;  W₃ = e^{(3/4)Z₂ − (8/9)Z₁ + (17/36)Z₀}W₂

    Z(U) is the action's Langevin drift rescaled from β to β_flow = N (u1 and
    cu1: 1, su2: 2), so any group with a ``drift`` and an ``apply_update``
    flows.  Returns the flowed links (the layout of the input)."""
    scale = action.N if hasattr(action, "N") else (2 if isinstance(action, ga.SU2Wilson) else 1)
    znorm = float(scale) / float(action.beta)

    def z(u):
        return _scaled(eps * znorm, action.drift(u, ndim))

    def combo(*terms):
        out = None
        for c, x in terms:
            t = _scaled(c, x)
            out = t if out is None else out + t
        return out

    w = links
    for _ in range(steps):
        z0 = z(w)
        w = action.apply_update(w, _scaled(0.25, z0))
        z1 = z(w)
        w = action.apply_update(w, combo((8.0 / 9.0, z1), (-(17.0 / 36.0), z0)))
        z2 = z(w)
        w = action.apply_update(w, combo((0.75, z2), (-(8.0 / 9.0), z1), (17.0 / 36.0, z0)))
    return w
