"""Wilson and Polyakov loops of compact gauge links (port of
``stochquant_tpu.observables.gauge_loops``: ``wilson_loop``,
``wilson_loop_table`` and ``polyakov_loop``).

The three groups share one implementation through a per-group algebra
adapter (product, inverse, lattice shift, normalized trace) over the
per-direction link fields.  Loops are measurement-time code on the plain
PyTorch path; SU(3) products are the split-complex products of
``actions.gauge``.
"""

from __future__ import annotations

import torch

from stochquant_tpu_torch.actions import gauge as ga
from stochquant_tpu_torch.actions.base import true_divide

__all__ = ["wilson_loop", "wilson_loop_table", "polyakov_loop"]


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


def _algebra(action: ga.GaugeAction) -> _Algebra:
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
