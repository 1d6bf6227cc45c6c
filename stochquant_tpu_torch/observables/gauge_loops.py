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

On links split over a device mesh (``parallel.mesh``: this process's
per-shard link tensors, in one process or across processes) the Polyakov
loop and the Wilson table are computed shard-local, with no gathered
lattice: :func:`split_polyakov_loop` multiplies the shards' own segments of
the winding line in ascending global order (su2 and su3 do not commute),
:func:`split_wilson_loop_table` extends each shard by ``rmax`` rows of halo
on the split dims of the loop's plane and sums over its own sites.  The
shards a process holds on one device go through the products as one tensor
joined along the chains.  Both reduce across shards through the mesh's collectives, in ascending global
index once, so a process's result is the one-process mesh run's bit for bit;
against the unsplit functions they differ by the order of the products and
sums (rounding).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stochquant_tpu_torch.actions import gauge as ga
from stochquant_tpu_torch.actions import gauge_complex as gc
from stochquant_tpu_torch.actions.base import true_divide

__all__ = ["wilson_loop", "wilson_loop_table", "polyakov_loop", "creutz_ratio", "wilson_flow",
           "split_polyakov_loop", "split_wilson_loop_table"]


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

    def pack(self, a) -> torch.Tensor:
        """A per-direction field as one tensor, lattice axes at 1 …"""
        return a

    def unpack(self, t: torch.Tensor):
        return t


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

    def pack(self, a):
        return torch.stack(a, dim=-1)

    def unpack(self, t):
        return t.unbind(-1)


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


def _wilson_product(alg: _Algebra, u_mu, u_nu, mu: int, nu: int, R: int, T: int):
    """The R×T loop's ordered product W_{R×T}(μ,ν)(x) at every x of the fields."""
    bottom = _line(alg, u_mu, mu, R)
    right = alg.shift(_line(alg, u_nu, nu, T), mu, R)
    top = alg.inv(alg.shift(bottom, nu, T))
    left = alg.inv(_line(alg, u_nu, nu, T))
    return alg.mul(alg.mul(bottom, right), alg.mul(top, left))


def wilson_loop(action, links, mu: int, nu: int, R: int, T: int):
    """⟨(1/N)ReTr W_{R×T}(μ,ν)⟩ per chain over all lattice positions, (C,)."""
    alg = _algebra(action)
    w = _wilson_product(alg, alg.select(links, mu), alg.select(links, nu), mu, nu, R, T)
    return ga._chain_mean(alg.trace_over_n(w)[0])


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


# ---------------------------------------------------------------------------
# links split over a device mesh
# ---------------------------------------------------------------------------


def _split_axes(cfg, mesh) -> list:
    """Per lattice dim, the mesh axis that cuts it, or None where it is whole."""
    return [ax if mesh.axis_size(ax) > 1 else None for ax in cfg.mesh_axes]


def _joined(tensors: list, dim: int = 0) -> list:
    """The shards' tensors in runs of consecutive shards on one device with
    one shape, each run joined along the chains (tensor dim ``dim``):
    ``[(joined, chains of each shard), ...]`` in shard order.  The loops'
    products are elementwise, so a joined run gives every shard its own bits,
    and the host issues one product's ops for the shards a device holds, not
    one a shard; traces and sums stay per shard."""
    runs = []
    for t in tensors:
        if runs and runs[-1][0].device == t.device and runs[-1][0].shape == t.shape:
            runs[-1].append(t)
        else:
            runs.append([t])
    return [(r[0] if len(r) == 1 else torch.cat(r, dim=dim), [t.shape[dim] for t in r])
            for r in runs]


def _chain_means(sums: list, cfg, mesh, lat_axes, volume: int) -> torch.Tensor:
    """Per shard, per-chain sums over its own sites (C_local, ...) → the
    per-chain means over ``volume`` sites in global chain order (C, ...), the
    same tensor in every process."""
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    sums = mesh_mod.psum(sums, mesh, lat_axes)
    means = [true_divide(x, float(volume)) for x in sums]
    if mesh.axis_size(cfg.mesh_chain_axis) > 1:
        means = mesh_mod.pcat(means, mesh, [cfg.mesh_chain_axis], dim=0)
    return means[0]


def split_polyakov_loop(action, links: list, cfg, mesh):
    """:func:`polyakov_loop` along lattice dim 0 of links split over ``mesh``
    as ``cfg.mesh_axes`` / ``cfg.mesh_chain_axis`` say: ``links`` are this
    process's per-shard link tensors.  Each shard forms the ordered product
    of its own dim-0 links from its first row; the shards along dim 0 join
    their products (``pcat``, ascending global order) and multiply them in
    that order; the trace is summed over the shard's transverse sites and
    over the shards across them (``psum``).  Returns (C, 2) in global chain
    order, the same in every process."""
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    alg = _algebra(action)
    split = _split_axes(cfg, mesh)
    segments = []
    for u, counts in _joined([alg.pack(alg.select(x, 0)) for x in links]):
        line = alg.pack(_line(alg, alg.unpack(u), 0, u.shape[1])).narrow(1, 0, 1)
        segments += [seg.unsqueeze(0) for seg in line.split(counts)]
    if split[0]:
        segments = mesh_mod.pcat(segments, mesh, [split[0]], dim=0)
    sums = []
    for seg in segments:
        parts = [alg.unpack(p) for p in seg.unbind(0)]
        line = parts[0]
        for p in parts[1:]:
            line = alg.mul(line, p)
        re, im = alg.trace_over_n(line)
        c = re.shape[0]
        sums.append(torch.stack([re.reshape(c, -1).sum(dim=1), im.reshape(c, -1).sum(dim=1)],
                                dim=-1))
    return _chain_means(sums, cfg, mesh, [a for a in split[1:] if a], math.prod(cfg.shape[1:]))


def _extend_high(fields: list, mesh, axis: str, dim: int, depth: int) -> list:
    """Each shard's tensor with the next ``depth`` rows along tensor dim
    ``dim`` appended: the following shards' first rows along mesh ``axis``
    (several hops where a shard is thinner than ``depth``)."""
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    L = fields[0].shape[dim]
    halos = [mesh_mod.ppermute([f.narrow(dim, 0, min(L, depth - k * L)) for f in fields],
                               mesh, axis, k + 1)
             for k in range(-(-depth // L))]
    return [torch.cat([f] + [h[i] for h in halos], dim=dim) for i, f in enumerate(fields)]


def split_wilson_loop_table(action, links: list, cfg, mesh, mu: int, nu: int, rmax: int,
                            tmax: int):
    """:func:`wilson_loop_table` of links split over ``mesh`` (as
    :func:`split_polyakov_loop`): each shard's μ and ν fields extended by
    ``rmax`` rows along μ and ``tmax`` along ν where those dims are split
    (μ first, then ν of the extended block, which carries the corners), the
    loops evaluated there and summed over the shard's own sites, then over
    the shards (``psum``).  Returns (C, rmax, tmax), the same in every process."""
    alg = _algebra(action)
    split = _split_axes(cfg, mesh)
    fields = [torch.stack([alg.pack(alg.select(x, mu)), alg.pack(alg.select(x, nu))])
              for x in links]
    local = fields[0].shape[2:2 + cfg.ndim]
    for d, depth in ((mu, rmax), (nu, tmax)):
        if split[d]:
            fields = _extend_high(fields, mesh, split[d], 2 + d, depth)
    cells = []  # per shard, per (R, T): the per-chain sum over its own sites
    for f, counts in _joined(fields, dim=1):
        u_mu, u_nu = alg.unpack(f[0]), alg.unpack(f[1])
        run = [{} for _ in counts]
        for r in range(1, rmax + 1):
            for t in range(1, tmax + 1):
                w = _wilson_product(alg, u_mu, u_nu, mu, nu, r, t)
                for k, part in enumerate(alg.unpack(p) for p in alg.pack(w).split(counts)):
                    re = alg.trace_over_n(part)[0]
                    for d in (mu, nu):
                        if split[d]:
                            re = re.narrow(1 + d, 0, local[d])
                    run[k][r, t] = re.reshape(re.shape[0], -1).sum(dim=1)
        cells += run
    sums = [torch.stack([torch.stack([c[r, t] for t in range(1, tmax + 1)], dim=-1)
                         for r in range(1, rmax + 1)], dim=-2) for c in cells]
    return _chain_means(sums, cfg, mesh, [a for a in split if a], math.prod(cfg.shape))


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
