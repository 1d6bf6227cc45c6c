"""Gauge links split over a device mesh: the per-step halo runner and the
chunk runner (port of ``stochquant_tpu.parallel.gauge_halo``).

The drift of link U_μ(x) reads neighbours at most one site away in each
direction (the backward staple reaches the corner x+μ̂−ν̂), so a 1-site halo
per split dim, exchanged in ascending dim order (a later dim ships the
earlier dims' halos along, which carries the corners), suffices for every
group.  Both runners are written over the *list* of shards
(``parallel.mesh``): local math is a loop over the shards, a collective one
call between two such loops.

:func:`make_gauge_halo_runner`: plain PyTorch, any D, any set of split dims.
Per micro-step each shard extends its links by the halos, evaluates the full
drift on the extended block (exact for every owned site), draws the owned
block's noise from the global (chain, link, step) counters and updates its
owned links; the drift norm is completed across shards by ``pmax`` *every
micro-step*, so the drift-cap rescale is the unsplit integrator's and the
links agree with it bit for bit.  The plaquette is a sum of per-shard sums
(tolerance-tested).  It runs the complexified groups (``cu1``, ``csu2``,
``csu3``: their drift has the same one-site reach) with complex links, the
finite check on both parts and the unitarity norm the lattice mean of the
unsplit run (the shards' means summed by ``psum`` over the number of shards).

:func:`make_gauge_chunk_runner`: kernel 12 (``kernels.gauge_kernel.gauge_chunk``),
one launch per W micro-steps on the block extended by H = W halo rows,
exchanged once per chunk; 2-D u1 / su2 / su3, dim 0 split, even
``cfg.loops``; the complexified groups are refused.  The links are those of
the unsplit kernel 10 bit for bit
while the drift cap is quiescent.  The cap's semantics differ by design: a cap
event rejects the frame (rollback and Δτ shrink) where the unsplit path
rescales that step, which would need a collective per micro-step.

Gauge cooling is refused under both (its smearing stencil needs wider halos).

Both run on a mesh across processes (``distributed.global_mesh``): the
runner attaches the mesh's transport (``parallel.ipc.attach``), its
collectives cross processes (CPU tensors through gloo, CUDA tensors through
device memory the processes share), and ``run.close()`` releases it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.integrators import gauge as gauge_mod
from stochquant_tpu_torch.integrators.gauge import GaugeConfig, GaugeFrameSums
from stochquant_tpu_torch.kernels import gauge_kernel
from stochquant_tpu_torch.parallel import ipc
from stochquant_tpu_torch.parallel import mesh as mesh_mod
from stochquant_tpu_torch.parallel.mesh import DeviceMesh, shard_gauge_state

__all__ = ["make_gauge_halo_runner", "make_gauge_chunk_runner", "shard_gauge_state"]


def make_gauge_halo_runner(action, cfg: GaugeConfig, mesh: DeviceMesh):
    """Build ``run(shards, n_frames) -> (shards, metrics)`` executing the gauge
    frame loop with an explicit 1-site halo exchange per micro-step.

    ``cfg.mesh_axes`` names the mesh axis of each lattice dim (None = whole);
    ``cfg.mesh_chain_axis`` optionally splits the chains.  ``shards`` is the
    list :func:`shard_gauge_state` makes with the same cfg; ``metrics`` are
    (n_frames, C) tensors on the mesh's first device."""
    if cfg.mesh_axes is None:
        raise ValueError("cfg.mesh_axes required for the gauge halo runner")
    if cfg.cooling_rate > 0.0:
        raise ValueError("gauge cooling is not supported under the halo runner (wider "
                         "stencil); run unsplit or disable cooling")
    ndim, shape = cfg.ndim, tuple(cfg.shape)
    lat_spec = tuple(cfg.mesh_axes)
    sizes, local_shape, c_local, ch_offs, lat_offs = mesh_mod.split_geometry(cfg, mesh)
    mesh = ipc.attach(mesh)
    sharded_dims = tuple(n > 1 for n in sizes)
    lat_mesh_axes = tuple(ax for ax, n in zip(lat_spec, sizes) if n > 1)
    volume = float(math.prod(shape))
    n_lat = float(math.prod(sizes))
    cap = float(np.float32(cfg.drift_cap))
    lat_axes_state = action.lattice_axes(ndim)
    lat_axes_noise = action.noise_lattice_axes(ndim)
    noise_shape_loc = action.noise_shape(c_local, ndim, local_shape)
    noise_shape_glob = action.noise_shape(1, ndim, shape)[1:]
    each = range(mesh.size)
    noise_offs = []
    for i in each:
        offs = [0] * (len(noise_shape_loc) - 1)
        for d in range(ndim):
            offs[lat_axes_noise[d] - 1] = lat_offs[i][d]
        noise_offs.append(tuple(offs))

    def extend(xs, lat_axes):
        """1-site halos along every split lattice dim, in ascending dim."""
        for d in range(ndim):
            if not sharded_dims[d]:
                continue
            axis, L = lat_axes[d], xs[0].shape[lat_axes[d]]
            down = mesh_mod.ppermute([x.narrow(axis, 0, 1) for x in xs], mesh, lat_spec[d], +1)
            up = mesh_mod.ppermute([x.narrow(axis, L - 1, 1) for x in xs], mesh, lat_spec[d], -1)
            xs = [torch.cat([u, x, dn], dim=axis) for u, x, dn in zip(up, xs, down)]
        return xs

    def owned(x, lat_axes):
        """The owned block of an extended tensor."""
        for d in range(ndim):
            if sharded_dims[d]:
                x = x.narrow(lat_axes[d], 1, local_shape[d])
        return x

    def substep(vals, etas, dtaus):
        exts = extend([v[0] for v in vals], lat_axes_state)
        fs = [owned(action.drift(ext, ndim), lat_axes_state) for ext in exts]
        dnorms = mesh_mod.pmax([action.drift_norm(f) for f in fs], mesh, lat_mesh_axes)
        # the plaquette samples the pre-update links: the density on the
        # extended block, cut to the owned sites, summed, then across shards
        psums = mesh_mod.psum(
            [owned(action.plaquette_site_mean(ext, ndim), tuple(range(1, 1 + ndim)))
             .reshape(c_local, -1).sum(dim=1) for ext in exts], mesh, lat_mesh_axes)
        news, bads = [], []
        for i in each:
            links = vals[i][0]
            one = torch.ones((), dtype=torch.float32, device=links.device)
            tiny = torch.full((), 1e-30, dtype=torch.float32, device=links.device)
            scale = torch.minimum(one, true_divide(cap, torch.maximum(dnorms[i], tiny)))
            new = action.apply_update(links, action.omega(fs[i], etas[i], dtaus[i] * scale))
            news.append(new)
            bads.append(~torch.all(torch.isfinite(new).reshape(c_local, -1), dim=1))
        bads = mesh_mod.pany(bads, mesh, lat_mesh_axes)
        out = []
        for i in each:
            links, ps, dmax, unstable = vals[i]
            u = unstable.reshape((c_local,) + (1,) * (links.dim() - 1))
            out.append((
                torch.where(u, links, news[i]),
                torch.where(unstable, ps, ps + true_divide(psums[i], volume)),
                torch.where(unstable, dmax, torch.maximum(dmax, dnorms[i])),
                unstable | bads[i],
            ))
        return out

    def noise_pairs(step):
        pairs = [rng.normal_pair_for_shape(
            cfg.seed, rng.Stream.FIELD, step, noise_shape_loc,
            global_lattice_shape=noise_shape_glob, chain_offset=ch_offs[i],
            lattice_offsets=noise_offs[i], device=mesh.devices[i]) for i in each]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def frame(states):
        step0 = int(states[0].step)
        dtaus = [s.dtau for s in states]
        vals = [(s.links, torch.zeros_like(s.plaq_mean), s.drift_max,
                 torch.zeros((c_local,), dtype=torch.bool, device=s.links.device))
                for s in states]
        for k in range(0, cfg.loops, 2):
            e0, e1 = noise_pairs(step0 + k)
            vals = substep(vals, e0, dtaus)
            if k + 1 < cfg.loops:
                vals = substep(vals, e1, dtaus)
        out = [gauge_mod.gauge_frame_epilogue(states[i], GaugeFrameSums(*vals[i]), cfg, action)
               for i in each]
        # the unitarity norm is a per-link mean (no halo) over equal blocks:
        # the mean of the shards' means is the unsplit run's lattice mean
        norms = mesh_mod.psum([o[1]["unitarity_norm"] for o in out], mesh, lat_mesh_axes)
        for o, un in zip(out, norms):
            o[1]["unitarity_norm"] = true_divide(un, n_lat)
        return [o[0] for o in out], [o[1] for o in out]

    return mesh_mod.frame_loop(frame, mesh, cfg.mesh_chain_axis)


def make_gauge_chunk_runner(action, cfg: GaugeConfig, mesh: DeviceMesh, *, chunk=None):
    """Build ``run(shards, n_frames) -> (shards, metrics)`` on links split
    along lattice dim 0: one launch of kernel 12 per W micro-steps on the
    halo-extended local block, the halos ring-exchanged once per chunk.

    2-D u1 / su2 / su3 without cooling, dim-0 split (a ring of one included),
    even ``cfg.loops``; ``cfg.exchange_steps`` picks W (0: min(8, local rows,
    loops), floored to even).  Composes with a chain split via
    ``cfg.mesh_chain_axis``.  Everything else raises: :func:`make_gauge_halo_runner`
    is the general path.  ``chunk`` replaces the kernel wrapper
    (``gauge_kernel.gauge_chunk_ref`` forces the plain version)."""
    if cfg.mesh_axes is None:
        raise ValueError("cfg.mesh_axes required for the gauge chunk runner")
    if cfg.ndim != 2:
        raise ValueError("gauge chunk runner covers 2-D lattices; use make_gauge_halo_runner "
                         "for other dims")
    if not gauge_kernel.supports(action, cfg):
        raise ValueError("gauge chunk runner needs a group the kernels cover (2-D u1/su2/su3, "
                         "no cooling); use make_gauge_halo_runner")
    if cfg.loops % 2:
        raise ValueError("gauge chunk runner requires even cfg.loops")
    sizes, (loc0, L1), c_local, ch_offs, lat_offs = mesh_mod.split_geometry(cfg, mesh)
    if sizes[1] > 1:
        raise ValueError("gauge chunk runner splits lattice dim 0 only; use "
                         "make_gauge_halo_runner for dim-1 splits")
    ax = cfg.mesh_axes[0] if sizes[0] > 1 else None
    if cfg.exchange_steps and cfg.exchange_steps % 2:
        raise ValueError(f"gauge chunk runner: exchange_steps={cfg.exchange_steps} must be even "
                         "(micro-step pairs share one Threefry draw)")
    W = cfg.exchange_steps or min(8, loc0, cfg.loops)
    W = min(W, cfg.loops)
    W -= W % 2
    if W < 2:
        raise ValueError("gauge chunk runner needs W >= 2 (local slab too thin?); use "
                         "make_gauge_halo_runner")
    n_full, rem = divmod(cfg.loops, W)
    steps = {w: gauge_kernel.make_gauge_chunk_step(action, cfg, c_local, loc0, w, chunk=chunk)
             for w in ((W, rem) if rem else (W,))}
    mesh = ipc.attach(mesh)
    inv_vol = float(np.float32(1.0 / (cfg.shape[0] * L1)))
    lat_mesh_axes = (ax,) if ax else ()
    each = range(mesh.size)

    def shift(xs, delta):
        return mesh_mod.ppermute(xs, mesh, ax, delta) if ax else list(xs)

    def frame(states):
        step = int(states[0].step)
        planes = [gauge_kernel.links_to_planes_shaped(s.links, action, c_local, (loc0, L1))
                  for s in states]
        acc = None
        for w in [W] * n_full + ([rem] if rem else []):
            step_fn, H = steps[w]
            up = shift([p[:, :, loc0 - H:] for p in planes], -1)
            down = shift([p[:, :, :H] for p in planes], +1)
            outs = [step_fn(torch.cat([up[i], planes[i], down[i]], dim=2), states[i].dtau, step,
                            ch_offs[i], lat_offs[i][0]) for i in each]
            planes = [o[0] for o in outs]
            if acc is None:
                acc = [o[1:] for o in outs]
            else:
                acc = [(a[0] + o[1], torch.maximum(a[1], o[2]), a[2] | o[3], a[3] | o[4])
                       for a, o in zip(acc, outs)]
            step += w
        # the frame epilogue of the unsplit kernels, with the lattice
        # reductions completed across shards
        ps = mesh_mod.psum([a[0] for a in acc], mesh, lat_mesh_axes)
        dmax = mesh_mod.pmax([a[1] for a in acc], mesh, lat_mesh_axes)
        reject = mesh_mod.pany([a[2] | a[3] for a in acc], mesh, lat_mesh_axes)
        out = []
        for i in each:
            links = gauge_kernel.planes_to_links_shaped(planes[i], action, c_local, (loc0, L1))
            # on a rejected frame the drift_max metric is the rejected
            # trajectory's (the unsplit kernel freezes at the trip step); the
            # state's drift_max is rolled back the same way in both
            sums = GaugeFrameSums(links, ps[i] * inv_vol,
                                  torch.maximum(states[i].drift_max, dmax[i]), reject[i])
            out.append(gauge_mod.gauge_frame_epilogue(states[i], sums, cfg, action))
        return [o[0] for o in out], [o[1] for o in out]

    run = mesh_mod.frame_loop(frame, mesh, cfg.mesh_chain_axis)
    run.exchange_steps = W
    return run
