"""Explicit domain decomposition of a scalar-field lattice: the halo runner
(port of ``stochquant_tpu.parallel.halo``).

Each shard of the mesh (``parallel.mesh``) owns a contiguous lattice block,
exchanges edge slices with its ring neighbours and updates its block locally.
The runner is written over the *list* of shards: local math is a loop over
the shards, a collective is one call of ``parallel.mesh`` between two such
loops.  The trajectory is bitwise that of the unsplit integrator: noise is
keyed by global coordinates, halo values are copies, and the per-chain
reductions are exact (max) or tolerance-tested (sum).

Backends of :func:`make_halo_runner`:

``torch``      the per-micro-step stencil in plain PyTorch, any D and dtype
               (the JAX package's ``xla``), with ``overlap=True`` (bulk stencil
               on the local wrap, then an edge fixup that alone reads the
               halos) or ``False`` (halos joined to the block first).
``cuda``       the kernels composed with the decomposition.  No lattice dim
               cut (a chain-only mesh): the whole-frame kernels 3 / 6 per
               shard with ``chain_offset``.  A cut lattice whose geometry the
               chunk kernel admits (:func:`chunk_backend_available`): kernel
               7, W micro-steps per launch on a block extended by an H-deep
               halo in every cut dim, exchanged once per chunk (two-phase, in
               ascending dim, so corners arrive through the neighbours'
               already-extended blocks; multi-hop when a slab is thinner than
               the halo).  Otherwise, in 2-D, the per-step kernel 9.
``cuda_step``  kernel 9 per micro-step (``kernels.field_halo_kernel``), given
               the halo slices of the split dims: one exchange and one launch
               per shard and micro-step (two under CHECKERBOARD); 2-D,
               float32, counter-based noise.
``cuda_pair``  kernel 7 forced; a mesh axis of size 1 on dim 0 is allowed (a
               ring of one).
``cuda_rdma``  kernel 8 (``field_kernel_nd.field_chunk_rdma_nd``): kernel 7's W
               steps on a dim-0-only split, each shard's launch given its own
               slab and its two dim-0 ring neighbours' and reading its H halo
               rows from them itself: no shift, no concat per chunk.  One hop
               (H no deeper than a slab), a ring of one allowed.  The shards of
               a ring in one process lie on one device; across processes (one
               process per card, or several on one card) a neighbour's slab is
               read in the other process's memory (``parallel.ipc``: two
               exported slabs a shard, chunk k after the neighbours' epoch k).

Every backend runs on a mesh across processes (``distributed.global_mesh``):
the runner attaches the mesh's transport (``parallel.ipc.attach``) and its
collectives cross processes; ``run.close()`` releases it.  On CPU tensors the
kernel wrappers run their plain versions, so every backend runs on a mesh of
CPU devices; on CUDA tensors they launch or raise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.actions.phi4 import FieldAction
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.kernels import field_halo_kernel, field_kernel
from stochquant_tpu_torch.kernels import field_kernel_nd as fknd
from stochquant_tpu_torch.kernels.field_kernel_tiled import obs_init, obs_step, obs_sums
from stochquant_tpu_torch.parallel import ipc
from stochquant_tpu_torch.parallel import mesh as mesh_mod
from stochquant_tpu_torch.parallel.mesh import DeviceMesh

__all__ = ["halo_shifted", "chunk_backend_available", "rdma_refusal", "rdma_backend_available",
           "resolve_backend", "make_halo_runner", "HALO_BACKENDS"]

HALO_BACKENDS = ("torch", "cuda", "cuda_step", "cuda_pair", "cuda_rdma")


def _shift(xs: list, mesh: DeviceMesh, axis, delta: int) -> list:
    """Every shard's neighbour ``delta`` steps along ``axis``; a ring of one
    is its own neighbour."""
    if mesh.axis_size(axis) == 1:
        return list(xs)
    return mesh_mod.ppermute(xs, mesh, axis, delta)


def halo_shifted(xs: list, axis: int, mesh: DeviceMesh, mesh_axis):
    """(x shifted −1, x shifted +1) along tensor dim ``axis`` with periodic
    wraparound across the shard ring, for the per-shard blocks ``xs``.

    Returns (ups, downs) with up[i] = x[i+1] and down[i] = x[i−1] in *global*
    coordinates.  For an unsplit axis this is ``torch.roll``; for a split one
    the wrap elements come from the ring neighbours."""
    if mesh.axis_size(mesh_axis) == 1:
        return ([torch.roll(x, -1, axis) for x in xs], [torch.roll(x, 1, axis) for x in xs])
    L = xs[0].shape[axis]
    right = _shift([x.narrow(axis, 0, 1) for x in xs], mesh, mesh_axis, +1)
    left = _shift([x.narrow(axis, L - 1, 1) for x in xs], mesh, mesh_axis, -1)
    ups = [torch.cat([x.narrow(axis, 1, L - 1), r], dim=axis) for x, r in zip(xs, right)]
    downs = [torch.cat([lh, x.narrow(axis, 0, L - 1)], dim=axis) for x, lh in zip(xs, left)]
    return ups, downs


def _chunk_guard_geometry(cfg: FieldConfig, mesh: DeviceMesh):
    """The derivation the chunk guard shares with the runner.  ``None`` when
    the common preconditions fail, else (local_shape, c_local, sharded_dims,
    W to probe)."""
    if cfg.dtype != "float32" or cfg.loops % 2 or not rng.counter_based(cfg.rng_impl):
        return None
    W_try = cfg.exchange_steps or fknd.default_exchange_steps(cfg)
    if not W_try or W_try % 2:
        return None
    lat = cfg.mesh_axes or (None,) * cfg.ndim
    local_shape = tuple(s // mesh.axis_size(ax) for s, ax in zip(cfg.shape, lat))
    c_local = cfg.n_chains // mesh.axis_size(cfg.mesh_chain_axis)
    sharded_dims = tuple(mesh.axis_size(ax) > 1 for ax in lat)
    return local_shape, c_local, sharded_dims, min(W_try, max(cfg.loops, 2))


def chunk_backend_available(action: FieldAction, cfg: FieldConfig, mesh: DeviceMesh) -> bool:
    """True when the chunk kernel (kernel 7) admits this (cfg, mesh) split:
    the one guard that :func:`make_halo_runner`'s backend resolution and
    ``runtime.select_field_backend`` share, so that the router and the runner
    cannot disagree."""
    geo = _chunk_guard_geometry(cfg, mesh)
    if geo is None:
        return False
    local_shape, c_local, sharded_dims, W_probe = geo
    try:
        field_kernel._action_constants(action)
        fknd.chunk_geometry(cfg, c_local, local_shape, W_probe, sharded_dims)
    except ValueError:
        return False
    return True


def rdma_refusal(action: FieldAction, cfg: FieldConfig, mesh: DeviceMesh):
    """Why kernel 8 (``cuda_rdma``) does not admit this (cfg, mesh) split, or
    ``None`` where it does: ``cfg.mesh_axes[0]`` names the dim-0 ring (a ring
    of one is allowed), no dim ≥ 1 is split, the chunk guard's common rules
    hold (float32, even loops and W, counter-based noise), the halo is one
    hop deep, and the shards of a dim-0 ring that one process holds lie on
    one device (across processes: one process per card)."""
    lat = tuple(cfg.mesh_axes or (None,) * cfg.ndim)
    if not lat[0]:
        return "cfg.mesh_axes[0] must name the dim-0 ring axis (a ring of one is allowed)"
    geo = _chunk_guard_geometry(cfg, mesh)
    if geo is None:
        return ("kernel 8 needs float32, an even cfg.loops and exchange_steps, and "
                f"counter-based noise (rng_impl='threefry' or 'threefry13'), not dtype="
                f"{cfg.dtype!r} loops={cfg.loops} exchange_steps={cfg.exchange_steps} "
                f"rng_impl={cfg.rng_impl!r}")
    local_shape, c_local, sharded_dims, W_probe = geo
    if any(sharded_dims[1:]):
        return f"kernel 8 takes dim-0-only splits, not mesh_axes {lat}"
    if mesh.axis_size(lat[0]) > 1:
        for ring in mesh.groups((lat[0],)):
            if len({mesh.devices[mesh.local(g)] for g in ring if mesh.local(g) is not None}) > 1:
                return ("the shards of a dim-0 ring in one process lie on several devices: kernel "
                        "8 reads its neighbours' slabs on its own card, or across processes in "
                        "another process's memory; give each card a process of its own "
                        "(parallel.distributed.global_mesh)")
    try:
        field_kernel._action_constants(action)
        fknd.rdma_chunk_geometry(cfg, c_local, local_shape, W_probe)
    except ValueError as e:
        return str(e)
    return None


def rdma_backend_available(action: FieldAction, cfg: FieldConfig, mesh: DeviceMesh) -> bool:
    """True when kernel 8 admits this (cfg, mesh) split: the guard that
    ``resolve_backend`` and ``runtime.select_field_backend``'s ``prefer_rdma``
    routing share, so that the router and the runner cannot disagree."""
    return rdma_refusal(action, cfg, mesh) is None


def resolve_backend(action: FieldAction, cfg: FieldConfig, mesh: DeviceMesh, backend: str) -> str:
    """The path a backend of :func:`make_halo_runner` takes for this (cfg,
    mesh), as the JAX package resolves 'pallas': 'torch', 'cuda_frame'
    (kernels 3 / 6 per shard), 'cuda_nd' (kernel 7), 'cuda_step' (kernel 9)
    or 'cuda_rdma' (kernel 8).  Raises for what the asked backend does not
    cover; the one copy the runner and ``runtime.select_field_backend``
    share.  ``cfg.prefer_rdma`` plays no part here: it steers only the
    router's 'auto'."""
    if backend not in HALO_BACKENDS:
        raise ValueError(f"unknown halo backend {backend!r}; known: {HALO_BACKENDS}")
    if backend == "cuda_rdma":
        reason = rdma_refusal(action, cfg, mesh)
        if reason:
            raise ValueError(f"backend='cuda_rdma' (kernel 8) cannot run this split: {reason}")
        return backend
    ndim = cfg.ndim
    lat_spec = tuple(cfg.mesh_axes)
    sharded_dims = tuple(mesh.axis_size(ax) > 1 for ax in lat_spec)
    if backend == "cuda_pair":
        if not any(sharded_dims) and not lat_spec[0]:
            raise ValueError("backend='cuda_pair' needs a split lattice dim (or "
                             "cfg.mesh_axes[0] set for the ring of one)")
        backend = "cuda_nd"
    if backend == "cuda":
        if not any(sharded_dims):
            backend = "cuda_frame"
        elif chunk_backend_available(action, cfg, mesh):
            backend = "cuda_nd"
        elif ndim == 2:
            backend = "cuda_step"
        else:
            raise ValueError(
                "this D >= 3 split geometry is not admissible for the composed chunk kernel "
                "(odd loops or exchange_steps, noise that is not counter-based, or a halo as "
                "deep as the lattice); use backend='torch'")
    if backend in ("cuda_frame", "cuda_step", "cuda_nd") and cfg.dtype != "float32":
        raise ValueError("the halo kernels are float32-only; use backend='torch' for other dtypes")
    if backend == "cuda_step" and ndim != 2:
        raise ValueError("the per-micro-step halo kernel supports 2-D lattices; D >= 3 split "
                         "lattices use backend='cuda' (the chunk kernel) or 'torch'")
    if backend == "cuda_frame" and ndim >= 3 and (cfg.loops % 2
                                                  or not rng.counter_based(cfg.rng_impl)):
        raise ValueError("the D-dim whole-frame kernel needs an even cfg.loops and "
                         "counter-based noise (rng_impl='threefry'); use backend='torch' "
                         "otherwise")
    if backend == "cuda_step" and not rng.counter_based(cfg.rng_impl):
        raise ValueError("the lattice-split kernel path requires rng_impl='threefry' or "
                         "'threefry13' (the exact edge fixup re-derives counter noise), "
                         f"not {cfg.rng_impl!r}")
    if backend == "cuda_nd" and cfg.loops % 2:
        raise ValueError("the composed chunk kernel needs an even cfg.loops")
    return backend


def make_halo_runner(action: FieldAction, cfg: FieldConfig, mesh: DeviceMesh, *,
                     overlap: bool = True, backend: str = "torch", step=None, chunk=None):
    """Build ``run(shards, n_frames) -> (shards, metrics)`` executing the field
    frame loop on a lattice split over ``mesh``.

    ``cfg.mesh_axes`` names the mesh axis of each lattice dim (None = whole);
    ``cfg.mesh_chain_axis`` optionally splits the chains.  ``shards`` is the
    list ``parallel.shard_field_state`` makes with the same cfg; ``metrics``
    are (n_frames, C) tensors on the mesh's first device.

    overlap (``torch`` backend): True runs the bulk stencil on the local wrap
    and fixes the edge slices up from the halos; False joins the halos to the
    block first.  Both give the same bits.  ``step`` / ``chunk`` replace the
    kernel 9 / kernel 7 wrapper (their ``_ref`` functions force the plain
    versions)."""
    if cfg.mesh_axes is None:
        raise ValueError("cfg.mesh_axes required for the halo runner")
    field_mod.check_field_supported(cfg, action)
    backend = resolve_backend(action, cfg, mesh, backend)
    mesh = ipc.attach(mesh)
    ndim, shape = cfg.ndim, tuple(cfg.shape)
    ca, lat_spec = cfg.mesh_chain_axis, tuple(cfg.mesh_axes)
    n_shards = mesh.size
    sizes, local_shape, c_local, ch_offs, lat_offs = mesh_mod.split_geometry(cfg, mesh)
    sharded_dims = tuple(n > 1 for n in sizes)
    dtype = cfg.torch_dtype
    a = cfg.spacing
    inv_a2 = 1.0 / (a * a)
    clamp = float(np.float32(cfg.clamp))
    checkerboard = cfg.sweep == Sweep.CHECKERBOARD
    rounds = rng.rounds_of(cfg.rng_impl)

    volume = float(math.prod(shape))
    n_per_slice = volume / shape[0]
    lat_reduce = tuple(range(1, ndim + 1))
    nonzero_reduce = tuple(range(2, ndim + 1))
    lat_mesh_axes = tuple(ax for ax, n in zip(lat_spec, sizes) if n > 1)
    other_axes = lat_mesh_axes[1:] if sizes[0] > 1 else lat_mesh_axes
    ax0 = lat_spec[0] if sizes[0] > 1 else None
    devs = mesh.devices
    # the shard that holds global slice 0 of each shard's dim-0 ring
    axis0 = mesh.axis_names.index(ax0) if ax0 else None
    row0_of = ((lambda g: mesh.shift(g, ax0, -mesh.global_coords(g)[axis0])) if ax0
               else (lambda g: g))
    each = range(n_shards)

    def exchange_halos(phis):
        """Per shard {dim: (left halo, right halo)} for every split dim: the
        slices just below and just above the block, from its ring neighbours."""
        pending = [{} for _ in each]
        for d in range(ndim):
            if not sharded_dims[d]:
                continue
            axis, L = d + 1, local_shape[d]
            right = _shift([p.narrow(axis, 0, 1) for p in phis], mesh, lat_spec[d], +1)
            left = _shift([p.narrow(axis, L - 1, 1) for p in phis], mesh, lat_spec[d], -1)
            for i in each:
                pending[i][d] = (left[i], right[i])
        return pending

    def laplacian_blocking(phis):
        laps = [torch.zeros_like(p) for p in phis]
        for d in range(ndim):
            ups, downs = halo_shifted(phis, d + 1, mesh, lat_spec[d])
            laps = [lap + (up + dn - 2.0 * p) for lap, up, dn, p in zip(laps, ups, downs, phis)]
        return [lap * inv_a2 for lap in laps]

    def laplacian_overlapped(phis):
        """Bitwise the unsplit ∇²: the bulk stencil runs on the local wrap,
        then the two edge slices of every exchanged dim are recomputed from
        the true neighbours with the bulk's operand order."""
        pending = exchange_halos(phis)
        laps = []
        for phi, pend in zip(phis, pending):
            lap = torch.zeros_like(phi)
            for d in range(ndim):
                axis = d + 1
                c = torch.roll(phi, -1, axis) + torch.roll(phi, 1, axis) - 2.0 * phi
                if d in pend:
                    left, right = pend[d]
                    L = phi.shape[axis]
                    up_first = phi.narrow(axis, 1, 1) if L > 1 else right
                    down_last = phi.narrow(axis, L - 2, 1) if L > 1 else left
                    c.narrow(axis, 0, 1).copy_(up_first + left - 2.0 * phi.narrow(axis, 0, 1))
                    c.narrow(axis, L - 1, 1).copy_(
                        right + down_last - 2.0 * phi.narrow(axis, L - 1, 1))
                lap = lap + c
            laps.append(lap * inv_a2)
        return laps

    def action_density_overlapped(phis):
        pending = exchange_halos(phis)
        out = []
        for phi, pend in zip(phis, pending):
            kin = torch.zeros_like(phi)
            for d in range(ndim):
                axis = d + 1
                up = torch.roll(phi, -1, axis)
                if d in pend:
                    up.narrow(axis, phi.shape[axis] - 1, 1).copy_(pend[d][1])
                diff = up - phi
                kin = kin + 0.5 * diff * diff * inv_a2
            out.append(kin + action.V(phi))
        return out

    def action_density_blocking(phis):
        kins = [torch.zeros_like(p) for p in phis]
        for d in range(ndim):
            ups, _ = halo_shifted(phis, d + 1, mesh, lat_spec[d])
            kins = [kin + 0.5 * (up - p) * (up - p) * inv_a2
                    for kin, up, p in zip(kins, ups, phis)]
        return [kin + action.V(p) for kin, p in zip(kins, phis)]

    laplacian = laplacian_overlapped if overlap else laplacian_blocking
    action_density_local = action_density_overlapped if overlap else action_density_blocking

    def parity_mask(offs, block_shape, dev):
        """'Even' sites of the *global* checkerboard on a block at ``offs``."""
        s = torch.zeros((1,) + tuple(block_shape), dtype=torch.int64, device=dev)
        for d, n in enumerate(block_shape):
            view = [1] * (ndim + 1)
            view[d + 1] = n
            s = s + (torch.arange(n, dtype=torch.int64, device=dev) + offs[d]).view(view)
        return s % 2 == 0

    W_main = W_tail = n_chunks = 0
    chunk_split = ring = None
    kstep = None
    if backend == "cuda_step":
        kstep = field_halo_kernel.make_local_step(action, cfg, local_shape, c_local,
                                                  sharded_dims, step=step)
    elif backend in ("cuda_nd", "cuda_rdma"):
        W_cfg = cfg.exchange_steps or fknd.default_exchange_steps(cfg)
        if W_cfg % 2 or W_cfg < 2:
            raise ValueError("cfg.exchange_steps must be even and >= 2")
        W_main = min(W_cfg, cfg.loops)
        n_chunks = cfg.loops // W_main
        W_tail = cfg.loops - n_chunks * W_main
        if backend == "cuda_nd":
            # an explicit cuda_pair on an unsplit dim 0 (a ring of one) keeps the
            # dim-0 halo machinery live, so the chunk path itself can be timed
            chunk_split = (sharded_dims if any(sharded_dims)
                           else (bool(lat_spec[0]),) + (False,) * (ndim - 1))
            for Wx in (W_main, W_tail):
                if Wx:
                    fknd.chunk_geometry(cfg, c_local, local_shape, Wx, chunk_split)
            chunk_fn = chunk or fknd.field_chunk_nd
        else:
            # every shard reads the slabs of its dim-0 ring neighbours (its own on a ring of one)
            left_of = (lambda g: mesh.shift(g, ax0, -1)) if ax0 else (lambda g: g)
            right_of = (lambda g: mesh.shift(g, ax0, +1)) if ax0 else (lambda g: g)
            mine = [mesh.global_index(i) for i in each]
            ring_procs = sorted({mesh.owner(f(g)) for g in mine for f in (left_of, right_of)}
                                - {mesh.process_index})
            # across processes on the card: two exported slabs a shard, kernel 8
            # reading its neighbours' in the other processes' memory
            ring = (ipc.Ring(mesh.transport, (c_local,) + local_shape)
                    if mesh.transport is not None and ring_procs else None)
    elif backend == "cuda_frame":
        local_cfg = dataclasses.replace(cfg, n_chains=c_local, mesh_axes=None,
                                        mesh_chain_axis=None)

    # ---------------- the shared micro-step tail ---------------------------

    def slice_stats(s_slice_loc):
        """Complete the dim-0 slice sums (the last dim) across the other mesh
        axes, turn them into means, and find the mean of global slice 0 for
        every shard."""
        s_slice = mesh_mod.psum(s_slice_loc, mesh, other_axes)
        s_slice = [true_divide(s, n_per_slice) for s in s_slice]
        s0 = mesh_mod.pfrom([s[..., :1] for s in s_slice], mesh, row0_of)
        return s_slice, s0

    def finish_micro_step(phis, newphis, vals, max_det, bad, npmax, mag, phi2, act, s_slice_loc):
        """The micro-step tail every per-step backend ends in: the reductions
        completed across shards, the trip decision, the observable sums and
        the per-chain freeze, through ``obs_step``'s one set of expressions."""
        st = mesh_mod.pcat(
            [torch.stack([mag[i], phi2[i], act[i], max_det[i], npmax[i]], dim=-1)[:, None]
             for i in each], mesh, lat_mesh_axes, dim=1)
        anybad = mesh_mod.pany(bad, mesh, lat_mesh_axes)
        s_slice, s0 = slice_stats(s_slice_loc)
        out_phis, out_vals = [], []
        for i in each:
            u = vals[i][7].reshape((c_local,) + (1,) * ndim)
            out_phis.append(torch.where(u, phis[i], newphis[i]))
            out_vals.append(obs_step(vals[i], s_slice[i], st[i], volume, s0=s0[i],
                                     bad=anybad[i]))
        return out_phis, out_vals

    # ---------------- backend 'torch' --------------------------------------

    def em_apply(phis, masks, noises, dtaus):
        laps = laplacian(phis)
        out = []
        for i in each:
            phi = phis[i]
            det = (laps[i] - action.dV(phi).to(dtype)) * dtaus[i]
            new_raw = phi + det + noises[i]
            fin = torch.isfinite(new_raw)
            newphi = torch.where(fin, torch.clamp(new_raw, -clamp, clamp), clamp)
            if masks is not None:
                newphi = torch.where(masks[i], newphi, phi)
                det = torch.where(masks[i], det, 0.0)
                fin = fin | ~masks[i]
            out.append((newphi, torch.abs(det), fin))
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]

    def micro_step(phis, vals, etas, namps, dtaus, evens):
        noises = [namps[i] * etas[i] for i in each]
        if checkerboard:
            phi_e, absdet_e, fin_e = em_apply(phis, evens, noises, dtaus)
            newphis, absdet_o, fin_o = em_apply(phi_e, [~m for m in evens], noises, dtaus)
            absdet = [torch.maximum(x, y) for x, y in zip(absdet_e, absdet_o)]
            fin = [x & y for x, y in zip(fin_e, fin_o)]
        else:
            newphis, absdet, fin = em_apply(phis, None, noises, dtaus)
        dens = action_density_local(phis)
        return finish_micro_step(
            phis, newphis, vals,
            [torch.amax(x, dim=lat_reduce) for x in absdet],
            [~torch.all(f.reshape(c_local, -1), dim=1) for f in fin],
            [torch.amax(torch.abs(p), dim=lat_reduce) for p in newphis],
            [torch.sum(p, dim=lat_reduce) for p in phis],
            [torch.sum(p * p, dim=lat_reduce) for p in phis],
            [torch.sum(x.to(dtype), dim=lat_reduce) for x in dens],
            [torch.sum(p, dim=nonzero_reduce) if nonzero_reduce else p for p in phis],
        )

    def noise_pairs(step):
        pairs = [rng.normal_pair_for_shape(
            cfg.seed, rng.Stream.FIELD, step, (c_local,) + local_shape,
            global_lattice_shape=shape, chain_offset=ch_offs[i], lattice_offsets=lat_offs[i],
            rounds=rounds, device=devs[i]) for i in each]
        return [p[0].to(dtype) for p in pairs], [p[1].to(dtype) for p in pairs]

    # ---------------- backend 'cuda_step': kernel 9 with the halo slices -----

    def micro_step_kernel(phis, vals, pair_base, parity, dtaus):
        """One exchange and one launch of kernel 9 per shard (two under
        CHECKERBOARD, each half after its own exchange), then the tail."""
        koffs = [(ch_offs[i],) + lat_offs[i] for i in each]

        def half_sweep(src, half):
            pending = exchange_halos(src)
            return [kstep(src[i], dtaus[i], pair_base, parity, half, koffs[i], halos=pending[i])
                    for i in each]

        o = half_sweep(phis, 0)
        if checkerboard:
            # the odd half reads the fresh even sites' halos; its observables
            # are ignored (they sample once per micro-step)
            o2 = half_sweep([x[0] for x in o], 1)
            max_det = [torch.maximum(o[i][5], o2[i][5]) for i in each]
            bad = [(o[i][6] > 0) | (o2[i][6] > 0) for i in each]
        else:
            o2 = o
            max_det = [x[5] for x in o]
            bad = [x[6] > 0 for x in o]
        return finish_micro_step(phis, [x[0] for x in o2], vals, max_det, bad,
                                 [x[7] for x in o2], [x[1] for x in o], [x[2] for x in o],
                                 [x[3] for x in o], [x[4] for x in o])

    # ---- 'cuda_nd' (kernel 7, one exchange per chunk) and 'cuda_rdma' ------
    # ---- (kernel 8, the halo rows read by the kernel) ----------------------

    def extend(xs, d, Hd):
        """Every block extended by Hd sites per side along lattice dim d via
        the ring; multi-hop when the local extent is thinner than Hd."""
        ax, axis = lat_spec[d], d + 1
        Ld = xs[0].shape[axis]
        if Hd <= Ld:
            down = _shift([x.narrow(axis, 0, Hd) for x in xs], mesh, ax, +1)
            up = _shift([x.narrow(axis, Ld - Hd, Hd) for x in xs], mesh, ax, -1)
        else:
            k = -(-Hd // Ld)  # hops per side
            ups = [_shift(xs, mesh, ax, -j) for j in range(1, k + 1)]
            downs = [_shift(xs, mesh, ax, +j) for j in range(1, k + 1)]
            up = [torch.cat([u[i] for u in reversed(ups)], dim=axis).narrow(
                axis, k * Ld - Hd, Hd) for i in each]
            down = [torch.cat([dn[i] for dn in downs], dim=axis).narrow(axis, 0, Hd)
                    for i in each]
        return [torch.cat([u, x, dn], dim=axis).contiguous()
                for u, x, dn in zip(up, xs, down)]

    def ring_chunk(phis, dtaus, Wx, step):
        """Kernel 8 across processes on the card: chunk k waits until each
        neighbour's process has finished chunk k − 1 (its epoch ≥ k), reads
        its own slab and the neighbours' slabs k mod 2, writes its slab
        (k + 1) mod 2 and sets this process's epoch to k + 1.  A frame's
        first chunk is preceded by one such step that copies the state's φ
        into the slabs."""
        k = ring.k
        if any(p is not ring.own[k % 2][i] for i, p in enumerate(phis)):
            ring.wait(ring_procs, k)
            for i in each:
                ring.own[(k + 1) % 2][i].copy_(phis[i])
            k += 1
            ring.set(k)
        ring.wait(ring_procs, k)
        q = k % 2
        outs = [fknd.field_chunk_rdma_nd(ring.own[q][i], ring.slab(left_of(g), q),
                                         ring.slab(right_of(g), q), dtaus[i], action, cfg, Wx,
                                         step, lat_offs[i], ch_offs[i], out=ring.own[1 - q][i])
                for i, g in zip(each, mine)]
        ring.k = k + 1
        ring.set(ring.k)
        return outs

    def chunk_step(phis, vals, dtaus, Wx, step):
        if backend == "cuda_rdma" and ring is not None:
            outs = ring_chunk(phis, dtaus, Wx, step)
        elif backend == "cuda_rdma":
            # every launch is issued before any shard's phi is replaced, and
            # each writes a fresh tensor: neighbours read the old slabs
            lefts = mesh_mod.pfrom(phis, mesh, left_of)
            rights = mesh_mod.pfrom(phis, mesh, right_of)
            outs = [fknd.field_chunk_rdma_nd(phis[i], lefts[i], rights[i], dtaus[i], action, cfg,
                                             Wx, step, lat_offs[i], ch_offs[i]) for i in each]
        else:
            halos = fknd.chunk_halos(cfg, Wx, chunk_split)
            exts = phis
            for d in range(ndim):
                if halos[d]:
                    exts = extend(exts, d, halos[d])
            outs = [chunk_fn(exts[i], dtaus[i], action, cfg, Wx, chunk_split, step, lat_offs[i],
                             ch_offs[i], None) for i in each]
        # the chunk's W steps of statistics completed across shards at once
        st = mesh_mod.pcat([o[2] for o in outs], mesh, lat_mesh_axes, dim=1)
        s_slice, s0 = slice_stats([o[1] for o in outs])
        for w in range(Wx):
            vals = [obs_step(vals[i], s_slice[i][:, w], st[i][:, :, 5 * w:5 * w + 5], volume,
                             s0=s0[i][:, w]) for i in each]
        return [o[0] for o in outs], vals

    # ---------------- the frame ---------------------------------------------

    def frame(states):
        if backend == "cuda_frame":
            out = []
            for i, st in enumerate(states):
                if ndim >= 3:
                    out.append(fknd.field_frame_nd(st, action, local_cfg,
                                                   chain_offset=ch_offs[i]))
                else:
                    out.append(field_kernel.field_frame_step(st, action, local_cfg, ch_offs[i]))
            return [o[0] for o in out], [o[1] for o in out]

        step0 = int(states[0].step)
        phis = [s.phi for s in states]
        vals = [obs_init(s) for s in states]
        dtaus = [s.dtau for s in states]
        if backend in ("cuda_nd", "cuda_rdma"):
            step = step0
            for Wx in [W_main] * n_chunks + [W_tail]:
                if Wx:
                    phis, vals = chunk_step(phis, vals, dtaus, Wx, step)
                    step += Wx
            if ring is not None:  # the state keeps φ of its own, not the slab
                phis = [p.clone() for p in phis]
        elif backend == "cuda_step":
            for k in range(cfg.loops):
                phis, vals = micro_step_kernel(phis, vals, step0 + (k & ~1), k & 1, dtaus)
        else:
            bshape = (c_local,) + (1,) * ndim
            dtau_bs = [d.reshape(bshape) for d in dtaus]
            namps = [field_mod.noise_scale(d, cfg).reshape(bshape) for d in dtaus]
            evens = ([parity_mask(lat_offs[i], local_shape, devs[i]) for i in each]
                     if checkerboard else None)
            for k in range(0, cfg.loops, 2):
                e0, e1 = noise_pairs(step0 + k)
                phis, vals = micro_step(phis, vals, e0, namps, dtau_bs, evens)
                if k + 1 < cfg.loops:
                    phis, vals = micro_step(phis, vals, e1, namps, dtau_bs, evens)
        out = [field_mod.field_frame_epilogue(states[i], obs_sums(phis[i], vals[i]), cfg)
               for i in each]
        return [o[0] for o in out], [o[1] for o in out]

    run = mesh_mod.frame_loop(frame, mesh, ca)
    run.backend = backend
    return run
