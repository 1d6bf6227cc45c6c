"""The per-micro-step kernel of the lattice-split halo runner, and its plain
PyTorch version.

Port of ``stochquant_tpu/kernels/field_halo_kernel.py``: kernel 9,
:func:`field_halo_step` (``_build_kernel`` / ``_step_call`` /
``make_local_step``), advances a shard's local 2-D block (C, L0, L1) by one
Euler–Maruyama micro-step, or one checkerboard half-sweep.  The noise is the
Threefry draw at the site's global counter, so the trajectory does not depend
on the cut.  Two modes:

* no halo inputs (``halos=None``), the JAX kernel's: the stencil wraps inside
  the block, so the sites on the first and last slice of a split dim come out
  wrong; the action sum takes the local wrap, and the detector outputs leave
  those slices out;
* with the halo slices of every split dim (``halos={d: (low, high)}``: the
  slices just below and just above the block along dim d, (C, 1, L1) for d =
  0 and (C, L0, 1) for d = 1, as the ring neighbours' edge slices), the
  runner's (``parallel.halo``, backend ``cuda_step``): the true stencil on
  every site, the true forward difference in the action sum, every site in
  the detector.  The split run is then the unsplit one bit for bit, and no
  edge fixup runs on the host.

Outputs, as the JAX kernel's without their trailing unit dims: the new field
(C, L0, L1); Σφ, Σφ² and Σ(action density) of the pre-update field over all
sites, (C,) each; its row sums Σ_cols φ (C, L0); and over the detector's
sites max|det|, the count of non-finite updates and max|φ_new|, (C,) each.
The maxima propagate NaN.

The kernel is CUDA C++ for ``sm_90a`` (``csrc/field_halo_kernel.cu``): a
chain's block is cut into strips of rows over many thread blocks, which write
per-strip partials that one ``torch`` call reduces, in the same order on every
run.  Plain version: :func:`field_halo_step_ref`.  A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel, or raises.
``field_halo_step.launches`` counts launches.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.phi4 import FieldAction
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.kernels.field_kernel import check_kernel_config, kernel_params

__all__ = ["field_halo_step", "field_halo_step_ref", "make_local_step", "strip_rows"]

#: thread blocks a launch should have before the strips stop shrinking (an
#: H100 has 132 multiprocessors)
TARGET_BLOCKS = 264


def strip_rows(L0: int, n_chains: int) -> int:
    """Rows of one thread block's strip: the block of a chain is cut until
    the launch has about ``TARGET_BLOCKS`` blocks."""
    strips = max(1, min(L0, -(-TARGET_BLOCKS // n_chains)))
    return -(-L0 // strips)


def _check_halos(phi, sharded_dims, halos) -> dict:
    """The halo slices as {dim: (low, high)}, checked: one pair for every
    split dim and none for another, each of the slice's shape."""
    if halos is None:
        return {}
    split = {d for d in (0, 1) if sharded_dims[d]}
    if set(halos) != split:
        raise ValueError(f"halos are the slices of every split dim {sorted(split)}, got dims "
                         f"{sorted(halos)}")
    C, L0, L1 = phi.shape
    for d, pair in halos.items():
        want = (C, 1, L1) if d == 0 else (C, L0, 1)
        if len(pair) != 2 or any(tuple(h.shape) != want for h in pair):
            raise ValueError(f"the halo slices of dim {d} are two tensors of shape {want}")
        if any(h.device != phi.device or h.dtype != phi.dtype for h in pair):
            raise ValueError(f"the halo slices of dim {d} must be {phi.dtype} on {phi.device}")
    return dict(halos)


def _neighbours(phi, halos: dict, d: int):
    """(φ(x − d̂), φ(x + d̂)) along lattice dim d: the halo slices joined to the
    block where dim d has them, else the block's own periodic wrap."""
    axis = d + 1
    if d not in halos:
        return torch.roll(phi, 1, dims=axis), torch.roll(phi, -1, dims=axis)
    low, high = halos[d]
    ext = torch.cat([low, phi, high], dim=axis)
    n = phi.shape[axis]
    return ext.narrow(axis, 0, n), ext.narrow(axis, 2, n)


def _check(phi, dtau, cfg: FieldConfig, offs, sharded_dims) -> None:
    check_kernel_config(cfg)
    if not rng.counter_based(cfg.rng_impl):
        raise ValueError(
            "the per-micro-step halo kernel requires counter-based noise (it draws each site's "
            f"at its global counter), not rng_impl={cfg.rng_impl!r}: use 'threefry' or "
            "'threefry13'")
    if phi.dim() != 3 or dtau.shape != (phi.shape[0],):
        raise ValueError(f"expected phi (C, L0, L1) and dtau (C,), got {tuple(phi.shape)} and "
                         f"{tuple(dtau.shape)}")
    if len(offs) != 3 or len(sharded_dims) != 2:
        raise ValueError("offs is (chain, row, column) and sharded_dims one flag per lattice dim")
    for d in (0, 1):
        if offs[d + 1] < 0 or offs[d + 1] + phi.shape[d + 1] > cfg.shape[d]:
            raise ValueError(f"the block at offset {offs[d + 1]} of extent {phi.shape[d + 1]} "
                             f"leaves dim {d} of the lattice {cfg.shape}")


def field_halo_step_ref(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction,
                        cfg: FieldConfig, pair_base: int, parity: int, half: int, offs,
                        sharded_dims, halos=None):
    """Plain PyTorch version of kernel 9 (see :func:`field_halo_step`): the
    halo slices, where given, joined to the block for the stencil and the
    action's forward difference."""
    _check(phi, dtau, cfg, offs, sharded_dims)
    given = _check_halos(phi, sharded_dims, halos)
    C, L0, L1 = phi.shape
    dev, dtype = phi.device, phi.dtype
    a = cfg.spacing
    clamp = float(np.float32(cfg.clamp))
    dtau_b = dtau.reshape(C, 1, 1)
    e0, e1 = rng.normal_pair_for_shape(
        cfg.seed, rng.Stream.FIELD, pair_base, (C, L0, L1), global_lattice_shape=cfg.shape,
        chain_offset=int(offs[0]), lattice_offsets=(int(offs[1]), int(offs[2])),
        rounds=rng.rounds_of(cfg.rng_impl), device=dev)
    noise = field_mod.noise_scale(dtau, cfg).reshape(C, 1, 1) * (e1 if parity else e0).to(dtype)

    # actions.phi4.periodic_laplacian and FieldAction.action_density, with the
    # neighbours across a split dim's edge from its halo slices where given
    inv_a2 = 1.0 / (a * a)
    lap, kin = torch.zeros_like(phi), torch.zeros_like(phi)
    for d in (0, 1):
        down, up = _neighbours(phi, given, d)
        lap = lap + (down + up - 2.0 * phi)
        diff = up - phi
        kin = kin + 0.5 * diff * diff * inv_a2
    det = (lap * inv_a2 - action.dV(phi).to(dtype)) * dtau_b
    new_raw = phi + det + noise
    fin = torch.isfinite(new_raw)
    newphi = torch.where(fin, torch.clamp(new_raw, -clamp, clamp), clamp)
    if cfg.sweep == Sweep.CHECKERBOARD:
        rows = torch.arange(L0, device=dev).view(1, L0, 1) + int(offs[1])
        cols = torch.arange(L1, device=dev).view(1, 1, L1) + int(offs[2])
        mask = (rows + cols) % 2 == (1 if half else 0)
        newphi = torch.where(mask, newphi, phi)
        det = torch.where(mask, det, 0.0)
        fin = fin | ~mask
    absdet = torch.abs(det)

    interior = torch.ones((1, L0, L1), dtype=torch.bool, device=dev)
    for d, (n, split) in enumerate(zip((L0, L1), sharded_dims)):
        if split and not given:
            idx = torch.arange(n, device=dev).view((1, n, 1) if d == 0 else (1, 1, n))
            interior = interior & (idx > 0) & (idx < n - 1)
    lat = (1, 2)
    act = (kin + action.V(phi)).to(dtype)
    return (
        newphi,
        torch.sum(phi, dim=lat),
        torch.sum(phi * phi, dim=lat),
        torch.sum(act, dim=lat),
        torch.sum(phi, dim=2),
        torch.amax(torch.where(interior, absdet, 0.0), dim=lat),
        torch.sum((interior & ~fin).to(dtype), dim=lat),
        torch.amax(torch.where(interior, torch.abs(newphi), 0.0), dim=lat),
    )


def field_halo_step(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction,
                    cfg: FieldConfig, pair_base: int, parity: int, half: int, offs,
                    sharded_dims, halos=None):
    """Kernel 9: one micro-step of the local block ``phi`` (C, L0, L1).
    ``pair_base`` is the counter of the pair's Threefry draw and ``parity``
    the Box–Muller output this step takes; ``half`` is the checkerboard
    half-sweep (0 even, 1 odd; 0 for SYNC); ``offs`` = (chain, row, column)
    global offsets of the block; ``sharded_dims`` flags the split lattice
    dims.  ``halos`` None: the shard-local wrap, and the first and last
    slices of a split dim stay out of the detector partials; ``{d: (low,
    high)}`` for every split dim d: the true neighbours there (module
    docstring).  ``cfg`` carries the global lattice.  Returns the eight
    outputs listed in the module docstring."""
    _check(phi, dtau, cfg, offs, sharded_dims)
    given = _check_halos(phi, sharded_dims, halos)
    dev = phi.device
    if dev.type == "cpu":
        return field_halo_step_ref(phi, dtau, action, cfg, pair_base, parity, half, offs,
                                   sharded_dims, halos)
    if dev.type != "cuda":
        raise ValueError(f"the halo step kernel runs on 'cuda' or 'cpu' tensors, not {dev}")
    C, L0, L1 = phi.shape
    _build.check_leaves(SimpleNamespace(phi=phi, dtau=dtau),
                        {"phi": ((C, L0, L1), torch.float32), "dtau": ((C,), torch.float32)},
                        dev)
    params = _build.FieldHaloParams()
    params.f = kernel_params((C, L0, L1), action, cfg, step0=pair_base,
                             chain_offset=int(offs[0]))
    rows = strip_rows(L0, C)
    params.gL1, params.row_off, params.col_off = cfg.shape[1], int(offs[1]), int(offs[2])
    params.parity, params.half = int(bool(parity)), int(bool(half))
    params.sh0, params.sh1 = int(bool(sharded_dims[0])), int(bool(sharded_dims[1]))
    params.rows_per_block, params.n_strips = rows, -(-L0 // rows)
    params.halos = int(bool(given))
    # the slices (below, above, left, right) the kernel reads: narrowed
    # views of the neighbours' blocks are made contiguous here
    slices = [h.contiguous() for d in (0, 1) for h in given.get(d, (phi, phi))]
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    out, sl, part = empty(C, L0, L1), empty(C, L0), empty(C, params.n_strips, 6)
    _build.launch("sq_field_halo_step", params, (phi, dtau, *slices, out, sl, part), dev)
    field_halo_step.launches += 1
    # per strip: sum(phi), sum(phi^2), sum(action), count; then max|det|, max|phi_new|
    sums, maxima = part[:, :, :4].sum(dim=1), part[:, :, 4:].amax(dim=1)
    return (out, sums[:, 0], sums[:, 1], sums[:, 2], sl, maxima[:, 0], sums[:, 3],
            maxima[:, 1])


field_halo_step.launches = 0


def make_local_step(action: FieldAction, cfg: FieldConfig, local_shape, c_local: int,
                    sharded_dims, *, step=None):
    """``step(phi, dtau, pair_base, parity, half, offs, halos=None) -> outs``
    for a local block of ``local_shape`` and ``c_local`` chains, as the JAX
    package's ``make_local_step`` (``halos``: the runner's halo slices, see
    :func:`field_halo_step`).  ``step`` is the kernel wrapper (default
    :func:`field_halo_step`; :func:`field_halo_step_ref` forces the plain
    version)."""
    check_kernel_config(cfg)
    fn = step or field_halo_step
    want = (c_local,) + tuple(local_shape)
    sharded_dims = tuple(bool(s) for s in sharded_dims)

    def local_step(phi, dtau, pair_base, parity, half, offs, halos=None):
        if tuple(phi.shape) != want:
            raise ValueError(f"expected a local block {want}, got {tuple(phi.shape)}")
        return fn(phi, dtau, action, cfg, pair_base, parity, half, offs, sharded_dims,
                  halos=halos)

    return local_step
