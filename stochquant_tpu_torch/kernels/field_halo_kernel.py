"""The per-micro-step bulk kernel of the lattice-split halo runner, and its
plain PyTorch version.

Port of ``stochquant_tpu/kernels/field_halo_kernel.py``: kernel 9,
:func:`field_halo_step` (``_build_kernel`` / ``_step_call`` /
``make_local_step``), advances a shard's local 2-D block (C, L0, L1) by one
Euler–Maruyama micro-step, or one checkerboard half-sweep, with **no halo
inputs**: the stencil wraps inside the block.  The sites on the first and
last slice of a split dim therefore come out wrong; they are left out of the
detector partials here and the runner (``parallel.halo``) replaces them with
the halo-informed update, in the kernel's own expression order.  The noise is
the Threefry draw at the site's global counter, so the trajectory does not
depend on the cut.

Outputs, as the JAX kernel's without their trailing unit dims: the new field
(C, L0, L1); Σφ, Σφ² and Σ(action density, local wrap) of the pre-update
field over all sites, (C,) each; its row sums Σ_cols φ (C, L0); and over the
interior sites only max|det|, the count of non-finite updates and max|φ_new|,
(C,) each.  The maxima propagate NaN.

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
from stochquant_tpu_torch.actions.phi4 import FieldAction, periodic_laplacian
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


def _check(phi, dtau, cfg: FieldConfig, offs, sharded_dims) -> None:
    check_kernel_config(cfg)
    if not rng.counter_based(cfg.rng_impl):
        raise ValueError(
            "the per-micro-step halo kernel requires counter-based noise (the edge fixup "
            f"re-derives it), not rng_impl={cfg.rng_impl!r}: use 'threefry' or 'threefry13'")
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
                        sharded_dims):
    """Plain PyTorch version of kernel 9 (see :func:`field_halo_step`)."""
    _check(phi, dtau, cfg, offs, sharded_dims)
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

    det = (periodic_laplacian(phi, a, 2) - action.dV(phi).to(dtype)) * dtau_b
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
        if split:
            idx = torch.arange(n, device=dev).view((1, n, 1) if d == 0 else (1, 1, n))
            interior = interior & (idx > 0) & (idx < n - 1)
    lat = (1, 2)
    act = action.action_density(phi, a, 2).to(dtype)
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
                    sharded_dims):
    """Kernel 9: one micro-step of the local block ``phi`` (C, L0, L1) with
    shard-local wrap.  ``pair_base`` is the counter of the pair's Threefry
    draw and ``parity`` the Box–Muller output this step takes; ``half`` is the
    checkerboard half-sweep (0 even, 1 odd; 0 for SYNC); ``offs`` = (chain,
    row, column) global offsets of the block; ``sharded_dims`` flags the split
    lattice dims, whose first and last slices stay out of the detector
    partials.  ``cfg`` carries the global lattice.  Returns the eight outputs
    listed in the module docstring."""
    _check(phi, dtau, cfg, offs, sharded_dims)
    dev = phi.device
    if dev.type == "cpu":
        return field_halo_step_ref(phi, dtau, action, cfg, pair_base, parity, half, offs,
                                   sharded_dims)
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
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    out, sl, part = empty(C, L0, L1), empty(C, L0), empty(C, params.n_strips, 6)
    _build.launch("sq_field_halo_step", params, (phi, dtau, out, sl, part), dev)
    field_halo_step.launches += 1
    # per strip: sum(phi), sum(phi^2), sum(action), count; then max|det|, max|phi_new|
    sums, maxima = part[:, :, :4].sum(dim=1), part[:, :, 4:].amax(dim=1)
    return (out, sums[:, 0], sums[:, 1], sums[:, 2], sl, maxima[:, 0], sums[:, 3],
            maxima[:, 1])


field_halo_step.launches = 0


def make_local_step(action: FieldAction, cfg: FieldConfig, local_shape, c_local: int,
                    sharded_dims, *, step=None):
    """``step(phi, dtau, pair_base, parity, half, offs) -> outs`` for a local
    block of ``local_shape`` and ``c_local`` chains, as the JAX package's
    ``make_local_step``.  ``step`` is the kernel wrapper (default
    :func:`field_halo_step`; :func:`field_halo_step_ref` forces the plain
    version)."""
    check_kernel_config(cfg)
    fn = step or field_halo_step
    want = (c_local,) + tuple(local_shape)
    sharded_dims = tuple(bool(s) for s in sharded_dims)

    def local_step(phi, dtau, pair_base, parity, half, offs):
        if tuple(phi.shape) != want:
            raise ValueError(f"expected a local block {want}, got {tuple(phi.shape)}")
        return fn(phi, dtau, action, cfg, pair_base, parity, half, offs, sharded_dims)

    return local_step
