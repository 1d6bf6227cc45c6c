"""Strip-tiled CUDA kernel for 2-D lattices too large for the whole-lattice
kernels, its plain PyTorch version, and the frame around it.

Port of ``stochquant_tpu/kernels/field_kernel_tiled.py``: kernel 5,
:func:`field_pair` (``_build_pair_kernel``), advances every chain by one pair
of micro-steps — both Box–Muller outputs of one Threefry draw — one block per
strip of ``tile_rows`` owned rows plus a recomputed H-row halo (H = 2 for
SYNC, 4 for CHECKERBOARD), and returns per-strip statistics and the slice
means of the two pre-update fields.  Plain version: :func:`field_pair_ref`,
which updates the whole lattice at once and cuts the same statistics per
strip.  :func:`field_frame_tiled` scans the pairs of a frame, runs the
per-pair statistics step in PyTorch, the last step of an odd ``loops`` as
one launch of kernel 6's code (``field_kernel_nd.field_step_nd``), and then
the frame epilogue.  The micro-step arithmetic (:func:`micro_steps`) and the
statistics step (:func:`obs_init`, :func:`obs_step`, :func:`obs_sums`) are
written for any dimension: the kernels of ``field_kernel_nd`` share them.

Like the JAX tiled path, a chain that trips keeps evolving until the frame
ends: the rollback discards those values, so accepted trajectories and the
accept/reject decisions equal the whole-lattice path's.  Noise is keyed by
global (site, step), so the result does not depend on ``tile_rows``.

Kernel 5 is CUDA C++ for ``sm_90a`` (``csrc/field_kernel_tiled.cu``).  A
wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel, or raises.  ``field_pair.launches`` counts launches.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.actions.phi4 import FieldAction, periodic_laplacian
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.integrators.field import FieldFrameSums, FieldState
from stochquant_tpu_torch.integrators.langevin import stack_metrics
from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.kernels.field_kernel import check_kernel_config, kernel_params

__all__ = [
    "field_pair",
    "field_pair_ref",
    "field_frame_tiled",
    "micro_steps",
    "obs_init",
    "obs_step",
    "obs_sums",
    "run_field_frames_tiled",
    "resolve_tile_rows",
    "halo_depth",
]

#: dynamic shared memory one block of kernel 5 may take for its two strip
#: buffers and its slice partials (an H100 block may use 227 KB in all; the
#: rest is the reduction's)
SMEM_BUDGET = 224 * 1024
#: the default strip height is a divisor of L0 up to this
MAX_DEFAULT_TILE_ROWS = 256
#: warps of a kernel 5 block (``FT_WARPS``)
WARPS = 32
#: SMs of the H100 SXM, each running one kernel 5 block at a time (1024
#: threads at 60 registers fill its register file)
SMS = 132


def halo_depth(cfg: FieldConfig) -> int:
    """Stencil applications per pair: 2 synchronous sweeps or 4 half-sweeps."""
    return 4 if cfg.sweep == Sweep.CHECKERBOARD else 2


def strip_bytes(tile_rows: int, cfg: FieldConfig) -> int:
    """Shared memory of kernel 5's two extended-strip buffers and its slice
    partials (a float per owned row and 32 columns)."""
    L1 = cfg.shape[1]
    E = tile_rows + 2 * halo_depth(cfg)
    return (2 * E * L1 + tile_rows * (-(-L1 // 32))) * 4


def strip_cost(tile_rows: int, cfg: FieldConfig) -> int:
    """The default strip height's figure of merit: waves of blocks (C · L0 /
    T0 blocks, one an SM at a time) times the sites a thread of a block
    takes per pass, ceil(E · L1 / 1024).  Taller strips recompute less of
    their halo; shorter ones give more blocks, and at least one a thread's
    worth of work."""
    L0, L1 = cfg.shape
    blocks = cfg.n_chains * (L0 // tile_rows)
    E = tile_rows + 2 * halo_depth(cfg)
    return -(-blocks // SMS) * -(-E * L1 // (32 * WARPS))


def strip_units(rows: int, L1: int) -> tuple:
    """Kernel 5's work split of ``rows`` rows of ``L1`` columns (a pass: the
    load of the E extended rows, stencil application a's E - 2a rows, the
    store of the T0 owned rows): (nch, cw, units per warp).  A row is cut into
    the fewest chunks that give every warp a unit, nch = ceil(32 / rows), at
    most one per 64 columns, of cw columns (a multiple of 64); unit u = (row u
    // nch, chunk u % nch) goes to warp u mod 32, whose lane l takes columns
    chunk·cw + l + 64 k and + 32 below min(L1, (chunk + 1)·cw)."""
    npair = -(-L1 // 64)
    nch = min(-(-WARPS // rows), npair)
    cw = 64 * -(-npair // nch)
    units = [[] for _ in range(WARPS)]
    for u in range(rows * nch):
        units[u % WARPS].append(divmod(u, nch))
    return nch, cw, units


def resolve_tile_rows(cfg: FieldConfig, tile_rows=None) -> int:
    """The strip height: ``tile_rows``, else ``cfg.tile_rows``, else the
    divisor of L0 (up to 256) whose two extended-strip buffers fit
    ``SMEM_BUDGET`` with the least :func:`strip_cost`, the tallest of equal
    cost (on the H100 at 16 chains: 16 rows at 1024², 32 at 256², the
    fastest of tools/lattice_kernel_timing.py's sweep under both sweeps).
    Raises if the height does not divide L0, or if no height fits."""
    L0, L1 = cfg.shape
    t0 = tile_rows or cfg.tile_rows
    if t0:
        if t0 < 0 or L0 % t0:
            raise ValueError(f"tile_rows={t0} must divide L0={L0}")
        if strip_bytes(t0, cfg) > SMEM_BUDGET:
            raise ValueError(
                f"tile_rows={t0}: the strip of {t0} + 2x{halo_depth(cfg)} rows of {L1} "
                f"floats, twice, needs {strip_bytes(t0, cfg)} bytes of shared memory; "
                f"a block has {SMEM_BUDGET}"
            )
        return t0
    fits = [t for t in range(min(L0, MAX_DEFAULT_TILE_ROWS), 0, -1)
            if L0 % t == 0 and strip_bytes(t, cfg) <= SMEM_BUDGET]
    if fits:
        return min(fits, key=lambda t: strip_cost(t, cfg))  # the first of a tie: the tallest
    raise ValueError(
        f"no tile_rows fits: even one row plus its 2x{halo_depth(cfg)}-row halo of {L1} "
        f"floats, twice, exceeds the {SMEM_BUDGET} bytes of shared memory a block has"
    )


def check_tiled_config(cfg: FieldConfig) -> None:
    """The tiled path's own rules, then the field kernels' (2-D, float32)."""
    if not rng.counter_based(cfg.rng_impl):
        raise ValueError(
            "the tiled kernel requires counter-based noise: halo rows are "
            "recomputed redundantly in neighboring strips, which only agrees "
            "when noise is a pure function of (site, step) — use "
            "rng_impl='threefry' or 'threefry13'"
        )
    check_kernel_config(cfg)


# ---------------------------------------------------------------------------
# kernel 5: one micro-step pair → per-strip statistics
# ---------------------------------------------------------------------------


def micro_steps(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction, cfg: FieldConfig,
                step: int, n_steps: int = 2, *, chain_offset: int = 0, site_ids=None, even=None):
    """``n_steps`` Euler–Maruyama micro-steps of a (C, *block) field of any
    dimension from counter ``step``, periodic within the block, each pair
    drawing both Box–Muller outputs of one Threefry evaluation (the last step
    of an odd count draws the pair at its own counter and takes the first):
    the arithmetic that kernels 5 to 8 share.

    ``site_ids`` (int64, broadcastable to the block) are the sites' global
    linear ids and ``even`` their global checkerboard parity; by default the
    block is the whole lattice.  Returns one (pre-update field, post-update
    field, |det|, action density of the pre-update field) per micro-step."""
    C, shape = phi.shape[0], tuple(phi.shape[1:])
    ndim = len(shape)
    dev, dtype = phi.device, phi.dtype
    a = cfg.spacing
    clamp = float(np.float32(cfg.clamp))
    bshape = (C,) + (1,) * ndim
    dtau_b = dtau.reshape(bshape)
    namp = field_mod.noise_scale(dtau, cfg).reshape(bshape)
    if cfg.sweep != Sweep.CHECKERBOARD:
        even = None
    elif even is None:
        even = field_mod.checkerboard_mask(shape, ndim, dev)
    if site_ids is None:
        site_ids = rng.global_site_index(shape, shape, device=dev)[None]
    chain_ids = rng.u32(torch.arange(C, dtype=torch.int64, device=dev) + chain_offset)
    key = rng.chain_key(rng.Stream.FIELD, chain_ids.view(bshape))
    rounds = rng.rounds_of(cfg.rng_impl)

    def em_apply(p, mask, noise, lap):
        # non-finite sites put +inf into |det|, so the one max finds the
        # detector statistic and flags them
        det = (lap - action.dV(p).to(dtype)) * dtau_b
        new_raw = p + det + noise
        finite = torch.isfinite(new_raw)
        newp = torch.where(finite, torch.clamp(new_raw, -clamp, clamp), clamp)
        absdet = torch.where(finite, torch.abs(det), float("inf"))
        if mask is not None:
            newp = torch.where(mask, newp, p)
            absdet = torch.where(mask, absdet, 0.0)
        return newp, absdet

    def micro(p, noise):
        lap = periodic_laplacian(p, a, ndim)
        act = action.action_density(p, a, ndim).to(dtype)
        if even is None:
            newp, absdet = em_apply(p, None, noise, lap)
            return p, newp, absdet, act
        p_e, absdet_e = em_apply(p, even, noise, lap)
        newp, absdet_o = em_apply(p_e, ~even, noise, periodic_laplacian(p_e, a, ndim))
        return p, newp, torch.maximum(absdet_e, absdet_o), act

    steps = []
    for k in range(0, n_steps, 2):
        e0, e1 = rng.normal_pair(cfg.seed, key, site_ids, rng.u32(int(step) + k), rounds)
        steps.append(micro(phi, namp * e0.to(dtype)))
        if k + 1 < n_steps:
            steps.append(micro(steps[-1][1], namp * e1.to(dtype)))
        phi = steps[-1][1]
    return steps


def field_pair_ref(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction,
                   cfg: FieldConfig, step: int, tile_rows: int):
    """Plain PyTorch version of kernel 5: two micro-steps from ``phi`` at
    counter ``step`` with per-chain step sizes ``dtau``.  Returns (phi after
    the pair, slice means of the two pre-update fields (C, L0) each, stats
    (C, L0 / tile_rows, 10)): per strip [Σφ, Σφ², Σs, max|det|, max|φ_new|]
    of the first micro-step, then of the second."""
    C, L0, L1 = phi.shape
    nt = L0 // tile_rows

    def strip_stats(pre, post, absdet, act):
        strips = lambda x: x.reshape(C, nt, tile_rows * L1)  # noqa: E731
        return torch.stack([
            strips(pre).sum(-1), strips(pre * pre).sum(-1), strips(act).sum(-1),
            strips(absdet).amax(-1), strips(torch.abs(post)).amax(-1),
        ], dim=-1)

    first, second = micro_steps(phi, dtau, action, cfg, step)
    inv_l1 = float(np.float32(1.0 / L1))
    stats = torch.cat([strip_stats(*first), strip_stats(*second)], dim=-1)
    return second[1], phi.sum(-1) * inv_l1, first[1].sum(-1) * inv_l1, stats


def field_pair(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction, cfg: FieldConfig,
               step: int, tile_rows: int):
    """Kernel 5: one micro-step pair of every chain, strip by strip.
    Returns what :func:`field_pair_ref` returns."""
    check_tiled_config(cfg)
    tile_rows = resolve_tile_rows(cfg, tile_rows)
    C, L0, L1 = phi.shape
    if (L0, L1) != tuple(cfg.shape):
        raise ValueError(f"phi has lattice {(L0, L1)}, cfg {cfg.shape}")
    dev = phi.device
    if dev.type == "cpu":
        return field_pair_ref(phi, dtau, action, cfg, step, tile_rows)
    if dev.type != "cuda":
        raise ValueError(f"the tiled field kernel runs on 'cuda' or 'cpu' tensors, not {dev}")
    _build.check_leaves(SimpleNamespace(phi=phi, dtau=dtau),
                        {"phi": ((C, L0, L1), torch.float32), "dtau": ((C,), torch.float32)},
                        dev)
    H = halo_depth(cfg)
    nt = L0 // tile_rows
    params = kernel_params((C, L0, L1), action, cfg, step0=step, tile_rows=tile_rows, halo=H)
    empty = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    out, sl0, sl1 = empty((C, L0, L1)), empty((C, L0)), empty((C, L0))
    stats = empty((C, nt, 10))
    zk = empty((C, nt, tile_rows + 2 * H, L1))  # the kept noise (csrc/field_kernel_tiled.cu)
    _build.launch("sq_field_pair", params, (phi, dtau, out, sl0, sl1, stats, zk), dev)
    field_pair.launches += 1
    return out, sl0, sl1, stats


field_pair.launches = 0


# ---------------------------------------------------------------------------
# frame loop
# ---------------------------------------------------------------------------


def obs_init(state: FieldState):
    """The frame-local sums a frame of pair or chunk launches starts from:
    (ΣM, ΣM², ΣM⁴, Σ|M|, Σ⟨φ²⟩, Σ⟨s⟩, Σ slice correlator, unstable, lrg_vl)."""
    C = state.phi.shape[0]
    zc = torch.zeros((C,), dtype=state.phi.dtype, device=state.phi.device)
    return (zc, zc, zc, zc, zc, zc, torch.zeros_like(state.corr_mean),
            torch.zeros((C,), dtype=torch.bool, device=zc.device), state.lrg_vl)


def obs_step(vals, s_slice, st, volume: float, s0=None, bad=None):
    """One micro-step's observable and detector step on the per-block
    statistics ``st`` (C, blocks, 5) and the slice means ``s_slice`` (C, L0):
    frame-local sample sums (two-level accumulation, accum.py).  A chain that
    has tripped stops adding to the sums and to ``lrg``.

    The halo runners (``parallel.halo``) pass the blocks of every shard of the
    lattice in ``st``, a shard's own rows in ``s_slice`` with the mean of
    global slice 0 in ``s0`` (C, 1), and in ``bad`` (C,) the chains holding a
    non-finite update that ``st`` does not already show as an infinite
    max|det|."""
    ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrg = vals
    mag = true_divide(st[:, :, 0].sum(dim=1), volume)
    phi2 = true_divide(st[:, :, 1].sum(dim=1), volume)
    act = true_divide(st[:, :, 2].sum(dim=1), volume)
    tripped = st[:, :, 3].amax(dim=1) > lrg
    if bad is not None:
        tripped = tripped | bad
    corr = s_slice * (s_slice[:, :1] if s0 is None else s0)
    keep = lambda new, old: torch.where(unstable, old, new)  # noqa: E731
    mag2 = mag * mag
    return (
        keep(ms + mag, ms), keep(m2s + mag2, m2s), keep(m4s + mag2 * mag2, m4s),
        keep(ams + torch.abs(mag), ams), keep(p2s + phi2, p2s), keep(acs + act, acs),
        torch.where(unstable[:, None], cs, cs + corr), unstable | tripped,
        keep(torch.maximum(lrg, st[:, :, 4].amax(dim=1)), lrg),
    )


def obs_sums(phi: torch.Tensor, vals) -> FieldFrameSums:
    """The frame sums after the last :func:`obs_step`, for the epilogue."""
    ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrg = vals
    return FieldFrameSums(phi, ms, m2s, m4s, ams, p2s, acs, cs, lrg, unstable)


def field_frame_tiled(state: FieldState, action: FieldAction, cfg: FieldConfig, *,
                      tile_rows=None, pair=None, tail=None):
    """One frame (``cfg.loops`` micro-steps) through the pair kernel: a scan
    over micro-step pairs with the observable and detector step in PyTorch,
    the last step of an odd count as one launch of kernel 6's code
    (``field_kernel_nd.odd_tail``), then the accept/reject and adaptive-Δτ
    epilogue of ``integrators.field``.  ``pair`` / ``tail`` are the pair and
    one-step functions (default :func:`field_pair` /
    ``field_kernel_nd.field_step_nd``; the ``_ref`` functions force the plain
    versions).  Returns (state, metrics)."""
    # kernel 6's module builds on this one's micro_steps and statistics step
    from stochquant_tpu_torch.kernels.field_kernel_nd import odd_tail

    check_tiled_config(cfg)
    tile_rows = resolve_tile_rows(cfg, tile_rows)
    pair = pair or field_pair
    volume = float(cfg.shape[0] * cfg.shape[1])
    vals = obs_init(state)
    phi = state.phi
    step0 = int(state.step)
    for k in range(cfg.loops // 2):
        phi, sl0, sl1, stats = pair(phi, state.dtau, action, cfg, step0 + 2 * k, tile_rows)
        vals = obs_step(vals, sl0, stats[:, :, :5], volume)
        vals = obs_step(vals, sl1, stats[:, :, 5:], volume)
    if cfg.loops % 2:
        phi, vals = odd_tail(phi, vals, state, action, cfg, None, tail=tail)
    return field_mod.field_frame_epilogue(state, obs_sums(phi, vals), cfg)


def run_field_frames_tiled(state: FieldState, action: FieldAction, cfg: FieldConfig,
                           n_frames: int, *, tile_rows=None, pair=None, tail=None):
    """``n_frames`` tiled frames — the counterpart of
    ``stochquant_tpu.kernels.field_kernel_tiled.run_field_frames_tiled``.
    Returns (state, metrics) with metrics of shape (n_frames, C)."""
    per_frame = []
    for _ in range(n_frames):
        state, m = field_frame_tiled(state, action, cfg, tile_rows=tile_rows, pair=pair,
                                     tail=tail)
        per_frame.append(m)
    return state, stack_metrics(per_frame)
