"""Euler–Maruyama Langevin frames for D-dimensional scalar fields in plain
PyTorch: the twin of ``stochquant_tpu.integrators.field``.

Update (site measure w = a^D):

    φ += Δτ·( ∇²φ − V'(φ) ) + c·√(2Δτ/a^D)·η

with synchronous (SYNC) or checkerboard (CHECKERBOARD: even half-sweep,
then odd sites see the fresh even values) sweeps over a periodic lattice.
A frame is ``cfg.loops`` micro-steps (:func:`field_frame_sums`, the
semantics of CUDA kernel 3) followed by the accept/reject, running-mean
merge and adaptive-Δτ epilogue (:func:`field_frame_epilogue`, which kernel 4
also runs in-kernel).  Every expression keeps the JAX package's operand
order and the noise is the same counter-based Threefry stream, so the
trajectory agrees with the JAX package to float32 rounding of the
transcendentals; the site means (M, φ², s, slice means) agree to the
rounding of their sums, whose order differs.

As in the JAX package, every scheme other than ``Scheme.EXACT`` integrates
with Euler–Maruyama.  ``Scheme.EXACT`` (the exact free-field propagator and
its ETD1 variant for interacting fields) is not ported yet and raises.

State lives on one device, given explicitly, except ``step``: the micro-step
counter is a 0-d int64 tensor on the host (a uint32 value).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.actions.phi4 import FieldAction
from stochquant_tpu_torch.config import FieldConfig, Scheme, Sweep
from stochquant_tpu_torch.integrators import accum
from stochquant_tpu_torch.integrators.langevin import host_step, stack_metrics

__all__ = [
    "FieldState",
    "FieldFrameSums",
    "check_field_supported",
    "checkerboard_mask",
    "init_field_state",
    "field_frame_sums",
    "field_frame_epilogue",
    "run_field_frames",
    "susceptibility",
    "binder_cumulant",
    "reset_field_means",
]


class FieldState(NamedTuple):
    """Full resumable state of a batch of field chains (the JAX package's
    ``FieldState``, leaf for leaf)."""

    phi: torch.Tensor          # (C, *shape)
    mag_mean: torch.Tensor     # (C,) running ⟨M⟩, M = (1/V)Σφ
    mag2_mean: torch.Tensor    # (C,) running ⟨M²⟩
    mag4_mean: torch.Tensor    # (C,) running ⟨M⁴⟩
    absmag_mean: torch.Tensor  # (C,) running ⟨|M|⟩
    phi2_mean: torch.Tensor    # (C,) running ⟨φ²⟩ (site-averaged)
    act_mean: torch.Tensor     # (C,) running ⟨s⟩ action density (site-averaged)
    corr_mean: torch.Tensor    # (C, L0) running ⟨s̄(t)·s̄(0)⟩, s̄ = slice mean
    runs: torch.Tensor         # (C, 2) int64 (lo, hi) uint32 words of the sample count
    dtau: torch.Tensor         # (C,)
    stab_cnt: torch.Tensor     # (C,) int32
    lrg_vl: torch.Tensor       # (C,) running max |φ| (divergence threshold)
    step: torch.Tensor         # () int64 on the host: uint32 micro-step counter


class FieldFrameSums(NamedTuple):
    """What one frame of micro-steps returns (CUDA kernel 3's outputs)."""

    phi: torch.Tensor       # (C, *shape)
    ms: torch.Tensor        # (C,) frame Σ M
    m2s: torch.Tensor       # (C,) frame Σ M²
    m4s: torch.Tensor       # (C,) frame Σ M⁴
    ams: torch.Tensor       # (C,) frame Σ |M|
    p2s: torch.Tensor       # (C,) frame Σ ⟨φ²⟩
    acs: torch.Tensor       # (C,) frame Σ ⟨s⟩
    cs: torch.Tensor        # (C, L0) frame Σ slice correlator
    lrg_vl: torch.Tensor    # (C,)
    unstable: torch.Tensor  # (C,) bool


def check_field_supported(cfg: FieldConfig) -> None:
    """Raise for the field features that are not ported yet."""
    if cfg.scheme == Scheme.EXACT:
        raise ValueError(
            "Scheme.EXACT for fields (the exact free-field OU propagator per "
            "rfftn mode and its ETD1 variant for interacting actions) is not "
            "ported yet: use Scheme.EM"
        )
    rng.rounds_of(cfg.rng_impl)  # raises for rng_impl='hardware'


def checkerboard_mask(shape, ndim, device=None) -> torch.Tensor:
    """(1, *shape) bool mask, True on 'even' sites ((Σ coords) % 2 == 0)."""
    s = torch.zeros((1,) + tuple(shape), dtype=torch.int64, device=device)
    for d, n in enumerate(shape):
        view = [1] * (ndim + 1)
        view[d + 1] = n
        s = s + torch.arange(n, dtype=torch.int64, device=device).view(view)
    return s % 2 == 0


def init_field_state(cfg: FieldConfig, *, device) -> FieldState:
    """Cold start: φ = √(2Δτ)·N(0, 1) from the INIT stream at step 0;
    ``lrg_vl`` = max |φ| per chain; ``step = 1``."""
    check_field_supported(cfg)
    C = cfg.n_chains
    dtype = cfg.torch_dtype
    shape = (C,) + tuple(cfg.shape)
    z = rng.normal_for_shape(cfg.seed, rng.Stream.INIT, 0, shape,
                             rounds=rng.rounds_of(cfg.rng_impl), device=device).to(dtype)
    phi = torch.sqrt(torch.tensor(2.0 * cfg.dtau, dtype=dtype, device=device)) * z
    zc = torch.zeros((C,), dtype=dtype, device=device)
    return FieldState(
        phi=phi,
        mag_mean=zc,
        mag2_mean=zc.clone(),
        mag4_mean=zc.clone(),
        absmag_mean=zc.clone(),
        phi2_mean=zc.clone(),
        act_mean=zc.clone(),
        corr_mean=torch.zeros((C, cfg.shape[0]), dtype=dtype, device=device),
        runs=accum.init_runs(C, device=device),
        dtau=torch.full((C,), cfg.dtau, dtype=dtype, device=device),
        stab_cnt=torch.zeros((C,), dtype=torch.int32, device=device),
        lrg_vl=torch.amax(torch.abs(phi), dim=tuple(range(1, phi.dim()))),
        step=host_step(1),
    )


def noise_scale(dtau: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """Noise amplitude c·√(2Δτ/a^D) for the per-chain step sizes ``dtau``."""
    measure = cfg.spacing ** len(cfg.shape)
    c_amp = float(np.float32(cfg.noise_amp))
    return c_amp * torch.sqrt(true_divide(2.0 * dtau, measure))


def field_frame_sums(
    state: FieldState, action: FieldAction, cfg: FieldConfig, chain_offset: int = 0
) -> FieldFrameSums:
    """One frame of ``cfg.loops`` micro-steps from ``state`` (whose rows are
    global chains ``chain_offset …``), in pairs that share one Threefry draw.

    Observables sample the pre-update field; a chain whose detector trips
    (max |det| > lrg_vl, or a non-finite update) is frozen for the rest of
    the frame.  Returns the frame sums — the plain version of CUDA kernel 3.
    """
    check_field_supported(cfg)
    phi0 = state.phi
    C, shape = phi0.shape[0], tuple(phi0.shape[1:])
    ndim = len(shape)
    dev, dtype = phi0.device, phi0.dtype
    a = cfg.spacing
    clamp = float(np.float32(cfg.clamp))
    lat = tuple(range(1, ndim + 1))
    nonzero = tuple(range(2, ndim + 1))  # lattice axes except dim 0
    bshape = (C,) + (1,) * ndim
    dtau_b = state.dtau.reshape(bshape)
    namp = noise_scale(state.dtau, cfg).reshape(bshape)
    even = checkerboard_mask(shape, ndim, dev) if cfg.sweep == Sweep.CHECKERBOARD else None
    rounds = rng.rounds_of(cfg.rng_impl)

    def em_apply(phi, mask, noise):
        """EM update on ``mask`` sites (None = all), reading the current phi
        for the stencil; returns (new phi, |det|, finite)."""
        det = action.drift(phi, a, ndim).to(dtype) * dtau_b
        new_raw = phi + det + noise
        finite = torch.isfinite(new_raw)
        newphi = torch.where(finite, torch.clamp(new_raw, -clamp, clamp), clamp)
        if mask is None:
            return newphi, torch.abs(det), finite
        newphi = torch.where(mask, newphi, phi)
        det = torch.where(mask, det, 0.0)
        return newphi, torch.abs(det), finite | ~mask

    def micro_step(vals, eta):
        phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrg = vals
        noise = namp * eta
        if even is not None:
            phi_e, absdet_e, fin_e = em_apply(phi, even, noise)
            newphi, absdet_o, fin_o = em_apply(phi_e, ~even, noise)
            absdet = torch.maximum(absdet_e, absdet_o)
            fin = fin_e & fin_o
        else:
            newphi, absdet, fin = em_apply(phi, None, noise)
        max_det = torch.amax(absdet, dim=lat)
        bad = ~torch.all(fin.reshape(C, -1), dim=1)
        tripped = (max_det > lrg) | bad

        # observables sample the pre-update field
        mag = torch.mean(phi, dim=lat)
        phi2 = torch.mean(phi * phi, dim=lat)
        act_d = torch.mean(action.action_density(phi, a, ndim).to(dtype), dim=lat)
        s_slice = torch.mean(phi, dim=nonzero) if nonzero else phi  # (C, L0)
        corr = s_slice * s_slice[:, :1]

        mag2 = mag * mag
        keep = lambda new, old: torch.where(unstable, old, new)  # noqa: E731
        return (
            torch.where(unstable.reshape(bshape), phi, newphi),
            keep(ms + mag, ms),
            keep(m2s + mag2, m2s),
            keep(m4s + mag2 * mag2, m4s),
            keep(ams + torch.abs(mag), ams),
            keep(p2s + phi2, p2s),
            keep(acs + act_d, acs),
            torch.where(unstable[:, None], cs, cs + corr),
            unstable | tripped,
            keep(torch.maximum(lrg, torch.amax(torch.abs(newphi), dim=lat)), lrg),
        )

    def noise_pair(step):
        e0, e1 = rng.normal_pair_for_shape(
            cfg.seed, rng.Stream.FIELD, step, (C,) + shape, chain_offset=chain_offset,
            rounds=rounds, device=dev,
        )
        return e0.to(dtype), e1.to(dtype)

    zc = torch.zeros((C,), dtype=dtype, device=dev)
    vals = (phi0, zc, zc, zc, zc, zc, zc, torch.zeros_like(state.corr_mean),
            torch.zeros((C,), dtype=torch.bool, device=dev), state.lrg_vl)
    step0 = int(state.step)
    for p in range(cfg.loops // 2):
        e0, e1 = noise_pair(step0 + 2 * p)
        vals = micro_step(vals, e0)
        vals = micro_step(vals, e1)
    if cfg.loops % 2:
        e0, _ = noise_pair(step0 + cfg.loops - 1)
        vals = micro_step(vals, e0)
    phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrg = vals
    return FieldFrameSums(phi, ms, m2s, m4s, ams, p2s, acs, cs, lrg, unstable)


def field_frame_epilogue(state: FieldState, sums: FieldFrameSums, cfg: FieldConfig):
    """Accept/reject, running-mean merge and adaptive Δτ for one frame — the
    expressions of the JAX epilogue and of kernel 4's in-kernel one.
    Rejected frames still advance ``step`` (the retry draws fresh noise).
    Returns (new_state, metrics)."""
    accept = ~sums.unstable
    n_new = accum.runs_after(state.runs, cfg.loops)

    def merged(mean, frame_sum):
        n = n_new if mean.dim() == 1 else n_new[:, None]
        a = accept if mean.dim() == 1 else accept[:, None]
        return torch.where(a, accum.merge_frame_sum(mean, frame_sum, cfg.loops, n), mean)

    grow = accept & (state.stab_cnt >= cfg.grow_after)
    dtau = torch.where(
        grow,
        true_divide(state.dtau, cfg.shrink),
        torch.where(accept, state.dtau, state.dtau * cfg.shrink),
    )
    if cfg.dtau_max is not None:
        dtau = torch.clamp(dtau, max=float(np.float32(cfg.dtau_max)))
    stab_cnt = torch.where(accept, torch.where(grow, 0, state.stab_cnt + 1), 0).to(torch.int32)
    lrg_vl = torch.where(accept, sums.lrg_vl, state.lrg_vl)
    au = accept.reshape((-1,) + (1,) * (state.phi.dim() - 1))
    new_state = FieldState(
        phi=torch.where(au, sums.phi, state.phi),
        mag_mean=merged(state.mag_mean, sums.ms),
        mag2_mean=merged(state.mag2_mean, sums.m2s),
        mag4_mean=merged(state.mag4_mean, sums.m4s),
        absmag_mean=merged(state.absmag_mean, sums.ams),
        phi2_mean=merged(state.phi2_mean, sums.p2s),
        act_mean=merged(state.act_mean, sums.acs),
        corr_mean=merged(state.corr_mean, sums.cs),
        runs=accum.bump_runs(state.runs, cfg.loops, accept),
        dtau=dtau,
        stab_cnt=stab_cnt,
        lrg_vl=lrg_vl,
        step=host_step(int(state.step) + cfg.loops),
    )
    return new_state, {"stable": accept, "dtau": dtau, "max_phi": lrg_vl}


def run_field_frames(state: FieldState, action: FieldAction, cfg: FieldConfig,
                     n_frames: int):
    """``n_frames`` frames in plain PyTorch on the state's device, for any
    lattice dimension.  Returns (final_state, metrics) with metrics stacked
    over frames (n_frames, C)."""
    per_frame = []
    for _ in range(n_frames):
        state, m = field_frame_epilogue(state, field_frame_sums(state, action, cfg), cfg)
        per_frame.append(m)
    return state, stack_metrics(per_frame)


def susceptibility(state: FieldState, volume: int) -> torch.Tensor:
    """χ = V·(⟨M²⟩ − ⟨|M|⟩²) per chain."""
    return volume * (state.mag2_mean - state.absmag_mean * state.absmag_mean)


def binder_cumulant(state: FieldState) -> torch.Tensor:
    """U = 1 − ⟨M⁴⟩/(3⟨M²⟩²) per chain, with the denominator floored at the
    dtype's smallest normal (fresh or reset means give 1, not NaN)."""
    m2 = state.mag2_mean
    floor = torch.finfo(m2.dtype).tiny
    return 1.0 - state.mag4_mean / torch.clamp(3.0 * m2 * m2, min=floor)


def reset_field_means(state: FieldState) -> FieldState:
    """Zero the running observables (after thermalization burn-in)."""
    zc = torch.zeros_like(state.mag_mean)
    return state._replace(
        mag_mean=zc,
        mag2_mean=zc.clone(),
        mag4_mean=zc.clone(),
        absmag_mean=zc.clone(),
        phi2_mean=zc.clone(),
        act_mean=zc.clone(),
        corr_mean=torch.zeros_like(state.corr_mean),
        runs=torch.zeros_like(state.runs),
    )
