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
with Euler–Maruyama.  ``Scheme.EXACT`` propagates the Gaussian part
(−∇² + m²) exactly per ``rfftn`` mode through ``torch.fft`` (SYNC sweep, one
program, m² > 0): the pure exact-OU step for ``free_field``, with Δτ frozen,
and for interacting actions the exponential integrator with the explicit
ETD1 treatment of V′'s non-Gaussian remainder, which keeps the clamp, the
detector and the Δτ controller.  It is a plain-path feature here as in the
JAX package: no kernel implements it.

``rng_impl='hardware'``: :func:`field_frame_sums` draws the Philox-4x32-10
stream (``rng.philox_normal_quad``) only when its caller asks with
``philox=True``, which the plain versions of kernels 3 and 4 do;
:func:`run_field_frames` never does and draws Threefry-20 under that setting,
as the JAX package's XLA path does.

State lives on one device, given explicitly, except ``step``: the micro-step
counter is a 0-d int64 tensor on the host (a uint32 value).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.actions.phi4 import FieldAction, FreeField
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
    "make_field_frame_fn",
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


def check_field_supported(cfg: FieldConfig, action: FieldAction) -> None:
    """Raise for a field config no path runs: ``Scheme.EXACT`` without a
    positive Gaussian curvature, on a CHECKERBOARD sweep or over a mesh."""
    if cfg.scheme == Scheme.EXACT:
        _exact_field_check(action, cfg)


def _exact_field_check(action: FieldAction, cfg: FieldConfig) -> None:
    if not hasattr(action, "m2"):
        raise ValueError(
            "Scheme.EXACT needs the action's Gaussian curvature (an `m2` "
            f"attribute) to split the propagator; action {cfg.action!r} "
            "declares none — use Scheme.EM"
        )
    if not float(action.m2) > 0.0:
        raise ValueError(
            "Scheme.EXACT requires a positive Gaussian curvature "
            f"(action.m2 = {float(action.m2)!r}): with m2 <= 0 the free "
            "propagator amplifies the soft modes and the exponential "
            "split is invalid — use Scheme.EM/HEUN for the broken phase"
        )
    if cfg.sweep != Sweep.SYNC:
        raise ValueError("Scheme.EXACT uses the synchronous (SYNC) sweep")
    if cfg.mesh_axes is not None:
        raise ValueError(
            "Scheme.EXACT runs single-program (rfftn over the full "
            "lattice); use mesh_axes=None"
        )


def exact_field_mode_ops(action: FieldAction, cfg: FieldConfig, dtau: torch.Tensor):
    """Per-Fourier-mode exact-OU factors ``(decay, √var, coef)`` on the rfftn
    grid for the per-chain step sizes ``dtau`` (C,), as the JAX package builds
    them: B̂(k) = (2/a²)·Σ_d(1 − cos k_d) + m², decay = e^{−B̂Δτ},
    var = (c²/a^D)(1 − e^{−2B̂Δτ})/B̂ (a massless zero mode gets its diffusive
    limit 2Δτ·c²/a^D) and the ETD1 drift weight coef = (1 − e^{−B̂Δτ})/B̂."""
    shape = tuple(cfg.shape)
    ndim = len(shape)
    dtype, dev = cfg.torch_dtype, dtau.device
    a = cfg.spacing
    rshape = shape[:-1] + (shape[-1] // 2 + 1,)
    bhat = torch.zeros(rshape, dtype=dtype, device=dev)
    for d, n in enumerate(shape):
        freq = np.fft.rfftfreq(n) if d == ndim - 1 else np.fft.fftfreq(n)
        k = (2.0 * np.pi) * torch.from_numpy(freq).to(dtype).to(dev)
        kshape = [1] * ndim
        kshape[d] = rshape[d]
        bhat = bhat + (2.0 / (a * a)) * (1.0 - torch.cos(k.reshape(kshape)))
    bhat = (bhat + torch.tensor(action.m2, dtype=dtype, device=dev))[None]
    c2m = torch.tensor(cfg.noise_amp**2 / a**ndim, dtype=dtype, device=dev)
    dt = dtau.to(dtype).reshape((-1,) + (1,) * ndim)
    decay = torch.exp(-bhat * dt)
    floor = torch.clamp(bhat, min=1e-8)
    svar = torch.where(bhat > 1e-8, c2m * (1.0 - decay * decay) / floor, 2.0 * dt * c2m)
    coef = torch.where(bhat > 1e-8, (1.0 - decay) / floor, dt * torch.ones_like(decay))
    return decay, torch.sqrt(svar), coef


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
    state: FieldState, action: FieldAction, cfg: FieldConfig, chain_offset: int = 0,
    *, philox: bool = False,
) -> FieldFrameSums:
    """One frame of ``cfg.loops`` micro-steps from ``state`` (whose rows are
    global chains ``chain_offset …``).

    Noise comes in groups of consecutive micro-steps counted from the frame's
    first step: pairs sharing one Threefry draw at counter (site, step of the
    first), or with ``philox`` (what the plain versions of kernels 3 and 4
    pass under ``rng_impl='hardware'``) fours sharing one Philox draw; a short
    last group drops its unused normals.  Observables sample the pre-update
    field; a chain whose detector trips (max |det| > lrg_vl, or a non-finite
    update; for the free field under ``Scheme.EXACT`` only the latter) is
    frozen for the rest of the frame.  Returns the frame sums — the plain
    version of CUDA kernel 3.
    """
    check_field_supported(cfg, action)
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
    exact_scheme = cfg.scheme == Scheme.EXACT
    exact_interacting = exact_scheme and not isinstance(action, FreeField)
    if exact_scheme:
        if philox:
            raise ValueError("the Philox stream serves the kernels' scheme (EM) only")
        decay_k, svar_k, coef_k = exact_field_mode_ops(action, cfg, state.dtau)

    def exact_apply(phi, eta):
        """The exact OU transition per Fourier mode, φ ← F⁻¹[decay·Fφ] +
        F⁻¹[√var·Fη], plus for interacting actions the ETD1 correction
        F⁻¹[coef·F[−V′_int(φ)]] with the EM path's clamp and detector on it.
        Returns (new phi, max |det| per chain, bad per chain)."""
        spectral = lambda w, x: torch.fft.irfftn(  # noqa: E731
            w * torch.fft.rfftn(x, dim=lat), s=shape, dim=lat).to(dtype)
        noise = spectral(svar_k, eta)
        lin = spectral(decay_k, phi)
        if not exact_interacting:
            newphi = lin + noise
            bad = ~torch.all(torch.isfinite(newphi).reshape(C, -1), dim=1)
            return newphi, torch.zeros((C,), dtype=dtype, device=dev), bad
        corr = spectral(coef_k, -action.dV_int(phi).to(dtype))
        new_raw = lin + corr + noise
        finite = torch.isfinite(new_raw)
        newphi = torch.where(finite, torch.clamp(new_raw, -clamp, clamp), clamp)
        absdet = torch.where(finite, torch.abs(corr), math.inf)
        return newphi, torch.amax(absdet, dim=lat), ~torch.all(finite.reshape(C, -1), dim=1)

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
        if exact_scheme:
            newphi, max_det, bad = exact_apply(phi, eta)
            tripped = (max_det > lrg) | bad if exact_interacting else bad
        else:
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

    def noise_group(step):
        """The noise fields of the micro-steps from ``step`` on."""
        if philox:
            z = rng.philox_normal_quad_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C,) + shape, chain_offset=chain_offset,
                device=dev,
            )
        else:
            z = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C,) + shape, chain_offset=chain_offset,
                rounds=rounds, device=dev,
            )
        return tuple(e.to(dtype) for e in z)

    zc = torch.zeros((C,), dtype=dtype, device=dev)
    vals = (phi0, zc, zc, zc, zc, zc, zc, torch.zeros_like(state.corr_mean),
            torch.zeros((C,), dtype=torch.bool, device=dev), state.lrg_vl)
    step0 = int(state.step)
    group = rng.PHILOX_STEPS if philox else 2
    for s0 in range(0, cfg.loops, group):
        etas = noise_group(step0 + s0)
        for g in range(min(group, cfg.loops - s0)):
            vals = micro_step(vals, etas[g])
    phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrg = vals
    return FieldFrameSums(phi, ms, m2s, m4s, ams, p2s, acs, cs, lrg, unstable)


def field_frame_epilogue(state: FieldState, sums: FieldFrameSums, cfg: FieldConfig):
    """Accept/reject, running-mean merge and adaptive Δτ for one frame — the
    expressions of the JAX epilogue and of kernel 4's in-kernel one.
    Rejected frames still advance ``step`` (the retry draws fresh noise).
    ``Scheme.EXACT`` on the free field leaves Δτ as it is (the propagator is
    exact at the configured step); interacting ETD1 keeps the controller.
    Returns (new_state, metrics)."""
    accept = ~sums.unstable
    n_new = accum.runs_after(state.runs, cfg.loops).to(state.phi.dtype)

    def merged(mean, frame_sum):
        n = n_new if mean.dim() == 1 else n_new[:, None]
        a = accept if mean.dim() == 1 else accept[:, None]
        return torch.where(a, accum.merge_frame_sum(mean, frame_sum, cfg.loops, n), mean)

    if cfg.scheme == Scheme.EXACT and cfg.action == "free_field":
        dtau = state.dtau
        stab_cnt = torch.where(accept, state.stab_cnt + 1, 0).to(torch.int32)
    else:
        dtau, stab_cnt = accum.adapt_dtau(state.dtau, state.stab_cnt, accept, cfg)
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


def make_field_frame_fn(action: FieldAction, cfg: FieldConfig):
    """Build ``frame(state) -> (state', metrics)``: one frame of ``cfg.loops``
    micro-steps with accept/reject and adaptive Δτ, on the plain path (the
    counterpart of the JAX package's ``make_field_frame_fn``).  A config no
    path runs raises here, before any frame."""
    check_field_supported(cfg, action)

    def frame(state: FieldState):
        return field_frame_epilogue(state, field_frame_sums(state, action, cfg), cfg)

    return frame


def run_field_frames(state: FieldState, action: FieldAction, cfg: FieldConfig,
                     n_frames: int):
    """``n_frames`` frames in plain PyTorch on the state's device, for any
    lattice dimension.  Returns (final_state, metrics) with metrics stacked
    over frames (n_frames, C)."""
    frame = make_field_frame_fn(action, cfg)
    per_frame = []
    for _ in range(n_frames):
        state, m = frame(state)
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
