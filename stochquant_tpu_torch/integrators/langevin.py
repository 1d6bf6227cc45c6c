"""Langevin chains in plain PyTorch: the twin of
``stochquant_tpu.integrators.langevin`` (EM and Heun schemes).

Update (interior site, background formulation):

    f_i += Δτ·[ m·(f_{i+1}+f_{i−1}−2f_i)/Δt² − V''(x_cl(t_i,ω))·f_i ]
           + c·√(2Δτ/Δt)·η_i

and in the direct formulation the linearized force is replaced by −V'(x_i).

A frame is ``cfg.loops`` micro-steps (:func:`frame_sums`, the semantics of
CUDA kernel 1) followed by the accept/reject, running-mean merge and
adaptive-Δτ epilogue (:func:`frame_epilogue`, which kernel 2 also runs
in-kernel).  Every expression keeps the JAX package's operand order, and the
noise is the same counter-based Threefry stream, so trajectories agree with
the JAX package to float32 rounding of the transcendentals.

State lives on one device, given explicitly; ``step`` is the exception: the
micro-step counter is a 0-d int64 tensor on the host (a uint32 value), so
launching a frame never waits on the device to learn its noise counters.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import QMAction, true_divide
from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, Formulation, Scheme
from stochquant_tpu_torch.integrators import accum

__all__ = [
    "ChainState",
    "FrameSums",
    "init_chain_state",
    "check_supported",
    "frame_sums",
    "frame_epilogue",
    "run_frames",
    "connected_correlator",
    "reset_means",
]


class ChainState(NamedTuple):
    """Full resumable state of a batch of Langevin chains (the JAX
    package's ``ChainState``, leaf for leaf)."""

    f: torch.Tensor          # (C, N) float32 field (fluctuation in BACKGROUND mode)
    omega: torch.Tensor      # (C,)  collective coordinate (kink center)
    x_mean: torch.Tensor     # (C, N) running ⟨x_i⟩
    xx0_mean: torch.Tensor   # (C, N) running ⟨x_i·x_mid⟩
    x2_mean: torch.Tensor    # (C, N) running ⟨x_i²⟩
    x4_mean: torch.Tensor    # (C, N) running ⟨x_i⁴⟩
    runs: torch.Tensor       # (C, 2) int64 (lo, hi) uint32 words of the sample count
    dtau: torch.Tensor       # (C,)  current Langevin step size
    stab_cnt: torch.Tensor   # (C,)  int32 consecutive stable frames
    lrg_vl: torch.Tensor     # (C,)  running max |x| (divergence threshold)
    spec_mean: torch.Tensor  # (C, N//2+1) power spectrum (zeros: not ported)
    step: torch.Tensor       # ()    int64 on the host: uint32 micro-step counter


class FrameSums(NamedTuple):
    """What one frame of micro-steps returns (CUDA kernel 1's outputs)."""

    f: torch.Tensor         # (C, N)
    omega: torch.Tensor     # (C,)
    xs: torch.Tensor        # (C, N) frame Σ x
    xxs: torch.Tensor       # (C, N) frame Σ x·x_mid
    x2s: torch.Tensor       # (C, N) frame Σ x²
    x4s: torch.Tensor       # (C, N) frame Σ x⁴
    lrg_vl: torch.Tensor    # (C,)
    unstable: torch.Tensor  # (C,) bool


def host_step(value: int) -> torch.Tensor:
    """The micro-step counter as stored in ``ChainState.step``."""
    return torch.tensor(rng.u32(int(value)), dtype=torch.int64)


def check_supported(cfg: ChainConfig) -> None:
    """Raise for the chain features that are not ported yet."""
    if cfg.scheme in (Scheme.LM, Scheme.EXACT):
        raise ValueError(
            f"Scheme.{cfg.scheme.name} is not ported yet (EM and HEUN are)"
        )
    if cfg.accumulate_spectrum:
        raise ValueError("accumulate_spectrum (the power-spectrum channel) is not ported yet")
    rng.rounds_of(cfg.rng_impl)  # raises for rng_impl='hardware'


def frame_constants(action: QMAction, cfg: ChainConfig) -> dict:
    """Float32 constants of the micro-step, folded as the JAX package folds
    them (Python doubles rounded once; products of float32 constants taken
    in float32).  Shared by the twin and the CUDA kernels' parameters."""
    f32 = np.float32
    N, dt = cfg.n_sites, cfg.dt
    if cfg.ghost_override is not None:
        asym_l, asym_r = cfg.ghost_override
    else:
        asym_l, asym_r = action.boundary_asymptote(-1), action.boundary_asymptote(+1)
    background = cfg.formulation == Formulation.BACKGROUND
    return dict(
        dt=f32(dt),
        inv_dt2=f32(action.mass / (dt * dt)),
        c_amp=f32(cfg.noise_amp),
        zm_c=f32(action.zero_mode_const()) * f32(cfg.noise_amp),
        clamp=f32(cfg.clamp),
        upper=f32((N - 1) * dt),
        asym_l=f32(asym_l),
        asym_r=f32(asym_r),
        background=background,
        has_zm=background and action.has_zero_mode and cfg.parisi,
        heun=cfg.scheme == Scheme.HEUN,
    )


def _reflect(om, upper):
    """Reflect the collective coordinate into [0, upper]."""
    om = torch.where(om > upper, 2.0 * upper - om, om)
    return torch.where(om < 0, -om, om)


def init_chain_state(cfg: ChainConfig, action: QMAction, *, device) -> ChainState:
    """Cold start: field seeded with N(0, √(2Δτ)) noise (step 0); ω at the
    lattice midpoint plus √Δt noise (step 1), reflected into [0, (N−1)Δt];
    ``lrg_vl`` seeded with the initial max |x|; ``step = 2``."""
    check_supported(cfg)
    C, N = cfg.n_chains, cfg.n_sites
    dtype = cfg.torch_dtype
    R = rng.rounds_of(cfg.rng_impl)
    z = rng.normal_for_shape(cfg.seed, rng.Stream.INIT, 0, (C, N), rounds=R, device=device)
    f = torch.sqrt(torch.tensor(2.0 * cfg.dtau, dtype=dtype, device=device)) * z.to(dtype)
    chain_ids = torch.arange(C, dtype=torch.int64, device=device)
    z_om = rng.normal(cfg.seed, rng.Stream.INIT, chain_ids, 0, 1, R)
    omega = 0.5 * N * cfg.dt + math.sqrt(cfg.dt) * z_om.to(dtype)
    omega = _reflect(omega, (N - 1) * cfg.dt)
    zeros = torch.zeros((C, N), dtype=dtype, device=device)
    if cfg.formulation == Formulation.BACKGROUND:
        t_grid = torch.arange(N, dtype=dtype, device=device) * cfg.dt
        x0 = f + action.x_cl(t_grid[None, :], omega[:, None]).to(dtype)
    else:
        x0 = f
    return ChainState(
        f=f,
        omega=omega,
        x_mean=zeros,
        xx0_mean=zeros.clone(),
        x2_mean=zeros.clone(),
        x4_mean=zeros.clone(),
        runs=accum.init_runs(C, device=device),
        dtau=torch.full((C,), cfg.dtau, dtype=dtype, device=device),
        stab_cnt=torch.zeros((C,), dtype=torch.int32, device=device),
        lrg_vl=torch.amax(torch.abs(x0), dim=-1),
        spec_mean=torch.zeros((C, N // 2 + 1), dtype=dtype, device=device),
        step=host_step(2),
    )


def frame_sums(
    state: ChainState, action: QMAction, cfg: ChainConfig, chain_offset: int = 0
) -> FrameSums:
    """One frame of ``cfg.loops`` micro-steps from ``state`` (whose rows are
    global chains ``chain_offset …``), in pairs that share one Threefry draw.

    Observables sample the pre-update field; a chain whose detector trips
    (max |det| > lrg_vl, or a non-finite update) is frozen for the rest of
    the frame.  Returns the frame sums — the plain version of CUDA kernel 1.
    """
    check_supported(cfg)
    k = frame_constants(action, cfg)
    C, N = state.f.shape
    dev, dtype = state.f.device, state.f.dtype
    mid = N // 2
    rounds = rng.rounds_of(cfg.rng_impl)
    background, has_zm, bc = k["background"], k["has_zm"], cfg.bc
    t_grid = torch.arange(N, dtype=dtype, device=dev) * float(k["dt"])
    dtau = state.dtau[:, None]
    noise_amp = float(k["c_amp"]) * torch.sqrt(true_divide(2.0 * dtau, float(k["dt"])))
    om_amp = float(k["zm_c"]) * torch.sqrt(2.0 * state.dtau)
    inv_dt2, clamp, upper = float(k["inv_dt2"]), float(k["clamp"]), float(k["upper"])
    t_ghost = torch.tensor([-cfg.dt, N * cfg.dt], dtype=dtype, device=dev)
    chain_ids = rng.u32(torch.arange(C, dtype=torch.int64, device=dev) + chain_offset)
    k1_om = rng.chain_key(rng.Stream.COLLECTIVE, chain_ids)
    zero_ids = torch.zeros_like(chain_ids)

    def ghosts(om):
        if bc != BoundaryCondition.FIXED_BG:
            return None
        if background:
            g = action.x_cl(t_ghost[None, :], om[:, None]).to(dtype)
            return float(k["asym_l"]) - g[:, 0:1], float(k["asym_r"]) - g[:, 1:2]
        return (torch.full((C, 1), float(k["asym_l"]), dtype=dtype, device=dev),
                torch.full((C, 1), float(k["asym_r"]), dtype=dtype, device=dev))

    def neighbor_sum(ff, gh):
        if bc == BoundaryCondition.PERIODIC:
            return torch.roll(ff, 1, dims=-1) + torch.roll(ff, -1, dims=-1)
        if gh is None:
            zero = torch.zeros((C, 1), dtype=dtype, device=dev)
            gh = (zero, zero)
        up = torch.cat([ff[:, 1:], gh[1]], dim=-1)
        down = torch.cat([gh[0], ff[:, :-1]], dim=-1)
        return up + down

    def substep(vals, eta, eta_om):
        f, om, xs, xxs, x2s, x4s, lrg, unstable = vals
        noise = noise_amp * eta
        if background:
            bg = action.x_cl(t_grid[None, :], om[:, None]).to(dtype)
            ddv_bg = action.ddV(bg).to(dtype)
        gh = ghosts(om)

        def drift(ff):
            lap = (neighbor_sum(ff, gh) - 2.0 * ff) * inv_dt2
            if background:
                return lap - ddv_bg * ff
            return lap - action.dV(ff).to(dtype)

        if k["heun"]:
            f1 = drift(f)
            f_pred = f + dtau * f1 + noise
            det = 0.5 * dtau * (f1 + drift(f_pred))
        else:
            det = drift(f) * dtau
        new_raw = f + det + noise
        finite = torch.isfinite(new_raw)
        newf = torch.where(finite, torch.clamp(new_raw, -clamp, clamp), clamp)
        if bc == BoundaryCondition.DIRICHLET:
            newf[:, 0] = 0.0
            newf[:, -1] = 0.0

        absdet = torch.where(finite, torch.abs(det), math.inf)
        tripped = torch.amax(absdet, dim=-1) > lrg

        x = f + bg if background else f
        x_new = newf + bg if background else newf
        x2 = x * x
        xs2 = xs + x
        xxs2 = xxs + x * x[:, mid:mid + 1]
        x2s2 = x2s + x2
        x4s2 = x4s + x2 * x2
        lrg2 = torch.maximum(lrg, torch.amax(torch.abs(x_new), dim=-1))
        om2 = _reflect(om + om_amp * eta_om, upper) if has_zm else om

        u = unstable[:, None]
        return (
            torch.where(u, f, newf),
            torch.where(unstable, om, om2),
            torch.where(u, xs, xs2),
            torch.where(u, xxs, xxs2),
            torch.where(u, x2s, x2s2),
            torch.where(u, x4s, x4s2),
            torch.where(unstable, lrg, lrg2),
            unstable | tripped,
        )

    def noise_pair(step):
        e0, e1 = rng.normal_pair_for_shape(
            cfg.seed, rng.Stream.FIELD, step, (C, N), chain_offset=chain_offset,
            rounds=rounds, device=dev,
        )
        if not has_zm:
            return e0, e1, None, None
        o0, o1 = rng.normal_pair(cfg.seed, k1_om, zero_ids, rng.u32(step), rounds)
        return e0, e1, o0, o1

    zsum = torch.zeros_like(state.f)
    vals = (state.f, state.omega, zsum, zsum, zsum, zsum, state.lrg_vl,
            torch.zeros((C,), dtype=torch.bool, device=dev))
    step0 = int(state.step)
    for p in range(cfg.loops // 2):
        e0, e1, o0, o1 = noise_pair(step0 + 2 * p)
        vals = substep(vals, e0, o0)
        vals = substep(vals, e1, o1)
    if cfg.loops % 2:
        e0, _, o0, _ = noise_pair(step0 + cfg.loops - 1)
        vals = substep(vals, e0, o0)
    return FrameSums(*vals)


def frame_epilogue(state: ChainState, sums: FrameSums, cfg: ChainConfig):
    """Accept/reject, running-mean merge and adaptive Δτ for one frame —
    the expressions of the JAX epilogue and of kernel 2's in-kernel one.
    Rejected frames still advance ``step`` (the retry draws fresh noise).
    Returns (new_state, metrics)."""
    accept = ~sums.unstable
    a1 = accept[:, None]
    n_new = accum.runs_after(state.runs, cfg.loops)[:, None]

    def merged(mean, frame_sum):
        return torch.where(a1, accum.merge_frame_sum(mean, frame_sum, cfg.loops, n_new), mean)

    grow = accept & (state.stab_cnt >= cfg.grow_after)
    dtau = torch.where(
        grow,
        true_divide(state.dtau, cfg.shrink),
        torch.where(accept, state.dtau, state.dtau * cfg.shrink),
    )
    if cfg.dtau_max is not None:
        dtau = torch.clamp(dtau, max=float(np.float32(cfg.dtau_max)))
    stab_cnt = torch.where(
        accept, torch.where(grow, 0, state.stab_cnt + 1), 0
    ).to(torch.int32)
    lrg_vl = torch.where(accept, sums.lrg_vl, state.lrg_vl)
    new_state = ChainState(
        f=torch.where(a1, sums.f, state.f),
        omega=torch.where(accept, sums.omega, state.omega),
        x_mean=merged(state.x_mean, sums.xs),
        xx0_mean=merged(state.xx0_mean, sums.xxs),
        x2_mean=merged(state.x2_mean, sums.x2s),
        x4_mean=merged(state.x4_mean, sums.x4s),
        runs=accum.bump_runs(state.runs, cfg.loops, accept),
        dtau=dtau,
        stab_cnt=stab_cnt,
        lrg_vl=lrg_vl,
        spec_mean=state.spec_mean,
        step=host_step(int(state.step) + cfg.loops),
    )
    return new_state, {"stable": accept, "dtau": dtau, "max_x": lrg_vl}


def stack_metrics(per_frame) -> dict:
    """List of per-frame metric dicts (each (C,)) → dict of (frames, C)."""
    return {key: torch.stack([m[key] for m in per_frame]) for key in per_frame[0]}


def run_frames(state: ChainState, action: QMAction, cfg: ChainConfig, n_frames: int):
    """``n_frames`` macro-steps in plain PyTorch on the state's device.

    Returns (final_state, metrics) with metrics stacked over frames (n_frames, C).
    """
    per_frame = []
    for _ in range(n_frames):
        state, m = frame_epilogue(state, frame_sums(state, action, cfg), cfg)
        per_frame.append(m)
    return state, stack_metrics(per_frame)


def connected_correlator(state: ChainState) -> torch.Tensor:
    """C_i = ⟨x_i·x_mid⟩ − ⟨x_i⟩·⟨x_mid⟩ per chain."""
    mid = state.x_mean.shape[-1] // 2
    return state.xx0_mean - state.x_mean * state.x_mean[:, mid:mid + 1]


def reset_means(state: ChainState) -> ChainState:
    """Zero the running observables (after thermalization burn-in)."""
    z = torch.zeros_like(state.x_mean)
    return state._replace(
        x_mean=z,
        xx0_mean=z.clone(),
        x2_mean=z.clone(),
        x4_mean=z.clone(),
        spec_mean=torch.zeros_like(state.spec_mean),
        runs=torch.zeros_like(state.runs),
    )
