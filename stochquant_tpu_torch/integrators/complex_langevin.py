"""Complex Langevin for complex-action models in plain PyTorch: the twin of
``stochquant_tpu.integrators.complex_langevin`` (the 0-D ensemble and the
1-D chain).

For a holomorphic action S(z) the CL update complexifies the variable
z = x + iy and evolves

    z ← z − Δτ_eff·∂S/∂z + √(2·Δτ_eff)·η,   η real N(0,1),

whose stationary expectation values of holomorphic observables reproduce
the complex-weight averages ∫O·e^{−S} (when the process stays bounded), with

* per-step drift-norm control: Δτ_eff = Δτ·min(1, d₀/‖∂S‖);
* frame-level accept/reject and the adaptive base Δτ of the real frames
  (``accum.adapt_dtau``), and the two-level running means (``accum``).

The 0-D ensemble draws one normal per chain and micro-step at counter
(site 0, step), a frame's worth in one call; the chain draws one Box–Muller
pair per two micro-steps at counter (site, step of the first), an odd last
micro-step its first output.
Both start at ``step = 1`` from z = √(2Δτ)·N(0,1) at (INIT, step 0).

State is split into real and imaginary float32 tensors on one device, given
explicitly; ``step`` is a 0-d int64 tensor on the host holding a uint32
value, as in the real integrators.  No kernel implements complex Langevin in
either package: this is the whole path.
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.actions.complex_actions import ComplexAction
from stochquant_tpu_torch.integrators import accum
from stochquant_tpu_torch.integrators.langevin import host_step, stack_metrics

__all__ = [
    "ComplexLangevinConfig",
    "CLState",
    "init_cl_state",
    "make_cl_frame_fn",
    "run_cl_frames",
    "reset_cl_means",
    "ComplexChainConfig",
    "ComplexChainState",
    "init_ccl_state",
    "make_ccl_frame_fn",
    "run_ccl_frames",
    "reset_ccl_means",
    "z2_estimate",
]


@dataclasses.dataclass(frozen=True)
class ComplexLangevinConfig:
    """0-D complex-Langevin ensemble (field for field the JAX package's, so
    its JSON is byte-equal)."""

    action: str = "complex_gaussian"
    n_chains: int = 1024
    dtau: float = 1e-3
    loops: int = 100
    frames: int = 100
    seed: int = 0
    noise_amp: float = 1.0
    drift_cap: float = 10.0     # d₀: |drift|·Δτ above this rescales the step
    clamp: float = 100.0        # |z| excursion treated as a runaway
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None
    action_params: tuple = ()   # ((name, value), ...) for the registry

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ComplexLangevinConfig":
        d = json.loads(s)
        d["action_params"] = tuple(tuple(p) for p in d.get("action_params", ()))
        return cls(**d)


class CLState(NamedTuple):
    """0-D ensemble state (the JAX package's ``CLState``, leaf for leaf)."""

    zr: torch.Tensor         # (C,) Re z
    zi: torch.Tensor         # (C,) Im z
    z2r_mean: torch.Tensor   # (C,) running Re⟨z²⟩
    z2i_mean: torch.Tensor   # (C,) running Im⟨z²⟩
    zr_mean: torch.Tensor    # (C,) running Re⟨z⟩
    zi_mean: torch.Tensor    # (C,) running Im⟨z⟩
    drift_max: torch.Tensor  # (C,) max |∂S| seen this run
    runs: torch.Tensor       # (C, 2) int64 (lo, hi) uint32 words of the sample count
    dtau: torch.Tensor       # (C,)
    stab_cnt: torch.Tensor   # (C,) int32
    step: torch.Tensor       # () int64 on the host: uint32 micro-step counter


def _cold(seed, shape, dtau, device):
    """z = √(2Δτ)·N(0,1) from the INIT stream at step 0."""
    z = rng.normal_for_shape(seed, rng.Stream.INIT, 0, shape, device=device)
    return torch.sqrt(torch.tensor(2.0 * dtau, dtype=torch.float32, device=device)) * z


def _step_scale(dnorm, cap: float):
    """min(1, d₀ / max(‖drift‖, 1e-30))."""
    one = torch.ones((), dtype=torch.float32, device=dnorm.device)
    tiny = torch.full((), 1e-30, dtype=torch.float32, device=dnorm.device)
    return torch.minimum(one, true_divide(cap, torch.maximum(dnorm, tiny)))


def init_cl_state(cfg: ComplexLangevinConfig, *, device) -> CLState:
    C = cfg.n_chains
    zeros = torch.zeros((C,), dtype=torch.float32, device=device)
    return CLState(
        zr=_cold(cfg.seed, (C, 1), cfg.dtau, device)[:, 0],
        zi=zeros,
        z2r_mean=zeros.clone(),
        z2i_mean=zeros.clone(),
        zr_mean=zeros.clone(),
        zi_mean=zeros.clone(),
        drift_max=zeros.clone(),
        runs=accum.init_runs(C, device=device),
        dtau=torch.full((C,), cfg.dtau, dtype=torch.float32, device=device),
        stab_cnt=torch.zeros((C,), dtype=torch.int32, device=device),
        step=host_step(1),
    )


def make_cl_frame_fn(action: ComplexAction, cfg: ComplexLangevinConfig):
    """The frame function state → (state, metrics) of the 0-D ensemble."""
    C = cfg.n_chains
    c_amp = float(np.float32(cfg.noise_amp))
    cap = float(np.float32(cfg.drift_cap))
    clamp = float(np.float32(cfg.clamp))

    def frame(state: CLState):
        dev = state.zr.device
        chain_ids = torch.arange(C, dtype=torch.int64, device=dev)
        zr, zi, dmax = state.zr, state.zi, state.drift_max
        z2r = z2i = zrm = zim = torch.zeros_like(state.z2r_mean)
        unstable = torch.zeros((C,), dtype=torch.bool, device=dev)
        step0 = int(state.step)
        # the frame's noise in one draw: row k is micro-step step0 + k, counter (site 0, step)
        steps = torch.arange(step0, step0 + cfg.loops, dtype=torch.int64, device=dev)
        etas = rng.normal(cfg.seed, rng.Stream.FIELD, chain_ids[None, :], 0, steps[:, None])
        for k in range(cfg.loops):
            dsr, dsi = action.dS(zr, zi)
            dnorm = torch.sqrt(dsr * dsr + dsi * dsi)
            # drift-norm step control: keep |drift|·Δτ_eff ≤ drift_cap·Δτ
            dtau_eff = state.dtau * _step_scale(dnorm, cap)
            amp = c_amp * torch.sqrt(2.0 * dtau_eff)
            zr2 = zr - dtau_eff * dsr + amp * etas[k]
            zi2 = zi - dtau_eff * dsi
            bad = (~torch.isfinite(zr2) | ~torch.isfinite(zi2)
                   | (torch.sqrt(zr2 * zr2 + zi2 * zi2) > clamp))
            # holomorphic observables of the pre-update variable (frame sums)
            re_z2 = zr * zr - zi * zi
            im_z2 = 2.0 * zr * zi
            z2r = torch.where(unstable, z2r, z2r + re_z2)
            z2i = torch.where(unstable, z2i, z2i + im_z2)
            zrm = torch.where(unstable, zrm, zrm + zr)
            zim = torch.where(unstable, zim, zim + zi)
            dmax = torch.where(unstable, dmax, torch.maximum(dmax, dnorm))
            zr = torch.where(unstable, zr, zr2)
            zi = torch.where(unstable, zi, zi2)
            unstable = unstable | bad

        n_new = accum.runs_after(state.runs, cfg.loops)
        accept = ~unstable

        def merged(mean, frame_sum):
            return torch.where(accept, accum.merge_frame_sum(mean, frame_sum, cfg.loops, n_new),
                               mean)

        dtau, stab_cnt = accum.adapt_dtau(state.dtau, state.stab_cnt, accept, cfg)
        new_state = CLState(
            zr=torch.where(accept, zr, state.zr),
            zi=torch.where(accept, zi, state.zi),
            z2r_mean=merged(state.z2r_mean, z2r),
            z2i_mean=merged(state.z2i_mean, z2i),
            zr_mean=merged(state.zr_mean, zrm),
            zi_mean=merged(state.zi_mean, zim),
            drift_max=torch.where(accept, dmax, state.drift_max),
            runs=accum.bump_runs(state.runs, cfg.loops, accept),
            dtau=dtau,
            stab_cnt=stab_cnt,
            step=host_step(step0 + cfg.loops),
        )
        return new_state, {"stable": accept, "dtau": dtau, "drift_max": dmax}

    return frame


def _run(frame, state, n_frames: int):
    per_frame = []
    for _ in range(n_frames):
        state, m = frame(state)
        per_frame.append(m)
    return state, stack_metrics(per_frame)


def run_cl_frames(state: CLState, action: ComplexAction, cfg: ComplexLangevinConfig,
                  n_frames: int):
    """``n_frames`` frames on the state's device; metrics stacked (n_frames, C)."""
    return _run(make_cl_frame_fn(action, cfg), state, n_frames)


def reset_cl_means(state: CLState) -> CLState:
    z = torch.zeros_like(state.z2r_mean)
    return state._replace(z2r_mean=z, z2i_mean=z.clone(), zr_mean=z.clone(),
                          zi_mean=z.clone(), runs=torch.zeros_like(state.runs))


@dataclasses.dataclass(frozen=True)
class ComplexChainConfig:
    """Complex Langevin for a 1-D Euclidean-time chain with a holomorphic site
    potential: S = Σ_i Δt[(m/2)((z_{i+1}−z_i)/Δt)² + V(z_i)], periodic.  The
    complexified field evolves with drift m∇²z/Δt² − V'(z) and real noise
    √(2Δτ/Δt)·η on the real part."""

    action: str = "complex_gaussian"
    n_sites: int = 32
    dt: float = 0.25
    mass: float = 1.0
    n_chains: int = 256
    dtau: float = 1e-3
    loops: int = 100
    frames: int = 100
    seed: int = 0
    noise_amp: float = 1.0
    drift_cap: float = 10.0
    clamp: float = 100.0
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ComplexChainConfig":
        return cls(**json.loads(s))


class ComplexChainState(NamedTuple):
    """1-D chain state (the JAX package's ``ComplexChainState``)."""

    zr: torch.Tensor         # (C, N)
    zi: torch.Tensor         # (C, N)
    z2r_mean: torch.Tensor   # (C, N) running Re⟨z_i²⟩
    z2i_mean: torch.Tensor   # (C, N) running Im⟨z_i²⟩
    drift_max: torch.Tensor  # (C,)
    runs: torch.Tensor       # (C, 2) int64 (lo, hi) uint32 words
    dtau: torch.Tensor       # (C,)
    stab_cnt: torch.Tensor   # (C,) int32
    step: torch.Tensor       # () int64 on the host


def init_ccl_state(cfg: ComplexChainConfig, *, device) -> ComplexChainState:
    C, N = cfg.n_chains, cfg.n_sites
    zeros = torch.zeros((C, N), dtype=torch.float32, device=device)
    return ComplexChainState(
        zr=_cold(cfg.seed, (C, N), cfg.dtau, device),
        zi=zeros,
        z2r_mean=zeros.clone(),
        z2i_mean=zeros.clone(),
        drift_max=torch.zeros((C,), dtype=torch.float32, device=device),
        runs=accum.init_runs(C, device=device),
        dtau=torch.full((C,), cfg.dtau, dtype=torch.float32, device=device),
        stab_cnt=torch.zeros((C,), dtype=torch.int32, device=device),
        step=host_step(1),
    )


def make_ccl_frame_fn(action: ComplexAction, cfg: ComplexChainConfig):
    """The frame function state → (state, metrics) of the 1-D chain."""
    C, N = cfg.n_chains, cfg.n_sites
    c_amp = float(np.float32(cfg.noise_amp))
    cap = float(np.float32(cfg.drift_cap))
    clamp = float(np.float32(cfg.clamp))
    inv_dt2 = float(np.float32(cfg.mass / (cfg.dt * cfg.dt)))

    def lap(z):
        return (torch.roll(z, 1, -1) + torch.roll(z, -1, -1) - 2.0 * z) * inv_dt2

    def substep(vals, eta, dtau):
        zr, zi, z2r, z2i, dmax, unstable = vals
        dsr, dsi = action.dS(zr, zi)  # holomorphic site-potential derivative
        drift_r = lap(zr) - dsr
        drift_i = lap(zi) - dsi
        dnorm = torch.amax(torch.sqrt(drift_r * drift_r + drift_i * drift_i), dim=-1)  # (C,)
        dtau_eff = (dtau * _step_scale(dnorm, cap))[:, None]
        zr2 = zr + dtau_eff * drift_r + c_amp * torch.sqrt(
            true_divide(2.0 * dtau_eff, cfg.dt)) * eta
        zi2 = zi + dtau_eff * drift_i
        mod = torch.sqrt(zr2 * zr2 + zi2 * zi2)
        bad = torch.any(~torch.isfinite(mod) | (mod > clamp), dim=-1)
        # frame sums of the pre-update field
        re_z2 = zr * zr - zi * zi
        im_z2 = 2.0 * zr * zi
        u = unstable[:, None]
        return (
            torch.where(u, zr, zr2),
            torch.where(u, zi, zi2),
            torch.where(u, z2r, z2r + re_z2),
            torch.where(u, z2i, z2i + im_z2),
            torch.where(unstable, dmax, torch.maximum(dmax, dnorm)),
            unstable | bad,
        )

    def frame(state: ComplexChainState):
        dev = state.zr.device
        zsum = torch.zeros_like(state.z2r_mean)
        vals = (state.zr, state.zi, zsum, zsum, state.drift_max,
                torch.zeros((C,), dtype=torch.bool, device=dev))
        step0 = int(state.step)
        for k in range(0, cfg.loops, 2):
            e0, e1 = rng.normal_pair_for_shape(cfg.seed, rng.Stream.FIELD, step0 + k, (C, N),
                                               device=dev)
            vals = substep(vals, e0, state.dtau)
            if k + 1 < cfg.loops:
                vals = substep(vals, e1, state.dtau)
        zr, zi, z2r, z2i, dmax, unstable = vals

        n_new = accum.runs_after(state.runs, cfg.loops)[:, None]
        accept = ~unstable
        a1 = accept[:, None]
        dtau, stab_cnt = accum.adapt_dtau(state.dtau, state.stab_cnt, accept, cfg)
        new_state = ComplexChainState(
            zr=torch.where(a1, zr, state.zr),
            zi=torch.where(a1, zi, state.zi),
            z2r_mean=torch.where(a1, accum.merge_frame_sum(state.z2r_mean, z2r, cfg.loops,
                                                           n_new), state.z2r_mean),
            z2i_mean=torch.where(a1, accum.merge_frame_sum(state.z2i_mean, z2i, cfg.loops,
                                                           n_new), state.z2i_mean),
            drift_max=torch.where(accept, dmax, state.drift_max),
            runs=accum.bump_runs(state.runs, cfg.loops, accept),
            dtau=dtau,
            stab_cnt=stab_cnt,
            step=host_step(step0 + cfg.loops),
        )
        return new_state, {"stable": accept, "dtau": dtau, "drift_max": dmax}

    return frame


def run_ccl_frames(state: ComplexChainState, action: ComplexAction, cfg: ComplexChainConfig,
                   n_frames: int):
    """``n_frames`` chain frames on the state's device; metrics (n_frames, C)."""
    return _run(make_ccl_frame_fn(action, cfg), state, n_frames)


def reset_ccl_means(state: ComplexChainState) -> ComplexChainState:
    z = torch.zeros_like(state.z2r_mean)
    return state._replace(z2r_mean=z, z2i_mean=z.clone(), runs=torch.zeros_like(state.runs))


def z2_estimate(state) -> complex:
    """Ensemble ⟨z²⟩ as a complex number (the mean over every chain and site,
    as numpy takes it)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return complex(host(state.z2r_mean).mean(), host(state.z2i_mean).mean())
