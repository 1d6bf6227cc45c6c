"""Complex Langevin on periodic D-dimensional scalar-field lattices in plain
PyTorch: the twin of ``stochquant_tpu.integrators.complex_field``.

Model: holomorphic site potential V(z) on a complexified field
z(x) = φ_r(x) + i·φ_i(x), action

    S[z] = Σ_x a^D [ ½ Σ_μ ((z(x+μ̂)−z(x))/a)² + V(z(x)) ],  periodic,

evolved with real noise on the real part:

    z ← z + Δτ_eff·(∇²z − V'(z)) + √(2·Δτ_eff/a^D)·η,   η ~ N(0,1) real,

with the per-micro-step drift-norm control Δτ_eff = Δτ·min(1, d₀/max_x‖drift‖),
frame-level accept/reject with rollback, the adaptive base Δτ, and a runaway
detector on |z|.  Noise: one Box–Muller pair per two micro-steps at counter
(site, step of the first), an odd last micro-step its first output.

Known answer: for the complex Gaussian V = ½σz² the site propagator is

    ⟨z_x²⟩ = (1/(V·a^D)) Σ_k 1/(k̂² + σ),   k̂² = Σ_μ (2−2cos k_μ a)/a²

(:func:`exact_gaussian_z2`, numpy only).  State is split into real and
imaginary float32 tensors on one device, given explicitly; ``step`` is a 0-d
int64 tensor on the host.  No kernel implements this in either package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.actions.complex_actions import ComplexAction
from stochquant_tpu_torch.integrators import accum
from stochquant_tpu_torch.integrators.complex_langevin import _cold, _run, _step_scale
from stochquant_tpu_torch.integrators.langevin import host_step

__all__ = [
    "ComplexFieldConfig",
    "ComplexFieldState",
    "init_cfield_state",
    "make_cfield_frame_fn",
    "run_cfield_frames",
    "reset_cfield_means",
    "exact_gaussian_z2",
]


@dataclasses.dataclass(frozen=True)
class ComplexFieldConfig:
    """Complex-Langevin run on a periodic D-dim lattice (field for field the
    JAX package's, so its JSON is byte-equal)."""

    action: str = "complex_gaussian"
    shape: Tuple[int, ...] = (32, 32)
    spacing: float = 1.0
    n_chains: int = 64
    dtau: float = 1e-3
    loops: int = 100
    frames: int = 100
    seed: int = 0
    noise_amp: float = 1.0
    drift_cap: float = 10.0     # d₀: cap on max-site ‖drift‖·Δτ_eff/Δτ
    clamp: float = 100.0        # |z| beyond this counts as a runaway
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None
    action_params: tuple = ()   # ((name, value), ...) for the registry

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ComplexFieldConfig":
        d = json.loads(s)
        d["shape"] = tuple(d["shape"])
        d["action_params"] = tuple(tuple(p) for p in d.get("action_params", ()))
        return cls(**d)


class ComplexFieldState(NamedTuple):
    """The JAX package's ``ComplexFieldState``, leaf for leaf."""

    zr: torch.Tensor         # (C, *shape) Re z
    zi: torch.Tensor         # (C, *shape) Im z
    z2r_mean: torch.Tensor   # (C,) running Re⟨z²⟩ (site-averaged)
    z2i_mean: torch.Tensor   # (C,) running Im⟨z²⟩
    zim_mean: torch.Tensor   # (C,) running ⟨|Im z|⟩, the CL health metric
    drift_max: torch.Tensor  # (C,) max site ‖drift‖ seen this run
    runs: torch.Tensor       # (C, 2) int64 (lo, hi) uint32 words
    dtau: torch.Tensor       # (C,)
    stab_cnt: torch.Tensor   # (C,) int32
    step: torch.Tensor       # () int64 on the host


def init_cfield_state(cfg: ComplexFieldConfig, *, device) -> ComplexFieldState:
    C = cfg.n_chains
    shape = (C,) + tuple(cfg.shape)
    zeros = torch.zeros((C,), dtype=torch.float32, device=device)
    return ComplexFieldState(
        zr=_cold(cfg.seed, shape, cfg.dtau, device),
        zi=torch.zeros(shape, dtype=torch.float32, device=device),
        z2r_mean=zeros,
        z2i_mean=zeros.clone(),
        zim_mean=zeros.clone(),
        drift_max=zeros.clone(),
        runs=accum.init_runs(C, device=device),
        dtau=torch.full((C,), cfg.dtau, dtype=torch.float32, device=device),
        stab_cnt=torch.zeros((C,), dtype=torch.int32, device=device),
        step=host_step(1),
    )


def make_cfield_frame_fn(action: ComplexAction, cfg: ComplexFieldConfig):
    """The frame function state → (state, metrics) of the field."""
    C = cfg.n_chains
    shape = tuple(cfg.shape)
    ndim = len(shape)
    a = cfg.spacing
    measure = a**ndim
    inv_a2 = float(np.float32(1.0 / (a * a)))
    c_amp = float(np.float32(cfg.noise_amp))
    cap = float(np.float32(cfg.drift_cap))
    clamp = float(np.float32(cfg.clamp))
    lat = tuple(range(1, ndim + 1))
    col = (C,) + (1,) * ndim

    def lap(z):
        """Periodic Laplacian, the dims summed in ascending order."""
        out = torch.zeros_like(z)
        for d in lat:
            out = out + (torch.roll(z, 1, d) + torch.roll(z, -1, d) - 2.0 * z)
        return out * inv_a2

    def substep(vals, eta, dtau):
        zr, zi, z2r, z2i, zim, dmax, unstable = vals
        dsr, dsi = action.dS(zr, zi)  # holomorphic site-potential derivative V'(z)
        drift_r = lap(zr) - dsr
        drift_i = lap(zi) - dsi
        dnorm = torch.amax(torch.sqrt(drift_r * drift_r + drift_i * drift_i), dim=lat)
        dtau_eff = (dtau * _step_scale(dnorm, cap)).reshape(col)
        zr2 = zr + dtau_eff * drift_r + c_amp * torch.sqrt(
            true_divide(2.0 * dtau_eff, measure)) * eta
        zi2 = zi + dtau_eff * drift_i
        mod = torch.sqrt(zr2 * zr2 + zi2 * zi2)
        bad = torch.any((~torch.isfinite(mod) | (mod > clamp)).reshape(C, -1), dim=1)
        # holomorphic observables of the pre-update field, site-averaged (frame sums)
        re_z2 = torch.mean(zr * zr - zi * zi, dim=lat)
        im_z2 = torch.mean(2.0 * zr * zi, dim=lat)
        abs_zi = torch.mean(torch.abs(zi), dim=lat)
        u = unstable.reshape(col)
        return (
            torch.where(u, zr, zr2),
            torch.where(u, zi, zi2),
            torch.where(unstable, z2r, z2r + re_z2),
            torch.where(unstable, z2i, z2i + im_z2),
            torch.where(unstable, zim, zim + abs_zi),
            torch.where(unstable, dmax, torch.maximum(dmax, dnorm)),
            unstable | bad,
        )

    def frame(state: ComplexFieldState):
        dev = state.zr.device
        zc = torch.zeros_like(state.z2r_mean)
        vals = (state.zr, state.zi, zc, zc, zc, state.drift_max,
                torch.zeros((C,), dtype=torch.bool, device=dev))
        step0 = int(state.step)
        for k in range(0, cfg.loops, 2):
            e0, e1 = rng.normal_pair_for_shape(cfg.seed, rng.Stream.FIELD, step0 + k,
                                               (C,) + shape, device=dev)
            vals = substep(vals, e0, state.dtau)
            if k + 1 < cfg.loops:
                vals = substep(vals, e1, state.dtau)
        zr, zi, z2r, z2i, zim, dmax, unstable = vals

        n_new = accum.runs_after(state.runs, cfg.loops)
        accept = ~unstable
        au = accept.reshape(col)

        def merged(mean, frame_sum):
            return torch.where(accept, accum.merge_frame_sum(mean, frame_sum, cfg.loops, n_new),
                               mean)

        dtau, stab_cnt = accum.adapt_dtau(state.dtau, state.stab_cnt, accept, cfg)
        new_state = ComplexFieldState(
            zr=torch.where(au, zr, state.zr),
            zi=torch.where(au, zi, state.zi),
            z2r_mean=merged(state.z2r_mean, z2r),
            z2i_mean=merged(state.z2i_mean, z2i),
            zim_mean=merged(state.zim_mean, zim),
            drift_max=torch.where(accept, dmax, state.drift_max),
            runs=accum.bump_runs(state.runs, cfg.loops, accept),
            dtau=dtau,
            stab_cnt=stab_cnt,
            step=host_step(step0 + cfg.loops),
        )
        return new_state, {"stable": accept, "dtau": dtau, "drift_max": dmax}

    return frame


def run_cfield_frames(state: ComplexFieldState, action: ComplexAction, cfg: ComplexFieldConfig,
                      n_frames: int):
    """``n_frames`` frames on the state's device; metrics stacked (n_frames, C)."""
    return _run(make_cfield_frame_fn(action, cfg), state, n_frames)


def reset_cfield_means(state: ComplexFieldState) -> ComplexFieldState:
    z = torch.zeros_like(state.z2r_mean)
    return state._replace(z2r_mean=z, z2i_mean=z.clone(), zim_mean=z.clone(),
                          runs=torch.zeros_like(state.runs))


def exact_gaussian_z2(shape, spacing, sigma) -> complex:
    """Exact site propagator ⟨z_x²⟩ of the complex free field:
    (1/(V·a^D))·Σ_k 1/(k̂² + σ)."""
    khat2 = np.zeros(shape)
    for d, L in enumerate(shape):
        k = 2.0 * np.pi * np.arange(L) / L
        kh = (2.0 - 2.0 * np.cos(k)) / spacing**2
        sh = [1] * len(shape)
        sh[d] = L
        khat2 = khat2 + kh.reshape(sh)
    return complex(np.mean(1.0 / (khat2 + sigma)) / spacing ** len(shape))
