"""Langevin chains in plain PyTorch: the twin of
``stochquant_tpu.integrators.langevin`` (the EM, Heun, LM and exact-OU
schemes and the power-spectrum channel).

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

``Scheme.LM`` (noise (ξ_k + ξ_{k+1})/2), ``Scheme.EXACT`` (the exact
Ornstein–Uhlenbeck transition of the frozen linearized drift, two dense
(C,N)·(N,N) products per micro-step through ``torch.matmul`` in full
float32) and ``cfg.accumulate_spectrum`` (|rfft x|² per micro-step through
``torch.fft``) are plain-path features here as in the JAX package: no kernel
implements them.

``rng_impl='hardware'``: :func:`frame_sums` draws the Philox-4x32-10 stream
(``rng.philox_normal_quad``) only when its caller asks with ``philox=True``,
which the kernel wrappers' plain versions do; :func:`run_frames` never does
and draws Threefry-20 under that setting, as the JAX package's XLA path does.

State lives on one device, given explicitly; ``step`` is the exception: the
micro-step counter is a 0-d int64 tensor on the host (a uint32 value), so
launching a frame never waits on the device to learn its noise counters.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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
    "exact_propagator_ops",
    "frame_sums",
    "frame_epilogue",
    "make_frame_fn",
    "run_frames",
    "connected_correlator",
    "translation_averaged_correlator",
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
    spec_mean: torch.Tensor  # (C, N//2+1) running ⟨|x̂_k|²⟩ power spectrum
                             # (zeros unless cfg.accumulate_spectrum)
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
    specs: Optional[torch.Tensor] = None  # (C, N//2+1) frame Σ |x̂|², with
                                          # cfg.accumulate_spectrum (plain path only)


def host_step(value: int) -> torch.Tensor:
    """The micro-step counter as stored in ``ChainState.step``."""
    return torch.tensor(rng.u32(int(value)), dtype=torch.int64)


def plain_path_only(cfg: ChainConfig) -> Optional[str]:
    """Why no chain kernel covers ``cfg`` (in either package), or None."""
    if cfg.accumulate_spectrum:
        return "the power spectrum needs an FFT per micro-step, which no chain kernel has"
    if cfg.scheme in (Scheme.LM, Scheme.EXACT):
        return f"no chain kernel implements Scheme.{cfg.scheme.name} (EM and HEUN only)"
    return None


def check_supported(cfg: ChainConfig, action: Optional[QMAction] = None) -> None:
    """Raise for a chain config no path runs: an odd ``loops`` under
    ``Scheme.LM``, or (given the action) ``Scheme.EXACT`` on a drift that is
    not linear and frozen."""
    if cfg.scheme == Scheme.LM and cfg.loops % 2:
        raise ValueError("Scheme.LM requires an even cfg.loops")
    if cfg.scheme == Scheme.EXACT and action is not None:
        _exact_scheme_check(action, cfg)


def _exact_scheme_check(action: QMAction, cfg: ChainConfig) -> None:
    background = cfg.formulation == Formulation.BACKGROUND
    has_zm = background and action.has_zero_mode and cfg.parisi
    if not background or has_zm:
        raise ValueError(
            "Scheme.EXACT integrates the linearized (BACKGROUND) drift "
            "exactly and needs it frozen: use formulation=BACKGROUND with "
            "parisi=False (or an action without a zero mode)"
        )


def _full_precision_matmul() -> None:
    """The propagator products are exact float32: TF32 (about three decimal
    digits) would put back the integration bias Scheme.EXACT removes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact_propagator_ops(action: QMAction, cfg: ChainConfig, omega, dtau=None):
    """Per-chain exact-OU step operators ``(P, S, mu)`` of ``Scheme.EXACT``
    for the linearized drift at frozen ω, as the JAX package builds them.

    The BACKGROUND micro-step integrates df/dτ = −B f + s + √(2/Δt)·c·ξ with
    the per-chain SPD matrix B = (m/Δt²)(2I − shift) + V''(x_cl(t, ω)) and the
    FIXED_BG ghost source s; its transition is f' = μ + P(f − μ) + S ξ with
    P = e^{−BΔτ}, S = [(c²/Δt)·B⁻¹(I − e^{−2BΔτ})]^½, μ = B⁻¹s, built from one
    batched ``eigh``.  A zero mode (λ ≤ 1e-8) gets its diffusive limit
    2Δτ·c²/Δt.  DIRICHLET acts on the N−2 interior sites and is embedded with
    zero edge rows and columns.  ``dtau``: per-chain (C,) step sizes (pass
    ``state.dtau`` when resuming); defaults to ``cfg.dtau``."""
    _full_precision_matmul()
    C, N = cfg.n_chains, cfg.n_sites
    dt = cfg.dt
    dtype, dev = cfg.torch_dtype, omega.device
    t_grid = (torch.arange(N, dtype=torch.float64, device=dev) * dt).to(dtype)
    inv = action.mass / (dt * dt)
    x_cl = action.x_cl(t_grid[None, :], omega[:, None]).to(dtype)
    curv = action.ddV(x_cl).to(dtype).expand(C, N)

    def tridiag(n, diag):
        eye = torch.eye(n, dtype=dtype, device=dev)
        off = (torch.diag(torch.ones(n - 1, dtype=dtype, device=dev), 1)
               + torch.diag(torch.ones(n - 1, dtype=dtype, device=dev), -1))
        return diag[:, :, None] * eye + (2.0 * inv) * eye - inv * off

    dirichlet = cfg.bc == BoundaryCondition.DIRICHLET
    mu = torch.zeros((C, N), dtype=dtype, device=dev)
    if dirichlet:
        B = tridiag(N - 2, curv[:, 1:-1])
    elif cfg.bc == BoundaryCondition.PERIODIC:
        corner = torch.zeros((N, N), dtype=dtype, device=dev)
        corner[0, N - 1] = 1.0
        corner[N - 1, 0] = 1.0
        B = tridiag(N, curv) - inv * corner
    else:  # FIXED_BG ghost sources
        B = tridiag(N, curv)
        if cfg.ghost_override is not None:
            asym_l, asym_r = cfg.ghost_override
        else:
            asym_l, asym_r = action.boundary_asymptote(-1), action.boundary_asymptote(+1)
        scalar = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
        gl = scalar(asym_l) - action.x_cl(scalar(-dt), omega).to(dtype)
        gr = scalar(asym_r) - action.x_cl(scalar(N * dt), omega).to(dtype)
        s = torch.zeros((C, N), dtype=dtype, device=dev)
        s[:, 0] += inv * gl
        s[:, -1] += inv * gr
        mu = torch.linalg.solve(B, s[..., None])[..., 0]
    lam, U = torch.linalg.eigh(B)  # (C, n), (C, n, n)
    if dtau is None:
        dtau_col = torch.full((C, 1), cfg.dtau, dtype=dtype, device=dev)
    else:
        dtau_col = dtau.to(dtype).reshape(C, 1)
    c2_dt = torch.tensor(cfg.noise_amp**2 / dt, dtype=dtype, device=dev)
    decay = torch.exp(-lam * dtau_col)
    var = torch.where(
        lam > 1e-8,
        c2_dt * (1.0 - decay * decay) / torch.clamp(lam, min=1e-8),
        2.0 * dtau_col * c2_dt,
    )
    Ut = U.transpose(-1, -2)
    P = torch.matmul(U * decay[:, None, :], Ut)
    S = torch.matmul(U * torch.sqrt(var)[:, None, :], Ut)
    if dirichlet:
        Pf = torch.zeros((C, N, N), dtype=dtype, device=dev)
        Sf = torch.zeros((C, N, N), dtype=dtype, device=dev)
        Pf[:, 1:-1, 1:-1] = P
        Sf[:, 1:-1, 1:-1] = S
        return Pf, Sf, mu
    return P, S, mu


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
    state: ChainState, action: QMAction, cfg: ChainConfig, chain_offset: int = 0,
    *, philox: bool = False, exact_ops=None,
) -> FrameSums:
    """One frame of ``cfg.loops`` micro-steps from ``state`` (whose rows are
    global chains ``chain_offset …``).

    Noise comes in groups of consecutive micro-steps counted from the frame's
    first step: pairs sharing one Threefry draw at counter (site, step of the
    first), or with ``philox`` (what the kernel wrappers pass under
    ``rng_impl='hardware'``, EM and HEUN only) fours sharing one Philox draw,
    with ω drawing site N of the chain's own stream; a short last group drops
    its unused normals.  Observables sample the pre-update field; a chain
    whose detector trips (max |det| > lrg_vl, or a non-finite update; under
    ``Scheme.EXACT`` only the latter) is frozen for the rest of the frame.
    Returns the frame sums — the plain version of CUDA kernel 1.

    ``exact_ops``: :func:`exact_propagator_ops` of ``state`` for
    ``Scheme.EXACT``, built here when omitted (:func:`run_frames` builds them
    once per call).
    """
    check_supported(cfg, action)
    k = frame_constants(action, cfg)
    C, N = state.f.shape
    dev, dtype = state.f.device, state.f.dtype
    mid = N // 2
    rounds = rng.rounds_of(cfg.rng_impl)
    background, has_zm, bc = k["background"], k["has_zm"], cfg.bc
    exact_scheme = cfg.scheme == Scheme.EXACT
    lm = cfg.scheme == Scheme.LM
    if philox and (exact_scheme or lm or cfg.accumulate_spectrum):
        raise ValueError("the Philox stream serves the kernels' schemes (EM, HEUN) only")
    if exact_scheme:
        _full_precision_matmul()
        P_op, S_op, mu_op = (exact_ops if exact_ops is not None else
                             exact_propagator_ops(action, cfg, state.omega, state.dtau))
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
        f, om, xs, xxs, x2s, x4s, specs, lrg, unstable = vals
        if background:
            bg = action.x_cl(t_grid[None, :], om[:, None]).to(dtype)
            ddv_bg = action.ddV(bg).to(dtype)
        gh = ghosts(om)

        def drift(ff):
            lap = (neighbor_sum(ff, gh) - 2.0 * ff) * inv_dt2
            if background:
                return lap - ddv_bg * ff
            return lap - action.dV(ff).to(dtype)

        if exact_scheme:
            # exact OU transition μ + P(f − μ) + Sξ, cast back to the EM
            # bookkeeping shape (det + noise) for the shared machinery below
            noise = torch.matmul(S_op, eta[:, :, None])[:, :, 0]
            f_next = mu_op + torch.matmul(P_op, (f - mu_op)[:, :, None])[:, :, 0] + noise
            det = f_next - f - noise
        else:
            noise = noise_amp * eta
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

        if exact_scheme:
            # the exact transition moves O(σ) per step at large Δτ: only a
            # non-finite update trips
            tripped = ~torch.all(finite, dim=-1)
        else:
            absdet = torch.where(finite, torch.abs(det), math.inf)
            tripped = torch.amax(absdet, dim=-1) > lrg

        x = f + bg if background else f
        x_new = newf + bg if background else newf
        x2 = x * x
        xs2 = xs + x
        xxs2 = xxs + x * x[:, mid:mid + 1]
        x2s2 = x2s + x2
        x4s2 = x4s + x2 * x2
        if cfg.accumulate_spectrum:
            specs2 = specs + torch.abs(torch.fft.rfft(x, dim=-1)).to(dtype) ** 2
        else:
            specs2 = specs
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
            torch.where(u, specs, specs2),
            torch.where(unstable, lrg, lrg2),
            unstable | tripped,
        )

    def noise_group(step):
        """(field noises, ω noises) of the micro-steps from ``step`` on."""
        if philox:
            z = rng.philox_normal_quad_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C, N + int(has_zm)),
                chain_offset=chain_offset, device=dev,
            )
            if not has_zm:
                return z, (None,) * len(z)
            return tuple(e[:, :N] for e in z), tuple(e[:, N] for e in z)
        e = rng.normal_pair_for_shape(
            cfg.seed, rng.Stream.FIELD, step, (C, N), chain_offset=chain_offset,
            rounds=rounds, device=dev,
        )
        e = tuple(v.to(dtype) for v in e)
        if not has_zm:
            return e, (None, None)
        o = rng.normal_pair(cfg.seed, k1_om, zero_ids, rng.u32(step), rounds)
        return e, tuple(v.to(dtype) for v in o)

    zsum = torch.zeros_like(state.f)
    vals = (state.f, state.omega, zsum, zsum, zsum, zsum,
            torch.zeros_like(state.spec_mean), state.lrg_vl,
            torch.zeros((C,), dtype=torch.bool, device=dev))
    step0 = int(state.step)
    if lm:
        # micro-step k uses (ξ_k + ξ_{k+1})/2; the pair drawn ahead is carried
        # and drawn again, from the same counters, by the next frame
        (p0, p1), (po0, po1) = noise_group(step0)
        half = lambda a, b: 0.5 * (a + b) if a is not None else None  # noqa: E731
        for p in range(cfg.loops // 2):
            (q0, q1), (qo0, qo1) = noise_group(step0 + 2 * p + 2)
            vals = substep(vals, half(p0, p1), half(po0, po1))
            vals = substep(vals, half(p1, q0), half(po1, qo0))
            p0, p1, po0, po1 = q0, q1, qo0, qo1
    else:
        group = rng.PHILOX_STEPS if philox else 2
        for s0 in range(0, cfg.loops, group):
            etas, etas_om = noise_group(step0 + s0)
            for g in range(min(group, cfg.loops - s0)):
                vals = substep(vals, etas[g], etas_om[g])
    f, om, xs, xxs, x2s, x4s, specs, lrg, unstable = vals
    return FrameSums(f, om, xs, xxs, x2s, x4s, lrg, unstable,
                     specs if cfg.accumulate_spectrum else None)


def frame_epilogue(state: ChainState, sums: FrameSums, cfg: ChainConfig):
    """Accept/reject, running-mean merge and adaptive Δτ for one frame —
    the expressions of the JAX epilogue and of kernel 2's in-kernel one.
    Rejected frames still advance ``step`` (the retry draws fresh noise).
    Under ``Scheme.EXACT`` Δτ stays as it is: the propagator is exact at the
    configured step.  Returns (new_state, metrics)."""
    accept = ~sums.unstable
    a1 = accept[:, None]
    n_new = accum.runs_after(state.runs, cfg.loops).to(state.f.dtype)[:, None]

    def merged(mean, frame_sum):
        return torch.where(a1, accum.merge_frame_sum(mean, frame_sum, cfg.loops, n_new), mean)

    if cfg.scheme == Scheme.EXACT:
        dtau = state.dtau
        stab_cnt = torch.where(accept, state.stab_cnt + 1, 0).to(torch.int32)
    else:
        dtau, stab_cnt = accum.adapt_dtau(state.dtau, state.stab_cnt, accept, cfg)
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
        spec_mean=(merged(state.spec_mean, sums.specs) if cfg.accumulate_spectrum
                   else state.spec_mean),
        step=host_step(int(state.step) + cfg.loops),
    )
    return new_state, {"stable": accept, "dtau": dtau, "max_x": lrg_vl}


def stack_metrics(per_frame) -> dict:
    """List of per-frame metric dicts (each (C,)) → dict of (frames, C)."""
    return {key: torch.stack([m[key] for m in per_frame]) for key in per_frame[0]}


def make_frame_fn(action: QMAction, cfg: ChainConfig, exact_ops=None, chain_offset: int = 0):
    """Build ``frame(state) -> (state', metrics)``: one macro-step of
    ``cfg.loops`` micro-steps with accept/reject and adaptive Δτ, on the
    plain path (the counterpart of the JAX package's ``make_frame_fn``).

    ``exact_ops``: :func:`exact_propagator_ops` for ``Scheme.EXACT``, built
    once by the caller (:func:`run_frames` does); omitted, ``frame`` derives
    them from each state it is given.  The rows of a state are the global
    chains ``chain_offset …``."""
    check_supported(cfg, action)

    def frame(state: ChainState):
        return frame_epilogue(
            state, frame_sums(state, action, cfg, chain_offset, exact_ops=exact_ops), cfg)

    return frame


def run_frames(state: ChainState, action: QMAction, cfg: ChainConfig, n_frames: int,
               chain_offset: int = 0):
    """``n_frames`` macro-steps in plain PyTorch on the state's device; the
    rows of ``state`` are the global chains ``chain_offset …``.

    Returns (final_state, metrics) with metrics stacked over frames (n_frames, C).
    """
    exact_ops = (exact_propagator_ops(action, cfg, state.omega, state.dtau)
                 if cfg.scheme == Scheme.EXACT else None)  # eigh once per call
    frame = make_frame_fn(action, cfg, exact_ops, chain_offset)
    per_frame = []
    for _ in range(n_frames):
        state, m = frame(state)
        per_frame.append(m)
    return state, stack_metrics(per_frame)


def connected_correlator(state: ChainState) -> torch.Tensor:
    """C_i = ⟨x_i·x_mid⟩ − ⟨x_i⟩·⟨x_mid⟩ per chain."""
    mid = state.x_mean.shape[-1] // 2
    return state.xx0_mean - state.x_mean * state.x_mean[:, mid:mid + 1]


def translation_averaged_correlator(state: ChainState) -> torch.Tensor:
    """⟨x(t)·x(t+Δ)⟩ averaged over all t (per chain) from the accumulated
    power spectrum (needs ``cfg.accumulate_spectrum``).  Connected part:
    subtract the squared time-averaged mean outside if it is nonzero."""
    n = state.x_mean.shape[-1]
    return true_divide(torch.fft.irfft(state.spec_mean, n=n, dim=-1), float(n))


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
