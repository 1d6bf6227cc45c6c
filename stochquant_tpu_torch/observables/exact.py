"""Exact known answers for quadratic (Gaussian) lattice actions (port of
``stochquant_tpu.observables.exact``: the same functions, numpy in float64).

The reference's only validation is a human eyeballing ``theoVal`` on a plot
(``taumain.py:130,137``, SURVEY.md §4).  Here the harmonic-oscillator chain
is solved *exactly* — including the O(Δτ) bias of the Euler–Maruyama scheme —
turning "looks right" into machine-checkable regression gates.

For S = ½ xᵀA x the Langevin drift is −Bx with B = A/Δt (density convention)
and the EM update x' = (I − Δτ·B)x + √(2Δτ/Δt)·η has stationary covariance

    Σ_EM = V·diag( 1 / (Δt·b_q·(1 − Δτ·b_q/2)) )·Vᵀ

(b_q, V the eigensystem of B), which → A⁻¹ as Δτ→0.  Stability requires
Δτ·b_max < 2.

These are host oracles, not device code: every function works in numpy
float64.  The port's actions are PyTorch expressions, so
:func:`background_gaussian_moments` evaluates them on float64 CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from stochquant_tpu_torch.config import BoundaryCondition


def _f64(fn, *args) -> np.ndarray:
    """``fn`` (an action's PyTorch expression) at float64 host values, as numpy."""
    out = fn(*(torch.as_tensor(np.asarray(a, np.float64)) for a in args))
    return np.asarray(torch.as_tensor(out, dtype=torch.float64).numpy())


def harmonic_drift_matrix(
    n_sites: int,
    dt: float,
    k: float = 2.0,
    mass: float = 1.0,
    bc: BoundaryCondition = BoundaryCondition.PERIODIC,
) -> np.ndarray:
    """B such that drift(x) = −B·x for V = ½kx² (density convention,
    matching integrators/langevin.py): B = −m·∇²/Δt² + k·I.

    For DIRICHLET the returned matrix acts on the N−2 interior sites (edges
    frozen at 0); for FIXED_BG (harmonic asymptote 0) ghosts are 0 and B acts
    on all N sites.
    """
    inv = mass / (dt * dt)
    n = n_sites - 2 if bc == BoundaryCondition.DIRICHLET else n_sites
    B = np.diag(np.full(n, 2.0 * inv + k))
    idx = np.arange(n - 1)
    B[idx, idx + 1] = -inv
    B[idx + 1, idx] = -inv
    if bc == BoundaryCondition.PERIODIC:
        B[0, n - 1] += -inv
        B[n - 1, 0] += -inv
    # non-periodic: edge sites couple to a ghost fixed at 0 (DIRICHLET edge
    # freeze / harmonic FIXED_BG asymptote) — the diagonal already counts
    # both neighbours, nothing further to add.
    return B


def em_stationary_cov(B: np.ndarray, dt: float, dtau: float) -> np.ndarray:
    """Exact stationary covariance of the EM chain at finite Δτ."""
    b, V = np.linalg.eigh(B)
    if np.any(dtau * b >= 2.0):
        raise ValueError(f"EM unstable: dtau*b_max = {dtau * np.max(b):.3f} >= 2")
    var = 1.0 / (dt * b * (1.0 - 0.5 * dtau * b))
    return (V * var) @ V.T


def heun_stationary_cov(B: np.ndarray, dt: float, dtau: float) -> np.ndarray:
    """Exact stationary covariance of the stochastic-Heun chain.

    Per mode (z = Δτ·b): the update is x' = a·x + c·η with a = 1 − z + z²/2
    and c = (1 − z/2)·√(2Δτ/Δt), giving

        Var = (1/(Δt·b)) · (1 − z/2) / (1 − z/2 + z²/4)

    → (Δt·b)⁻¹·(1 − z²/4 + O(z³)): second-order accurate, vs EM's O(z).
    Stability requires z < 2 (same as EM).
    """
    b, V = np.linalg.eigh(B)
    z = dtau * b
    if np.any(z >= 2.0):
        raise ValueError(f"Heun unstable: dtau*b_max = {z.max():.3f} >= 2")
    var = (1.0 - 0.5 * z) / ((1.0 - 0.5 * z + 0.25 * z * z) * dt * b)
    return (V * var) @ V.T


def lm_stationary_cov(B: np.ndarray, dt: float, dtau: float) -> np.ndarray:
    """Exact stationary covariance of the Leimkuhler–Matthews chain.

    Per mode (a = 1 − Δτ·b, noise c·(ξ_k + ξ_{k+1})/2, c = √(2Δτ/Δt)):
    the stationary recursion V = a²V + c²/2 + a·c²/2 (the cross term from
    ξ_k being shared with the previous step) gives

        V = (c²/2)·(1+a)/(1−a²) = (c²/2)/(1−a) = 1/(Δt·b)

    — the *target* covariance exactly, for every Δτ·b < 2.  (LM's O(Δτ²)
    bias vanishes identically on Gaussians; the bias gate for the chain is
    therefore Δτ-independence itself.)
    """
    b, _ = np.linalg.eigh(B)
    z = dtau * b
    if np.any(z >= 2.0):
        raise ValueError(f"LM unstable: dtau*b_max = {z.max():.3f} >= 2")
    return target_cov(B, dt)


def target_cov(B: np.ndarray, dt: float) -> np.ndarray:
    """Δτ→0 covariance = A⁻¹ (the true path-integral two-point function)."""
    b, V = np.linalg.eigh(B)
    return (V * (1.0 / (dt * b))) @ V.T


def harmonic_x2_continuum(k: float = 2.0, mass: float = 1.0) -> float:
    """Continuum ground-state ⟨x²⟩ = 1/(2·m·ω₀), ω₀ = √(k/m) (ħ=1)."""
    return 1.0 / (2.0 * mass * np.sqrt(k / mass))


def free_field_x2(shape, spacing: float, m2: float, dtau: float = 0.0) -> float:
    """⟨φ²⟩ for the free field on a periodic D-dim lattice, optionally with
    the EM finite-Δτ bias.  b(p) = Σ_μ 2(1−cos p_μ)/a² + m², site measure a^D:

        ⟨φ²⟩ = (1/V)·Σ_p 1/(a^D·b(p)·(1 − Δτ·b(p)/2)).
    """
    a = spacing
    d = len(shape)
    grids = np.meshgrid(
        *[2.0 * np.pi * np.arange(n) / n for n in shape], indexing="ij"
    )
    b = m2 + sum(2.0 * (1.0 - np.cos(g)) / (a * a) for g in grids)
    denom = a**d * b * (1.0 - 0.5 * dtau * b)
    if np.any(denom <= 0):
        raise ValueError("EM unstable for this dtau")
    return float(np.mean(1.0 / denom))


def background_gaussian_moments(
    action,
    n_sites: int,
    dt: float,
    dtau: float,
    omega: float,
    ghost_override=None,
):
    """Exact per-site (⟨x⟩, ⟨x²⟩, ⟨x⁴⟩) of the BACKGROUND-formulation chain
    at *frozen* collective coordinate (``cfg.parisi=False`` — the reference
    Windows launcher's ``parisi=0`` mode, ``taumain_windows.py:145``).

    Conditional on ω, the fluctuation update (``tau_kernel.cl:111-117``) is
    linear: drift = −B·f + s with B = −m∇²/Δt² + diag(V''(x_cl(t, ω))) and
    the FIXED_BG ghosts entering as the affine source
    s₀ = m·g_l/Δt², s_{N−1} = m·g_r/Δt² (g = asymptote − x_cl at the ghost
    time).  The EM chain is then exactly Gaussian: stationary mean B⁻¹s
    (unbiased), covariance em_stationary_cov(B, Δt, Δτ), and x = f + x_cl
    has ⟨x²⟩ = m_x² + σ², ⟨x⁴⟩ = m_x⁴ + 6m_x²σ² + 3σ⁴ per site — an fp64
    oracle for the full BACKGROUND machinery (kink background, ghost
    construction, linearized drift) including its soft near-zero mode."""
    t = np.arange(n_sites, dtype=np.float64) * dt
    x_cl = _f64(action.x_cl, t, omega)
    ddv = _f64(action.ddV, x_cl)
    inv = action.mass / (dt * dt)
    B = np.diag(2.0 * inv + ddv)
    idx = np.arange(n_sites - 1)
    B[idx, idx + 1] = -inv
    B[idx + 1, idx] = -inv
    if ghost_override is not None:
        asym_l, asym_r = ghost_override
    else:
        asym_l = action.boundary_asymptote(-1)
        asym_r = action.boundary_asymptote(+1)
    gl = asym_l - float(_f64(action.x_cl, -dt, omega))
    gr = asym_r - float(_f64(action.x_cl, n_sites * dt, omega))
    s = np.zeros(n_sites)
    s[0] = inv * gl
    s[-1] = inv * gr
    mu_f = np.linalg.solve(B, s)
    var = np.diag(em_stationary_cov(B, dt, dtau))
    m_x = mu_f + x_cl
    x2 = m_x**2 + var
    x4 = m_x**4 + 6.0 * m_x**2 * var + 3.0 * var**2
    return m_x, x2, x4


def transfer_matrix_moments(
    V,
    n_sites: int,
    dt: float,
    mass: float = 1.0,
    x_max: float = 4.5,
    n_grid: int = 800,
):
    """Exact lattice expectations ⟨x²⟩, ⟨x⁴⟩ for 1-D periodic Euclidean QM by
    numerical transfer-matrix diagonalization — the fp64 ground truth for the
    anharmonic regression gate (BASELINE.json config 2).

    Z = Tr(T^N) with the symmetric transfer kernel

        T(x, x') = exp(−m(x−x')²/(2Δt) − Δt·(V(x)+V(x'))/2)·w

    on a uniform grid (w the quadrature weight).  Moments use the full
    eigensum Σ_k r_k^N ⟨k|x^p|k⟩ / Σ_k r_k^N with r_k = λ_k/λ_max, so finite-N
    effects are exact, not just the ground-state limit.  Grid truncation is
    negligible when exp(−m·x_max²/(2Δt)) underflows the working precision —
    validate by increasing ``n_grid``/``x_max`` (tests do).

    This is the distribution the Langevin process targets as Δτ→0; the
    integrator's finite-Δτ stationary bias (O(Δτ) for EM, O(Δτ²) for LM) is
    on the *simulation* side of the comparison.
    """
    x = np.linspace(-x_max, x_max, n_grid, dtype=np.float64)
    w = x[1] - x[0]
    dx2 = (x[:, None] - x[None, :]) ** 2
    v = V(x).astype(np.float64)
    T = np.exp(-(mass / (2.0 * dt)) * dx2 - dt * 0.5 * (v[:, None] + v[None, :])) * w
    lam, U = np.linalg.eigh(T)
    # sort descending by |λ|; T is a positive kernel so λ_max > 0
    order = np.argsort(lam)[::-1]
    lam, U = lam[order], U[:, order]
    ratios = np.clip(lam / lam[0], -1.0, 1.0) ** n_sites
    weights = ratios / ratios.sum()
    x2_k = (U * (x**2)[:, None] * U).sum(axis=0)  # ⟨k|x²|k⟩ (U columns orthonormal)
    x4_k = (U * (x**4)[:, None] * U).sum(axis=0)
    # E_k − E_0 = −ln(λ_k/λ_0)/Δt: the correlator decay rate (energy gap)
    gap = float(np.log(lam[0] / lam[1]) / dt)
    return float(weights @ x2_k), float(weights @ x4_k), gap
