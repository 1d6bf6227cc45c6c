"""The JAX package's physics gates, run through the port against the port's
exact answers (``stochquant_tpu_torch.observables.exact``, the oracle).

- CPU twins of the JAX package's statistical tests, through the port's plain
  path at the JAX sizes and limits: the non-slow ones
  (``tests/test_physics_regression.py:88, 162``,
  ``tests/test_background_moments.py:60, 118``,
  ``tests/test_integrator.py:286, 342``) and, marked ``slow`` as there, the
  slow ones;
- the gates of ``chip_smoke.py`` [29] (``stochquant_tpu_torch.physics_gates``)
  at full width, through the kernels: ``cuda``-marked, they skip without a GPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu_torch import actions, oracle, physics_gates
from stochquant_tpu_torch.actions import gauge as ga
from stochquant_tpu_torch.config import (
    BoundaryCondition, ChainConfig, FieldConfig, Formulation, Scheme, Sweep,
)
from stochquant_tpu_torch.integrators import field, langevin
from stochquant_tpu_torch.integrators import gauge as gi
from stochquant_tpu_torch.kernels import chain_kernel
from stochquant_tpu_torch.observables import analysis, exact

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _host(t):
    return t.detach().double().cpu().numpy()


def _z(sim, theory, n_chains):
    est = sim.mean(0)
    se = sim.std(0) / np.sqrt(n_chains)
    return np.abs(est - theory) / (se + 1e-12)


def _run(cfg, n_frames, burn_frames=0):
    act = actions.get(cfg.action)
    state = langevin.init_chain_state(cfg, act, device=CPU)
    if burn_frames:
        state, _ = langevin.run_frames(state, act, cfg, burn_frames)
        state = langevin.reset_means(state)
    state, metrics = langevin.run_frames(state, act, cfg, n_frames)
    return act, state, metrics


def _V(act):
    return lambda x: act.V(torch.as_tensor(x)).numpy()


# ---------------------------------------------------------------------------
# twins of the JAX package's non-slow gates
# ---------------------------------------------------------------------------

def test_anharmonic_x2_matches_transfer_matrix():
    """tests/test_physics_regression.py:88: λφ⁴ chain ⟨x²⟩ (LM) against the
    fp64 transfer matrix, with the oracle's own grid convergence."""
    cfg = ChainConfig(
        action="anharmonic", n_sites=64, dt=0.25, dtau=0.01, n_chains=64,
        loops=200, bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT, scheme=Scheme.LM, seed=6,
        grow_after=10**9,
    )
    act, state, metrics = _run(cfg, 100, burn_frames=20)
    assert metrics["stable"][-1].all()
    per_chain = _host(state.x2_mean).mean(axis=1)
    mean, err = per_chain.mean(), per_chain.std() / np.sqrt(cfg.n_chains)
    x2_exact, _, _ = exact.transfer_matrix_moments(_V(act), cfg.n_sites, cfg.dt)
    x2_fine, _, _ = exact.transfer_matrix_moments(_V(act), cfg.n_sites, cfg.dt,
                                                  n_grid=1200, x_max=5.0)
    assert abs(x2_exact - x2_fine) < 1e-8
    assert abs(mean - x2_exact) < 6 * err + 2e-3, (mean, x2_exact, err)


def test_anharmonic_schwinger_dyson_identity():
    """tests/test_physics_regression.py:162: ⟨x_i·∂S/∂x_i⟩ = 1 per site from
    the translation-averaged correlator and ⟨x⁴⟩."""
    cfg = ChainConfig(
        action="anharmonic", n_sites=64, dt=0.25, dtau=0.01, n_chains=64,
        loops=200, bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT, scheme=Scheme.LM, seed=8,
        accumulate_spectrum=True, grow_after=10**9,
    )
    act, state, metrics = _run(cfg, 100, burn_frames=20)
    assert metrics["stable"][-1].all()
    corr = _host(langevin.translation_averaged_correlator(state))
    x4 = _host(state.x4_mean).mean(axis=1)
    c0, c1 = corr[:, 0], corr[:, 1]
    sd = (act.mass / cfg.dt) * (2.0 * c0 - 2.0 * c1) + cfg.dt * (act.mu2 * c0 + 4.0 * act.lam * x4)
    mean, err = sd.mean(), sd.std() / np.sqrt(cfg.n_chains)
    assert abs(mean - 1.0) < 6 * err + 5e-3, (mean, err)


def test_double_well_background_frozen_omega_moment_gate():
    """tests/test_background_moments.py:60: the BACKGROUND chain at frozen ω
    (kink x_cl, FIXED_BG ghost sources, linearized drift) against the exact
    conditional Gaussian, the chains started from it."""
    cfg = ChainConfig(
        action="double_well", n_sites=24, dt=0.05, dtau=5e-4, n_chains=64,
        loops=100, seed=7, grow_after=10**9,
        formulation=Formulation.BACKGROUND, bc=BoundaryCondition.FIXED_BG, parisi=False,
    )
    act = actions.get("double_well")
    om0 = 0.5 * (cfg.n_sites - 1) * cfg.dt
    t = np.arange(cfg.n_sites) * cfg.dt
    x_cl = act.x_cl(torch.as_tensor(t), om0).numpy()
    ddv = act.ddV(torch.as_tensor(x_cl)).numpy()
    inv = act.mass / cfg.dt**2
    B = np.diag(2.0 * inv + ddv)
    i_ = np.arange(cfg.n_sites - 1)
    B[i_, i_ + 1] = -inv
    B[i_ + 1, i_] = -inv
    assert np.linalg.eigvalsh(B).min() > 0.5, "geometry must lift the soft mode"
    gl = act.boundary_asymptote(-1) - float(act.x_cl(torch.tensor(-cfg.dt, dtype=torch.float64),
                                                     om0))
    gr = act.boundary_asymptote(+1) - float(
        act.x_cl(torch.tensor(cfg.n_sites * cfg.dt, dtype=torch.float64), om0))
    src = np.zeros(cfg.n_sites)
    src[0], src[-1] = inv * gl, inv * gr
    mu = np.linalg.solve(B, src)
    cov = exact.em_stationary_cov(B, cfg.dt, cfg.dtau)
    rs = np.random.RandomState(3)
    f0 = mu[None, :] + rs.standard_normal((cfg.n_chains, cfg.n_sites)) @ np.linalg.cholesky(cov).T

    s = langevin.init_chain_state(cfg, act, device=CPU)
    s = s._replace(
        omega=torch.full((cfg.n_chains,), om0, dtype=torch.float32),
        f=torch.as_tensor(f0, dtype=torch.float32),
        lrg_vl=torch.as_tensor(np.abs(f0 + x_cl).max(1), dtype=torch.float32),
    )
    s, m = langevin.run_frames(s, act, cfg, 100)
    assert m["stable"].all()
    assert float(s.omega.std()) == 0.0, "parisi=False must freeze ω"

    mx, x2t, x4t = exact.background_gaussian_moments(act, cfg.n_sites, cfg.dt, cfg.dtau, om0)
    np.testing.assert_allclose(mu + x_cl, mx)  # oracle self-consistency
    for leaf, want in ((s.x_mean, mx), (s.x2_mean, x2t), (s.x4_mean, x4t)):
        z = _z(_host(leaf), want, cfg.n_chains)
        assert z.max() < 6.0, z.max()


def test_parisi_toggle_changes_only_omega_updates():
    """tests/test_background_moments.py:118: parisi=False freezes ω on the
    plain path and in the kernel wrapper (its plain version on the CPU), and
    leaves the field update as it is."""
    cfg = ChainConfig(
        action="double_well", n_sites=32, dt=0.05, dtau=1e-4, n_chains=4,
        loops=6, seed=5, formulation=Formulation.BACKGROUND,
        bc=BoundaryCondition.FIXED_BG, parisi=False,
    )
    act = actions.get("double_well")
    s0 = langevin.init_chain_state(cfg, act, device=CPU)
    a, _ = langevin.run_frames(s0, act, cfg, 2)
    assert torch.equal(a.omega, s0.omega)
    b, _ = chain_kernel.run_frames_kernel(s0, act, cfg, 2)
    assert torch.equal(b.omega, s0.omega)
    np.testing.assert_allclose(_host(a.f), _host(b.f), rtol=2e-6, atol=2e-6)
    moving, _ = langevin.run_frames(s0, act, dataclasses.replace(cfg, parisi=True), 2)
    assert not torch.equal(moving.omega, s0.omega)


def test_translation_averaged_correlator_matches_exact():
    """tests/test_integrator.py:286: the power-spectrum correlator against the
    exact EM covariance row, and tighter than the single-midpoint one."""
    cfg = ChainConfig(
        action="harmonic", n_sites=32, dt=0.3, dtau=0.02, n_chains=256, loops=100,
        bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT, seed=15,
        grow_after=10**9, accumulate_spectrum=True,
    )
    _, state, _ = _run(cfg, n_frames=60, burn_frames=20)
    B = exact.harmonic_drift_matrix(cfg.n_sites, cfg.dt, k=2.0, bc=cfg.bc)
    sigma = exact.em_stationary_cov(B, cfg.dt, cfg.dtau)
    corr = _host(langevin.translation_averaged_correlator(state))
    mean = corr.mean(axis=0)
    stderr = corr.std(axis=0) / np.sqrt(cfg.n_chains)
    np.testing.assert_allclose(mean, sigma[0], atol=np.maximum(6 * stderr, 2e-3).max())
    single = _host(langevin.connected_correlator(state))
    assert corr.std(axis=0).mean() < single.std(axis=0).mean()


def test_lm_x2_is_exact_at_large_step():
    """tests/test_integrator.py:342: LM's site ⟨x²⟩ is the target covariance
    at a large step, resolved away from the EM value."""
    cfg = ChainConfig(
        action="harmonic", n_sites=32, dt=0.25, dtau=0.02, n_chains=384, loops=100,
        bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT, seed=99,
        grow_after=10**9, scheme=Scheme.LM,
    )
    _, state, _ = _run(cfg, n_frames=60, burn_frames=20)
    B = exact.harmonic_drift_matrix(cfg.n_sites, cfg.dt, k=2.0, bc=cfg.bc)
    sig_lm = exact.lm_stationary_cov(B, cfg.dt, cfg.dtau)
    sig_true = exact.target_cov(B, cfg.dt)
    np.testing.assert_allclose(sig_lm, sig_true)
    sig_em = exact.em_stationary_cov(B, cfg.dt, cfg.dtau)
    x2 = _host(state.x2_mean)
    mean = x2.mean(axis=0)
    stderr = x2.std(axis=0) / np.sqrt(cfg.n_chains)
    assert np.all(np.abs(mean - np.diag(sig_true)) < 6 * stderr + 1e-3)
    assert abs(mean.mean() - np.diag(sig_em).mean()) > abs(mean.mean() - np.diag(sig_true).mean())


def test_gate_extrapolation_removes_the_first_two_orders():
    """[29](e)'s extrapolation is exact on any quadratic in Δτ, and on the
    Gaussian chain of config 2's width leaves under a tenth of the gate's
    2e-3 where the line through two steps leaves more than it."""
    for coeffs in ((0.25, 3.0, -40.0), (1.0, 0.0, 0.0), (-2.0, 1.5, 7.0)):
        vals = [coeffs[0] + coeffs[1] * h + coeffs[2] * h * h for h in physics_gates.DTAUS_E]
        v, e = physics_gates.extrapolate(vals, [1.0, 1.0, 1.0])
        assert v == pytest.approx(coeffs[0], abs=1e-12)
        assert e == pytest.approx(np.sqrt(1 + 36 + 64) / 3)
    B = exact.harmonic_drift_matrix(1024, 0.25, k=4.0, bc=BoundaryCondition.PERIODIC)
    target = np.diag(exact.target_cov(B, 0.25)).mean()
    x2 = [np.diag(exact.em_stationary_cov(B, 0.25, h)).mean() for h in physics_gates.DTAUS_E]
    quad, _ = physics_gates.extrapolate(x2, [0.0] * 3)
    assert abs(quad - target) < 2e-4
    assert abs(2 * x2[1] - x2[0] - target) > 2e-3


# ---------------------------------------------------------------------------
# twins of the JAX package's slow gates
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_harmonic_energy_gap_matches_lattice_dispersion():
    """tests/test_physics_regression.py:14."""
    cfg = ChainConfig(
        action="harmonic", n_sites=64, dt=0.25, dtau=0.01, n_chains=512, loops=200,
        bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT, seed=1, grow_after=10**9,
    )
    act, state, metrics = _run(cfg, 120, burn_frames=30)
    assert metrics["stable"][-1].all()
    corr = _host(langevin.connected_correlator(state))
    fit = analysis.energy_gap_from_correlator(
        corr.mean(axis=0), cfg.dt, corr_err=corr.std(axis=0) / np.sqrt(cfg.n_chains))
    e_lat = 2.0 / cfg.dt * np.arcsinh(0.5 * cfg.dt * act.omega0)
    assert abs(fit.gap - e_lat) < 5 * fit.gap_err + 0.01, (fit.gap, e_lat, fit.gap_err)


@pytest.mark.slow
def test_double_well_kink_profile():
    """tests/test_physics_regression.py:45."""
    cfg = ChainConfig(action="double_well", n_sites=64, dt=0.25, dtau=2e-3, n_chains=128,
                      loops=500, seed=42, grow_after=10**9)
    act, state, metrics = _run(cfg, 30, burn_frames=10)
    assert metrics["stable"][-1].all()
    xmean = _host(state.x_mean).mean(axis=0)
    assert abs(xmean[:4].mean() + act.eta) < 0.25, xmean[:4]
    assert abs(xmean[-4:].mean() - act.eta) < 0.25, xmean[-4:]
    assert abs(xmean[0] + xmean[-1]) < 0.3
    om = _host(state.omega)
    assert np.all((om >= 0) & (om <= (cfg.n_sites - 1) * cfg.dt))


@pytest.mark.slow
def test_config2_full_scale_x2_and_gap():
    """tests/test_physics_regression.py:121 (LM, the spectrum correlator)."""
    cfg = ChainConfig(
        action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=32, loops=200,
        bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT, scheme=Scheme.LM,
        seed=7, accumulate_spectrum=True, grow_after=10**9,
    )
    act, state, metrics = _run(cfg, 120, burn_frames=20)
    assert metrics["stable"][-1].all()
    per_chain = _host(state.x2_mean).mean(axis=1)
    mean, err = per_chain.mean(), per_chain.std() / np.sqrt(cfg.n_chains)
    x2_exact, _, gap_exact = exact.transfer_matrix_moments(_V(act), cfg.n_sites, cfg.dt)
    assert abs(mean - x2_exact) < 6 * err + 2e-3, (mean, x2_exact, err)
    corr = _host(langevin.translation_averaged_correlator(state))
    fit = analysis.energy_gap_from_correlator(
        corr.mean(axis=0), cfg.dt, mid=0, fit_range=(1, 8),
        corr_err=corr.std(axis=0) / np.sqrt(cfg.n_chains))
    assert abs(fit.gap - gap_exact) < 5 * fit.gap_err + 0.05, (fit.gap, gap_exact, fit.gap_err)


def _field_run(cfg, act, burn, frames):
    state = field.init_field_state(cfg, device=CPU)
    state, _ = field.run_field_frames(state, act, cfg, burn)
    state = field.reset_field_means(state)
    return field.run_field_frames(state, act, cfg, frames)


@pytest.mark.slow
def test_field_binder_cumulant_gaussian_phase():
    """tests/test_physics_regression.py:196."""
    cfg = FieldConfig(action="free_field", shape=(16, 16), dtau=0.02, n_chains=64, loops=100,
                      seed=9, grow_after=10**9)
    state, metrics = _field_run(cfg, actions.get_field(cfg.action), 10, 60)
    assert metrics["stable"][-1].all()
    u = _host(field.binder_cumulant(state))
    mean, err = u.mean(), u.std() / np.sqrt(cfg.n_chains)
    assert abs(mean) < 6 * err + 0.02, (mean, err)


@pytest.mark.slow
def test_harmonic_background_x2_x4_exact_gate():
    """tests/test_background_moments.py:39."""
    cfg = ChainConfig(
        action="harmonic", n_sites=32, dt=0.2, dtau=2e-3, n_chains=64, loops=200, seed=31,
        grow_after=10**9, formulation=Formulation.BACKGROUND, bc=BoundaryCondition.FIXED_BG,
    )
    _, s, m = _run(cfg, 90, burn_frames=30)
    assert m["stable"].all()
    B = exact.harmonic_drift_matrix(cfg.n_sites, cfg.dt, bc=cfg.bc)
    sig2 = np.diag(exact.em_stationary_cov(B, cfg.dt, cfg.dtau))
    assert _z(_host(s.x2_mean), sig2, cfg.n_chains).max() < 6.0
    assert _z(_host(s.x4_mean), 3.0 * sig2**2, cfg.n_chains).max() < 6.0


@pytest.mark.slow
def test_parisi_omega_is_reflected_brownian_with_exact_step_law():
    """tests/test_background_moments.py:140."""
    cfg = ChainConfig(
        action="double_well", n_sites=200, dt=0.02, dtau=2e-4, n_chains=256, loops=50, seed=13,
        grow_after=10**9, formulation=Formulation.BACKGROUND, bc=BoundaryCondition.FIXED_BG,
        parisi=True,
    )
    act = actions.get("double_well")
    frame_sigma = np.sqrt(2.0 * cfg.dtau * act.zero_mode_const() ** 2 * cfg.loops)
    T = (cfg.n_sites - 1) * cfg.dt
    n_frames = 20
    assert 4 * frame_sigma * np.sqrt(n_frames) < T / 2
    s = langevin.init_chain_state(cfg, act, device=CPU)
    s, _ = langevin.run_frames(s, act, cfg, 10)
    omegas, stables = [_host(s.omega)], []
    for _ in range(n_frames):
        s, m = langevin.run_frames(s, act, cfg, 1)
        stables.append(m["stable"][0].numpy())
        omegas.append(_host(s.omega))
    om, stable = np.stack(omegas), np.stack(stables)
    assert stable.mean() > 0.9, stable.mean()
    assert om.min() >= 0.0 and om.max() <= T
    inc = np.diff(om, axis=0)[stable]
    n = inc.size
    assert abs(inc.mean()) < 5 * frame_sigma / np.sqrt(n), inc.mean()
    assert abs(inc.var() / frame_sigma**2 - 1.0) < 5 * np.sqrt(2.0 / n)
    assert abs(((inc / inc.std()) ** 4).mean() - 3.0) < 6 * np.sqrt(24.0 / n)


@pytest.mark.slow
@pytest.mark.parametrize("n_sites,dt,n_chains,frames,seed,row", [
    (64, 0.25, 256, 60, 123, False),  # tests/test_integrator.py:26
    (32, 0.3, 512, 80, 7, True),      # tests/test_integrator.py:57
])
def test_harmonic_x2_and_correlator_match_exact_em_covariance(n_sites, dt, n_chains, frames,
                                                              seed, row):
    cfg = ChainConfig(action="harmonic", n_sites=n_sites, dt=dt, dtau=0.02, n_chains=n_chains,
                      loops=100, bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT,
                      seed=seed, grow_after=10**9)
    _, state, _ = _run(cfg, n_frames=frames, burn_frames=20)
    B = exact.harmonic_drift_matrix(n_sites, dt, k=2.0, bc=cfg.bc)
    sigma = exact.em_stationary_cov(B, dt, cfg.dtau)
    if row:
        corr = _host(langevin.connected_correlator(state))
        stderr = corr.std(axis=0) / np.sqrt(n_chains)
        assert np.all(np.abs(corr.mean(axis=0) - sigma[:, n_sites // 2]) < 6 * stderr + 2e-3)
        return
    x2 = _host(state.x2_mean)
    mean, stderr = x2.mean(axis=0), x2.std(axis=0) / np.sqrt(n_chains)
    assert np.all(np.abs(mean - np.diag(sigma)) < 6 * stderr + 1e-3)
    glob_err = x2.mean(axis=1).std() / np.sqrt(n_chains)
    assert abs(mean.mean() - np.diag(sigma).mean()) < 5 * glob_err


@pytest.mark.slow
def test_heun_x2_matches_exact_heun_covariance():
    """tests/test_integrator.py:221."""
    cfg = ChainConfig(action="harmonic", n_sites=32, dt=0.25, dtau=0.02, n_chains=384, loops=100,
                      bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT, seed=77,
                      grow_after=10**9, scheme=Scheme.HEUN)
    _, state, _ = _run(cfg, n_frames=60, burn_frames=20)
    B = exact.harmonic_drift_matrix(cfg.n_sites, cfg.dt, k=2.0, bc=cfg.bc)
    sig_heun = np.diag(exact.heun_stationary_cov(B, cfg.dt, cfg.dtau))
    sig_em = np.diag(exact.em_stationary_cov(B, cfg.dt, cfg.dtau))
    sig_true = np.diag(exact.target_cov(B, cfg.dt))
    x2 = _host(state.x2_mean)
    mean, stderr = x2.mean(axis=0), x2.std(axis=0) / np.sqrt(cfg.n_chains)
    assert np.all(np.abs(mean - sig_heun) < 6 * stderr + 1e-3)
    assert abs(sig_heun.mean() - sig_true.mean()) < 0.5 * abs(sig_em.mean() - sig_true.mean())
    assert abs(mean.mean() - sig_em.mean()) > abs(mean.mean() - sig_heun.mean())


@pytest.mark.slow
def test_free_field_2d_phi2_matches_exact():
    """tests/test_field.py:14."""
    cfg = FieldConfig(action="free_field", shape=(16, 16), spacing=1.0, dtau=0.05, n_chains=64,
                      loops=100, seed=21, grow_after=10**9)
    state, metrics = _field_run(cfg, actions.get_field("free_field", m2=1.0), 20, 60)
    assert metrics["stable"].all()
    theory = exact.free_field_x2(cfg.shape, cfg.spacing, 1.0, dtau=cfg.dtau)
    est = _host(state.phi2_mean)
    err = est.std() / np.sqrt(cfg.n_chains)
    assert abs(est.mean() - theory) < 5 * err + 5e-4, (est.mean(), theory, err)


@pytest.mark.slow
def test_broken_phase_magnetization():
    """tests/test_field.py:51."""
    cfg = FieldConfig(action="phi4", shape=(16, 16), dtau=0.02, n_chains=16, loops=200, seed=9,
                      grow_after=10**9)
    state, _ = _field_run(cfg, actions.get_field("phi4", m2=-2.0, lam=6.0), 30, 30)
    assert _host(state.absmag_mean).mean() > 0.8
    assert np.all(np.isfinite(_host(field.susceptibility(state, 16 * 16))))


@pytest.mark.slow
def test_checkerboard_free_field_stationary():
    """tests/test_field.py:97."""
    cfg = FieldConfig(action="free_field", shape=(16, 16), dtau=0.01, n_chains=64, loops=100,
                      seed=6, grow_after=10**9, sweep=Sweep.CHECKERBOARD)
    state, m = _field_run(cfg, actions.get_field("free_field", m2=1.0), 12, 30)
    assert m["stable"].all()
    theory0 = exact.free_field_x2(cfg.shape, cfg.spacing, 1.0, dtau=0.0)
    est = _host(state.phi2_mean)
    err = est.std() / np.sqrt(cfg.n_chains)
    assert abs(est.mean() - theory0) < 5 * err + 0.08 * theory0, (est.mean(), theory0)


@pytest.mark.slow
@pytest.mark.parametrize("group,beta,n_chains,burn,frames,seed", [
    ("u1", 1.0, 256, 25, 45, 5),   # tests/test_gauge.py:72
    ("su2", 2.0, 128, 30, 80, 6),  # tests/test_gauge.py:93
    ("su3", 2.0, 64, 30, 80, 7),   # tests/test_gauge.py:208
])
def test_2d_plaquette_matches_exact(group, beta, n_chains, burn, frames, seed):
    cfg = gi.GaugeConfig(group=group, beta=beta, shape=(8, 8), n_chains=n_chains, dtau=2e-3,
                         loops=100, seed=seed, grow_after=10**9)
    act = ga.get_gauge(group, beta=beta)
    s = gi.init_gauge_state(cfg, act, device=CPU)
    s, _ = gi.run_gauge_frames(s, act, cfg, burn)
    s = gi.reset_gauge_means(s)
    s, m = gi.run_gauge_frames(s, act, cfg, frames)
    assert m["stable"].all()
    pm = _host(s.plaq_mean)
    err = pm.std() / np.sqrt(cfg.n_chains)
    want = gi.exact_plaquette_2d(group, beta)
    assert abs(pm.mean() - want) < 6 * err + 10 * cfg.dtau, (pm.mean(), want, err)


@pytest.mark.slow
def test_framework_matches_oracle_double_well_x2():
    """tests/test_oracle.py:37: the edge profile |⟨x(t)⟩| against one long
    oracle run at T = 12 (N = 48, Δt = 0.25), where the kink stays far from
    the edges."""
    N, dt, dtau = 48, 0.25, 2e-3
    ref = oracle.run_reference(N, dt, dtau, frames=10, loops=4000, seed=11)
    assert ref.dtau <= dtau / 0.95**2
    cfg = ChainConfig(action="double_well", n_sites=N, dt=dt, dtau=dtau, n_chains=64, loops=1000,
                      seed=5, grow_after=10**9)
    _, st, m = _run(cfg, 30, burn_frames=10)
    assert m["stable"][-1].all()
    ours = _host(st.x_mean)
    stderr = ours.std(axis=0) / np.sqrt(cfg.n_chains)
    d = np.abs(np.abs(ours.mean(axis=0)) - np.abs(ref.x_mean))
    assert np.all(d[:8] < 10 * stderr[:8] + 0.08)


@pytest.mark.slow
def test_framework_matches_oracle_harmonic_fixed_bg():
    """tests/test_oracle.py:87: ghosts pinned at ±0.8 (the reference's BC
    mode 1) for the harmonic chain, the site profile ⟨x(t)⟩."""
    N, dt, dtau = 32, 0.25, 2e-3
    ref = oracle.run_reference(N, dt, dtau, frames=12, loops=5000, pot_id=0, seed=21)
    assert ref.runs > 0
    cfg = ChainConfig(action="harmonic", n_sites=N, dt=dt, dtau=dtau, n_chains=128, loops=1000,
                      seed=6, grow_after=10**9, formulation=Formulation.BACKGROUND,
                      ghost_override=(-0.8, 0.8))
    _, st, m = _run(cfg, 25, burn_frames=10)
    assert m["stable"][-1].all()
    ours = _host(st.x_mean)
    mean, stderr = ours.mean(axis=0), ours.std(axis=0) / np.sqrt(cfg.n_chains)
    assert np.all(np.abs(mean - ref.x_mean) < 10 * stderr + 0.05), (mean[:4], ref.x_mean[:4])
    assert mean[0] < -0.05 and ref.x_mean[0] < -0.05
    assert mean[-1] > 0.05 and ref.x_mean[-1] > 0.05


# ---------------------------------------------------------------------------
# chip_smoke.py [29]: the gates at full width through the kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the gates run the CUDA kernels at full width")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gate,kw", [
    ("a", {}), ("a", dict(rng_impl="hardware")), ("b", {}), ("c", {}), ("d", {}),
    ("d", dict(rng_impl="hardware")), ("e", {}), ("f", {}), ("g", {}), ("h", {}),
])
def test_physics_gate_at_full_width(cuda_device, tmp_path, gate, kw):
    """Each gate of [29] with its limits; ``counted`` raises where a named
    kernel did not launch."""
    checks = getattr(physics_gates, f"gate_{gate}")(cuda_device, tmp_path, **kw)
    assert checks
    failed = [c.line() for c in checks if not c.passed]
    assert not failed, "\n".join(failed)


# the gates' own code on the CPU (the plain path), at widths that take seconds:
# every check is computed and finite, and no kernel launches off the card
SMALL_GATES = [
    ("a", dict(n_sites=16, dt=0.2, dtau=2e-3, n_chains=16, loops=20, frames=2)),
    ("b", dict(n_chains=8, warm=1, frames=2)),
    ("c", dict(n_sites=16, dt=0.25, dtau=2e-3, n_chains=8, loops=20, frames=2,
               oracle_runs=4)),
    ("d", dict(n_sites=16, dtau=0.02, n_chains=16, loops=20, K=2, frames=2)),
    ("e", dict(n_chains=16, n_sites=16, loops=20, K=2, frames=2, burn=2,
               grids=((4.5, 200), (5.0, 300)))),
    ("f", dict(shape=(8, 8), n_chains=4, frames=2, burn=1)),
    ("g", dict(tiled_shape=(8, 8), tiled_chains=4, nd_shape=(4, 4, 4), frames=2)),
    ("h", dict(cells=(("u1", 1.0, (4, 4), 4, 5e-3, 10, 15, 1, 2),
                      ("su3", 2.0, (4, 4), 2, 1e-3, 5, 19, 1, 2)))),
]


@pytest.mark.parametrize("gate,kw", SMALL_GATES, ids=[g for g, _ in SMALL_GATES])
def test_gate_code_runs_on_the_cpu(tmp_path, gate, kw):
    checks = getattr(physics_gates, f"gate_{gate}")(CPU, tmp_path, **kw)
    assert checks
    for c in checks:
        assert c.gate == gate and c.launches == {}
        assert all(np.isfinite(v) for v in (c.value, c.exact, c.err, c.limit)), c.line()
        assert c.limit >= 0 and f"({gate})" in c.line()
    assert not list(tmp_path.iterdir())  # the gate removes its checkpoints
