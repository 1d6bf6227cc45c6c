"""The port's statistical analysis (``observables.analysis``): the seven
cases of ``tests/test_analysis.py``, each output also equal to the JAX
package's on the same seeded input, and the same values from a PyTorch
tensor.  Tolerances: the statistical ones of the JAX tests; port against JAX
exactly (the same float64 numpy code)."""

import numpy as np
import torch

from stochquant_tpu.observables import analysis as janalysis
from stochquant_tpu_torch.observables import analysis


def _ar1(seed, rho, n, scale=1.0):
    rng = np.random.default_rng(seed)
    x = np.empty(n)
    x[0] = 0
    eps = rng.normal(size=n)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + scale * eps[i]
    return x


def test_autocorr_time_ar1():
    rho = 0.9
    x = _ar1(0, rho, 200000)
    tau = analysis.autocorr_time(x)
    expect = (1 + rho) / (2 * (1 - rho))  # 9.5 at rho = 0.9
    assert abs(tau - expect) / expect < 0.25, (tau, expect)
    assert tau == janalysis.autocorr_time(x) == analysis.autocorr_time(torch.from_numpy(x))


def test_autocorr_time_white_noise():
    x = np.random.default_rng(1).normal(size=50000)
    tau = analysis.autocorr_time(x)
    assert 0.3 < tau < 0.8 and tau == janalysis.autocorr_time(x)
    assert analysis.autocorr_time(np.zeros(8)) == 0.5


def test_binned_jackknife_matches_naive_for_iid():
    x = np.random.default_rng(2).normal(loc=3.0, size=40000)
    mean, err = analysis.binned_jackknife(x, bin_size=1)
    assert abs(mean - 3.0) < 5 * err
    naive = x.std(ddof=1) / np.sqrt(len(x))
    assert abs(err - naive) / naive < 0.1
    assert (mean, err) == janalysis.binned_jackknife(x, bin_size=1)
    assert analysis.binned_jackknife(x[:3], bin_size=2) == janalysis.binned_jackknife(x[:3], 2)


def test_jackknife_inflates_error_for_correlated_series():
    rho = 0.95
    x = _ar1(3, rho, 100000, np.sqrt(1 - rho**2))
    _, err_auto = analysis.binned_jackknife(x)  # autocorrelation-aware
    _, err_naive = analysis.binned_jackknife(x, bin_size=1)
    assert err_auto > 3 * err_naive  # τ_int ≈ 19.5 → ~6x inflation
    assert analysis.binned_jackknife(torch.from_numpy(x)) == janalysis.binned_jackknife(x)


def test_energy_gap_synthetic_exponential():
    n, dt, gap = 64, 0.25, 1.3
    t = np.abs(np.arange(n) - n // 2) * dt
    corr = 0.7 * np.exp(-gap * t)
    fit = analysis.energy_gap_from_correlator(corr, dt)
    assert abs(fit.gap - gap) < 1e-6 and abs(fit.amplitude - 0.7) < 1e-6
    assert tuple(fit) == tuple(janalysis.energy_gap_from_correlator(corr, dt))
    err = 0.01 * corr
    assert tuple(analysis.energy_gap_from_correlator(corr, dt, fit_range=(4, 20), corr_err=err)) \
        == tuple(janalysis.energy_gap_from_correlator(corr, dt, fit_range=(4, 20), corr_err=err))


def test_energy_gap_harmonic_oscillator_em():
    """The gap from the exact EM covariance row of the harmonic chain
    approaches ω₀ = √2 (continuum E₁ − E₀) at fine Δt."""
    from stochquant_tpu.config import BoundaryCondition
    from stochquant_tpu.observables import exact

    N, dt = 128, 0.1
    B = exact.harmonic_drift_matrix(N, dt, k=2.0, bc=BoundaryCondition.PERIODIC)
    corr = exact.target_cov(B, dt)[:, N // 2]
    fit = analysis.energy_gap_from_correlator(corr, dt)
    assert abs(fit.gap - np.sqrt(2.0)) < 0.05, fit
    assert tuple(fit) == tuple(janalysis.energy_gap_from_correlator(corr, dt))
    # a float32 correlator on a tensor, as the port's state holds it
    c32 = torch.from_numpy(np.asarray(corr, np.float32))
    assert tuple(analysis.energy_gap_from_correlator(c32, dt)) == tuple(
        janalysis.energy_gap_from_correlator(c32.numpy(), dt))


def test_cross_chain_error():
    v = np.random.default_rng(5).normal(loc=1.5, size=256)
    mean, err = analysis.cross_chain_error(v)
    assert abs(mean - 1.5) < 5 * err
    assert (mean, err) == janalysis.cross_chain_error(v) == analysis.cross_chain_error(
        torch.from_numpy(v))


def test_timing_helpers_take_the_median_and_time_in_turns():
    from stochquant_tpu_torch import timing

    calls = []
    med, lo, hi = timing.timeit(lambda: calls.append("a"), reps=3)
    assert calls == ["a"] * 4 and lo <= med <= hi
    calls.clear()
    out = timing.ab_timeit({"a": lambda: calls.append("a"), "b": lambda: calls.append("b")}, reps=2)
    assert calls == ["a", "b", "a", "b", "a", "b"] and set(out) == {"a", "b"}
