"""The port's exact answers (``stochquant_tpu_torch.observables.exact``)
against the JAX package's (``stochquant_tpu.observables.exact``): both are
float64 numpy on the host, so every function agrees within rtol 1e-12 on
the same inputs."""

import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jax_actions
from stochquant_tpu.config import BoundaryCondition as JaxBC
from stochquant_tpu.observables import exact as jexact
from stochquant_tpu_torch import actions
from stochquant_tpu_torch import observables
from stochquant_tpu_torch.config import BoundaryCondition
from stochquant_tpu_torch.observables import exact

torch.set_num_threads(1)

RTOL = 1e-12
BCS = ("PERIODIC", "DIRICHLET", "FIXED_BG")
DRIFT_CASES = [(32, 0.25, 2.0, 1.0), (64, 0.1, 1.5, 0.7), (200, 0.02, 2.0, 1.0)]


def _matrices(n, dt, k, mass, bc):
    return (exact.harmonic_drift_matrix(n, dt, k, mass, BoundaryCondition[bc]),
            jexact.harmonic_drift_matrix(n, dt, k, mass, JaxBC[bc]))


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("n,dt,k,mass", DRIFT_CASES)
def test_harmonic_drift_matrix(n, dt, k, mass, bc):
    got, want = _matrices(n, dt, k, mass, bc)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", ["em_stationary_cov", "heun_stationary_cov",
                                  "lm_stationary_cov"])
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("n,dt,k,mass", DRIFT_CASES)
def test_stationary_covariances(name, n, dt, k, mass, bc):
    B, _ = _matrices(n, dt, k, mass, bc)
    dtau = 1.5 / (4.0 * mass / dt**2 + k)  # Δτ·b_max ≈ 1.5: a large, stable step
    got = getattr(exact, name)(B, dt, dtau)
    want = getattr(jexact, name)(B, dt, dtau)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    np.testing.assert_allclose(exact.target_cov(B, dt), jexact.target_cov(B, dt),
                               rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("name", ["em_stationary_cov", "heun_stationary_cov",
                                  "lm_stationary_cov"])
def test_unstable_step_raises_in_both(name):
    B, _ = _matrices(32, 0.25, 2.0, 1.0, "PERIODIC")
    dtau = 2.5 / np.linalg.eigvalsh(B).max()
    for mod in (exact, jexact):
        with pytest.raises(ValueError, match="unstable"):
            getattr(mod, name)(B, 0.25, dtau)


@pytest.mark.parametrize("k,mass", [(2.0, 1.0), (0.5, 2.0), (3.0, 0.25)])
def test_harmonic_x2_continuum(k, mass):
    got = exact.harmonic_x2_continuum(k, mass)
    assert got == pytest.approx(jexact.harmonic_x2_continuum(k, mass), rel=RTOL)


@pytest.mark.parametrize("shape,spacing,m2,dtau", [
    ((16, 16), 1.0, 1.0, 0.05), ((256, 256), 1.0, 1.0, 0.05), ((12, 12), 1.0, 0.5, 0.0),
    ((8, 8, 8), 0.5, 2.0, 0.01), ((32, 32, 32, 32), 1.0, 1.0, 0.05), ((1024,), 0.25, 4.0, 0.003),
])
def test_free_field_x2(shape, spacing, m2, dtau):
    got = exact.free_field_x2(shape, spacing, m2, dtau)
    assert got == pytest.approx(jexact.free_field_x2(shape, spacing, m2, dtau), rel=RTOL)


def test_free_field_x2_unstable_raises_in_both():
    for mod in (exact, jexact):
        with pytest.raises(ValueError, match="unstable"):
            mod.free_field_x2((8, 8), 1.0, 1.0, dtau=0.3)


@pytest.mark.parametrize("name,n,dt,dtau,omega,ghosts", [
    # tests/test_background_moments.py:60's geometry, ω at the centre
    ("double_well", 24, 0.05, 5e-4, 0.5 * 23 * 0.05, None),
    ("double_well", 24, 0.05, 5e-4, 0.4, None),
    ("double_well", 32, 0.05, 1e-4, 0.8, (-0.8, 0.8)),
    ("harmonic", 32, 0.25, 2e-3, 0.0, (-0.8, 0.8)),  # tests/test_oracle.py:87's ghosts
])
def test_background_gaussian_moments(name, n, dt, dtau, omega, ghosts):
    got = exact.background_gaussian_moments(actions.get(name), n, dt, dtau, omega, ghosts)
    want = jexact.background_gaussian_moments(jax_actions.get(name), n, dt, dtau, omega, ghosts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * np.abs(w).max())


def _potential(pkg_actions, name, torch_side):
    act = pkg_actions.get(name)
    if torch_side:
        return lambda x: act.V(torch.as_tensor(x)).numpy()
    return lambda x: np.asarray(act.V(x))


@pytest.mark.parametrize("name,n,dt,kw", [
    ("anharmonic", 64, 0.25, {}),                              # tests/test_physics_regression.py:88
    ("anharmonic", 1024, 0.25, dict(n_grid=1200, x_max=5.0)),  # config 2, the grid check
    ("double_well", 48, 0.25, dict(x_max=3.0, n_grid=600)),
    ("harmonic", 16, 0.4, {}),
])
def test_transfer_matrix_moments(name, n, dt, kw):
    got = exact.transfer_matrix_moments(_potential(actions, name, True), n, dt, **kw)
    want = jexact.transfer_matrix_moments(_potential(jax_actions, name, False), n, dt, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_package_reexports_the_jax_packages_names():
    from stochquant_tpu import observables as jobs

    names = ("em_stationary_cov", "free_field_x2", "harmonic_drift_matrix",
             "harmonic_x2_continuum", "target_cov", "creutz_ratio", "polyakov_loop",
             "wilson_flow", "wilson_loop", "wilson_loop_table")
    for name in names:
        assert hasattr(jobs, name)
        assert callable(getattr(observables, name)), name
    assert observables.em_stationary_cov is exact.em_stationary_cov
