"""The port's scalar-field actions against the JAX package's
(stochquant_tpu.actions.phi4): potential, derivatives, drift, action density
and action on the same numpy-made fields, in 2-D and 4-D."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.actions import phi4 as tphi4

torch.set_num_threads(1)

ACTIONS = [
    ("phi4", {}),
    ("phi4", {"m2": -0.7, "lam": 2.4}),  # the broken phase
    ("free_field", {"m2": 0.3}),
]
TOL = dict(rtol=2e-6, atol=2e-6)


def _field(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 1.3).astype(np.float32)


def _both(name, params):
    return jphi4.get_field(name, **params), tphi4.get_field(name, **params)


@pytest.mark.parametrize("name,params", ACTIONS)
def test_potential_and_derivatives_match_jax(name, params):
    phi = _field((3, 16, 12), 1)
    ja, ta = _both(name, params)
    for method in ("V", "dV", "dV_int"):
        got = getattr(ta, method)(torch.from_numpy(phi))
        assert got.dtype == torch.float32, method
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ja, method)(jnp.asarray(phi))),
                                   err_msg=method, **TOL)


@pytest.mark.parametrize("name,params", ACTIONS)
@pytest.mark.parametrize("shape,spacing", [((2, 16, 12), 1.0), ((2, 4, 3, 4, 5), 0.7)])
def test_drift_density_and_action_match_jax(name, params, shape, spacing):
    phi = _field(shape, 2)
    ndim = len(shape) - 1
    ja, ta = _both(name, params)
    t, j = torch.from_numpy(phi), jnp.asarray(phi)
    for method in ("drift", "action_density", "action"):
        np.testing.assert_allclose(
            getattr(ta, method)(t, spacing, ndim).numpy(),
            np.asarray(getattr(ja, method)(j, spacing, ndim)), err_msg=method, **TOL,
        )
    np.testing.assert_allclose(tphi4.periodic_laplacian(t, spacing, ndim).numpy(),
                               np.asarray(jphi4.periodic_laplacian(j, spacing, ndim)), **TOL)


def test_default_derivative_is_the_gradient_of_V():
    @dataclasses.dataclass(frozen=True)
    class Quartic(tphi4.FieldAction):
        m2: float = 0.5
        lam: float = 1.5

        def V(self, phi):
            return tphi4.ScalarPhi4(self.m2, self.lam).V(phi)

    phi = torch.from_numpy(_field((2, 8, 8), 3))
    np.testing.assert_allclose(Quartic().dV(phi).numpy(),
                               tphi4.ScalarPhi4(0.5, 1.5).dV(phi).numpy(), rtol=1e-5, atol=1e-5)


def test_registry_matches_jax():
    assert actions.field_names() == jphi4.field_names() == ["free_field", "phi4"]
    assert isinstance(actions.get_field("phi4", m2=-1.0), actions.ScalarPhi4)
    with pytest.raises(KeyError, match="known"):
        actions.get_field("sine_gordon")
