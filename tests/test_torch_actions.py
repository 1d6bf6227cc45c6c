"""The port's actions match the JAX package's, and the hand-derived
derivatives match autograd."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jact
from stochquant_tpu_torch import actions as tact
from stochquant_tpu_torch.actions.base import QMAction

torch.set_num_threads(1)

NAMES = ["harmonic", "double_well", "anharmonic", "poeschl_teller"]


def _x(seed=0, n=257):
    return np.random.RandomState(seed).uniform(-1.5, 1.5, size=n).astype(np.float32)


def test_registries_match():
    assert tact.names() == ["anharmonic", "double_well", "harmonic", "poeschl_teller"]
    for name in NAMES:
        assert name in jact.names()


@pytest.mark.parametrize("name", NAMES)
def test_potential_and_derivatives_match_jax(name):
    ja, ta = jact.get(name), tact.get(name)
    x = _x()
    for fn in ("V", "dV", "ddV"):
        want = np.asarray(getattr(ja, fn)(jnp.asarray(x)))
        got = getattr(ta, fn)(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, x.shape),
                                   rtol=1e-6, atol=1e-6, err_msg=f"{name}.{fn}")


@pytest.mark.parametrize("name", NAMES)
def test_background_constants_match_jax(name):
    ja, ta = jact.get(name), tact.get(name)
    assert ja.has_zero_mode == ta.has_zero_mode
    assert ja.zero_mode_const() == ta.zero_mode_const()
    for side in (-1, 1):
        assert ja.boundary_asymptote(side) == ta.boundary_asymptote(side)
    t = (np.arange(200) * np.float32(0.02)).astype(np.float32)
    om = np.random.RandomState(1).uniform(0.0, 4.0, size=(8, 1)).astype(np.float32)
    want = np.asarray(ja.x_cl(jnp.asarray(t)[None, :], jnp.asarray(om)))
    got = ta.x_cl(torch.from_numpy(t)[None, :], torch.from_numpy(om))
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, (8, 200)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["harmonic", "double_well", "anharmonic"])
def test_hand_derivatives_match_autograd(name):
    act = tact.get(name)
    x = torch.from_numpy(_x(2).astype(np.float64))
    torch.testing.assert_close(act.dV(x), QMAction.dV(act, x), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(
        torch.broadcast_to(act.ddV(x), x.shape), QMAction.ddV(act, x), rtol=1e-12, atol=1e-12
    )


def test_poeschl_teller_autograd_matches_closed_form():
    act = tact.get("poeschl_teller")
    x = torch.from_numpy(_x(3).astype(np.float64))
    u = x / act.a
    dv = 2.0 * act.v0 * torch.sinh(u) / (act.a * torch.cosh(u) ** 3)
    ddv = 2.0 * act.v0 / act.a**2 * (1.0 - 2.0 * torch.sinh(u) ** 2) / torch.cosh(u) ** 4
    torch.testing.assert_close(act.dV(x), dv, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(act.ddV(x), ddv, rtol=1e-12, atol=1e-12)
