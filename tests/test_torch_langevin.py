"""The port's plain PyTorch chain integrator against the JAX package's XLA
integrator (stochquant_tpu.integrators.langevin.run_frames): same Threefry
counters and expression order, so trajectories agree to float32 rounding of
the transcendentals — the 2e-6 bar of tests/test_chain_kernel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jact
from stochquant_tpu.config import ChainConfig as JChainConfig
from stochquant_tpu.integrators import langevin as jl
from stochquant_tpu_torch import actions as tact
from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, Formulation, Scheme
from stochquant_tpu_torch.integrators import langevin as tl
from stochquant_tpu_torch.io import checkpoint

torch.set_num_threads(1)

EXACT = ("runs", "stab_cnt", "step")
CASES = {
    # the four CASES of tests/test_chain_kernel.py
    "double_well_bg": ChainConfig(action="double_well", n_sites=128, dt=0.05, dtau=0.001,
                                  n_chains=8, loops=20, seed=11),
    "harmonic_periodic": ChainConfig(action="harmonic", n_sites=128, dt=0.2, dtau=0.01,
                                     n_chains=8, loops=20, bc=BoundaryCondition.PERIODIC,
                                     formulation=Formulation.DIRECT, seed=12),
    "anharmonic_padded": ChainConfig(action="anharmonic", n_sites=100, dt=0.3, dtau=0.005,
                                     n_chains=8, loops=15, bc=BoundaryCondition.PERIODIC,
                                     formulation=Formulation.DIRECT, seed=13),
    "harmonic_dirichlet": ChainConfig(action="harmonic", n_sites=96, dt=0.2, dtau=0.01,
                                      n_chains=8, loops=10, bc=BoundaryCondition.DIRICHLET,
                                      formulation=Formulation.DIRECT, seed=14),
    # plus Heun, an odd loops count (threefry13) and a case that trips the detector
    "double_well_heun": ChainConfig(action="double_well", n_sites=64, dt=0.05, dtau=0.001,
                                    n_chains=8, loops=12, scheme=Scheme.HEUN, seed=21),
    "harmosc_odd_loops_tf13": ChainConfig(action="harmonic", n_sites=50, dt=0.1, dtau=0.002,
                                          n_chains=8, loops=11, rng_impl="threefry13",
                                          seed=22),
    "double_well_trips": ChainConfig(action="double_well", n_sites=32, dt=0.05, dtau=0.05,
                                     n_chains=8, loops=6, seed=5),
}


def jax_state(cfg, stab_cnt=None):
    jcfg = JChainConfig.from_json(cfg.to_json())
    act = jact.get(cfg.action)
    s0 = jl.init_chain_state(jcfg, act)
    if cfg.bc == BoundaryCondition.DIRICHLET:
        s0 = s0._replace(f=s0.f.at[:, 0].set(0.0).at[:, -1].set(0.0))
    if stab_cnt is not None:
        s0 = s0._replace(stab_cnt=jnp.asarray(stab_cnt, jnp.int32))
    return jcfg, act, s0


def to_port(jstate):
    return checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(jstate._fields, jstate)}, "cpu"
    )


def assert_matches_jax(got, want, tol=2e-6, label=""):
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        g = g.numpy()
        if name in EXACT:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=f"{label}:{name}")
        else:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{label}:{name}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_jax_run_frames(name):
    cfg = CASES[name]
    # stability counters 0, 3, …, 21 around grow_after=10: accepted frames
    # grow Δτ on some chains, rejected ones reset the count
    jcfg, jact_, s0 = jax_state(cfg, stab_cnt=np.arange(cfg.n_chains) * 3)
    want, wm = jl.run_frames(s0, jact_, jcfg, 3)
    got, gm = tl.run_frames(to_port(s0), tact.get(cfg.action), cfg, 3)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    np.testing.assert_allclose(gm["dtau"].numpy(), np.asarray(wm["dtau"]), rtol=2e-6)
    assert_matches_jax(got, want, label=name)
    if name == "double_well_trips":
        assert not gm["stable"].all(), "case must trip the detector"


@pytest.mark.parametrize("name", ["double_well_bg", "harmonic_periodic"])
def test_init_chain_state_matches_jax(name):
    cfg = CASES[name]
    _, _, want = jax_state(cfg)
    got = tl.init_chain_state(cfg, tact.get(cfg.action), device="cpu")
    assert got.step.device.type == "cpu" and int(got.step) == 2
    assert_matches_jax(got, want, tol=1e-6, label=name)


def test_correlator_and_reset_means_match_jax():
    cfg = CASES["double_well_bg"]
    jcfg, jact_, s0 = jax_state(cfg)
    want, _ = jl.run_frames(s0, jact_, jcfg, 2)
    got, _ = tl.run_frames(to_port(s0), tact.get(cfg.action), cfg, 2)
    np.testing.assert_allclose(tl.connected_correlator(got).numpy(),
                               np.asarray(jl.connected_correlator(want)),
                               rtol=2e-6, atol=2e-6)
    assert_matches_jax(tl.reset_means(got), jl.reset_means(want), label="reset")


@pytest.mark.parametrize("change,feature", [
    (dict(scheme=Scheme.LM), "LM"),
    (dict(scheme=Scheme.EXACT), "EXACT"),
    (dict(accumulate_spectrum=True), "accumulate_spectrum"),
    (dict(rng_impl="hardware"), "hardware"),
])
def test_unported_chain_features_raise(change, feature):
    """The name dates from when these four raised.  Each now runs on the plain
    path and matches the JAX XLA path; under rng_impl='hardware' both plain
    runners draw Threefry-20, so the trajectory is the 'threefry' one."""
    base = ChainConfig(action="harmonic", n_sites=8, n_chains=2, loops=2, dtau=0.002)
    cfg = ChainConfig(**{**base.__dict__, **change})
    jcfg, jact_, s0 = jax_state(cfg)
    want, wm = jl.run_frames(s0, jact_, jcfg, 2)
    got, gm = tl.run_frames(to_port(s0), tact.get(cfg.action), cfg, 2)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    assert gm["stable"].all()
    # EXACT: the propagators come from a float32 eigh, which the two libraries
    # compute in another order (1e-5); the others keep the 2e-6 bar
    assert_matches_jax(got, want, tol=1e-5 if feature == "EXACT" else 2e-6, label=feature)
    assert_matches_jax(tl.init_chain_state(cfg, tact.get(cfg.action), device="cpu"),
                       jl.init_chain_state(jcfg, jact_), tol=1e-6, label=feature)
    if feature == "hardware":
        plain, _ = tl.run_frames(to_port(s0), tact.get(cfg.action), base, 2)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    if feature == "accumulate_spectrum":
        assert float(got.spec_mean.abs().max()) > 0
