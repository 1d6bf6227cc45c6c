"""The port's example workflows (``stochquant_tpu_torch.examples``) on the
CPU at small sizes, each beside the JAX side built from the same calls its
JAX script (``examples/*.py``, neither imported nor edited) makes, on the
same seed.  On CPU tensors the kernel wrappers the port's modules call run
their plain versions.

Bars (the module tests'): the correlator 2e-6 and the gap fit rtol 1e-4
(``tests/test_torch_langevin.py``: the trajectory to float32 rounding; the
fit is a smooth function of the correlator); site means (⟨|M|⟩, ⟨φ²⟩) rtol
3e-5 / atol 3e-6, χ and the Binder cumulant rtol 1e-4 / atol 1e-6
(``tests/test_torch_field.py``); the scheme ladder's closed forms 1e-9 (both
float64 numpy) and the EXACT run's ⟨x²⟩ rtol 5e-4 (two float32 ``eigh``:
PERF.md §2); ``sharded_4d_scaling``'s placements bitwise the port's unsplit
run, and its unsplit φ 2e-6 from the JAX unsplit run."""

import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu_torch.examples import (
    binder_crossing,
    energy_gap,
    phi4_phase_scan,
    scheme_bias_ladder,
    sharded_4d_scaling,
)

torch.set_num_threads(1)


def test_energy_gap_matches_the_jax_workflow(capsys):
    from stochquant_tpu import actions
    from stochquant_tpu.config import BoundaryCondition, ChainConfig, Formulation
    from stochquant_tpu.integrators import langevin
    from stochquant_tpu.observables import analysis

    sizes = dict(n_sites=32, n_chains=16, loops=20, burn_frames=3, frames=6)
    got = energy_gap.main("cpu", **sizes)
    assert "fitted gap  E1-E0" in capsys.readouterr().out
    cfg = ChainConfig(action="harmonic", n_sites=32, dt=0.25, dtau=0.01, n_chains=16, loops=20,
                      bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT, seed=1,
                      grow_after=10**9)
    act = actions.get(cfg.action)
    state = langevin.init_chain_state(cfg, act)
    state, _ = langevin.run_frames(state, act, cfg, 3)
    state = langevin.reset_means(state)
    state, metrics = langevin.run_frames(state, act, cfg, 6)
    assert np.asarray(metrics["stable"])[-1].all()
    corr = np.asarray(langevin.connected_correlator(state), np.float64)
    mean = corr.mean(axis=0)
    fit = analysis.energy_gap_from_correlator(
        mean, cfg.dt, corr_err=corr.std(axis=0) / np.sqrt(cfg.n_chains))
    np.testing.assert_allclose(got["corr_mean"], mean, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose([got["gap"], got["gap_err"]], [fit.gap, fit.gap_err], rtol=1e-4)
    assert got["e_lat"] == pytest.approx(2.0 / cfg.dt * np.arcsinh(0.5 * cfg.dt * act.omega0))


def _jax_field_run(cfg_kw, m2, burn, frames):
    """The JAX scripts' field run: init, burn, reset, frames."""
    from stochquant_tpu.actions import phi4
    from stochquant_tpu.config import FieldConfig, Sweep
    from stochquant_tpu.integrators import field

    cfg = FieldConfig(action="phi4", dtau=0.02, grow_after=10**9, sweep=Sweep.CHECKERBOARD,
                      **cfg_kw)
    act = phi4.get_field("phi4", m2=m2, lam=6.0)
    state = field.init_field_state(cfg)
    state, _ = field.run_field_frames(state, act, cfg, burn)
    state = field.reset_field_means(state)
    state, _ = field.run_field_frames(state, act, cfg, frames)
    return state, field


SMALL = dict(n_chains=4, loops=20, burn_frames=2, frames=4)


def test_binder_crossing_matches_the_jax_workflow(capsys):
    sizes, m2s = (4, 8), (-1.0,)
    got = binder_crossing.main("cpu", sizes=sizes, m2s=m2s, **SMALL)
    assert "U(L=8)" in capsys.readouterr().out
    for m2 in m2s:
        for L in sizes:
            state, field = _jax_field_run(dict(shape=(L, L), n_chains=4, loops=20, seed=13),
                                          m2, 2, 4)
            u = np.asarray(field.binder_cumulant(state), np.float64)
            np.testing.assert_allclose(got[m2, L], [u.mean(), u.std() / np.sqrt(4)],
                                       rtol=1e-4, atol=1e-6, err_msg=str((m2, L)))


def test_phi4_phase_scan_matches_the_jax_workflow(capsys):
    m2s = (1.0, -3.0)
    got = phi4_phase_scan.main("cpu", L=8, m2s=m2s, **SMALL)
    assert "<|M|>" in capsys.readouterr().out
    for m2 in m2s:
        state, field = _jax_field_run(dict(shape=(8, 8), n_chains=4, loops=20, seed=11), m2, 2, 4)
        absmag, chi, p2 = got[m2]
        np.testing.assert_allclose([absmag, p2], [np.asarray(state.absmag_mean).mean(),
                                                  np.asarray(state.phi2_mean).mean()],
                                   rtol=3e-5, atol=3e-6)
        np.testing.assert_allclose(chi, np.asarray(field.susceptibility(state, 64)).mean(),
                                   rtol=1e-4, atol=1e-6)


def test_scheme_bias_ladder_matches_the_jax_workflow(capsys):
    from stochquant_tpu import actions
    from stochquant_tpu.config import BoundaryCondition, ChainConfig, Formulation, Scheme
    from stochquant_tpu.integrators import langevin
    from stochquant_tpu.observables import exact

    got = scheme_bias_ladder.main("cpu", n_sites=16, n_chains=32, loops=10, burn_frames=1,
                                  frames=4)
    assert "EXACT scheme at dtau" in capsys.readouterr().out
    B = exact.harmonic_drift_matrix(16, 0.2, bc=BoundaryCondition.PERIODIC)
    b_max = float(np.linalg.eigvalsh(B).max())
    target = float(np.diag(exact.target_cov(B, 0.2)).mean())
    assert got["b_max"] == pytest.approx(b_max, rel=1e-9)
    assert got["target"] == pytest.approx(target, rel=1e-9)
    for frac, biases in got["ladder"].items():
        want = [float(np.diag(fn(B, 0.2, frac / b_max)).mean()) / target - 1.0
                for fn in (exact.em_stationary_cov, exact.heun_stationary_cov,
                           exact.lm_stationary_cov)]
        np.testing.assert_allclose(biases, want, rtol=1e-9, atol=1e-12)
    cfg = ChainConfig(action="harmonic", n_sites=16, dt=0.2, dtau=80.0 / b_max, n_chains=32,
                      loops=10, seed=11, scheme=Scheme.EXACT, formulation=Formulation.BACKGROUND,
                      bc=BoundaryCondition.PERIODIC)
    act = actions.get("harmonic")
    s = langevin.init_chain_state(cfg, act)
    s, _ = langevin.run_frames(s, act, cfg, 1)
    s = langevin.reset_means(s)
    s, m = langevin.run_frames(s, act, cfg, 4)
    assert np.all(np.asarray(m["stable"]))
    x2 = np.asarray(s.x2_mean, np.float64)
    assert got["est"] == pytest.approx(x2.mean(), rel=5e-4)
    assert got["se"] == pytest.approx(x2.mean(1).std() / np.sqrt(32), rel=5e-3)


def test_sharded_4d_scaling_places_bitwise_and_matches_the_jax_workflow(capsys):
    """The port's three placements bitwise its unsplit run (the module
    asserts it), and its unsplit run beside the JAX script's: the XLA
    reference, and the JAX placements (Pallas in interpret mode on the 8
    virtual CPU devices of tests/conftest.py) bitwise that reference."""
    from stochquant_tpu.actions import phi4
    from stochquant_tpu.config import FieldConfig
    from stochquant_tpu.integrators import field
    from stochquant_tpu.parallel import make_mesh, shard_field_state
    from stochquant_tpu.parallel.halo import make_halo_runner

    shape = (16, 8, 4, 8)
    got = sharded_4d_scaling.main("cpu", shape=shape, loops=4, frames=1)
    assert capsys.readouterr().out.count("bitwise=YES") == 3
    assert all(p["bitwise"] and p["devices"] == 8 for p in got["placements"].values())
    base = FieldConfig(action="phi4", shape=shape, dtau=0.005, n_chains=2, loops=4, seed=42,
                       grow_after=10**9)
    act = phi4.get_field(base.action)
    s0 = field.init_field_state(base)
    ref, _ = field.run_field_frames(s0, act, base, 1)
    assert got["phi2"] == pytest.approx(float(np.asarray(ref.phi2_mean).mean()), rel=3e-5)
    for _, axes, mesh_shape, chain_ax in sharded_4d_scaling.GEOMETRIES:
        cfg = dataclasses.replace(base, mesh_axes=axes, mesh_chain_axis=chain_ax)
        mesh = make_mesh(mesh_shape)
        out, _ = make_halo_runner(act, cfg, mesh, backend="pallas", interpret=True)(
            shard_field_state(s0, mesh, cfg), 1)
        assert np.array_equal(np.asarray(ref.phi), np.asarray(out.phi))


def test_sharded_4d_scaling_unsplit_phi_matches_jax():
    """The port's unsplit reference φ (kernel 6's plain version) against the
    JAX XLA run of the script's first call, to float32 rounding."""
    from stochquant_tpu.actions import phi4
    from stochquant_tpu.config import FieldConfig
    from stochquant_tpu.integrators import field
    from stochquant_tpu_torch import actions
    from stochquant_tpu_torch.config import FieldConfig as TFieldConfig
    from stochquant_tpu_torch.integrators import field as tfield
    from stochquant_tpu_torch.kernels import field_kernel_nd

    kw = dict(action="phi4", shape=(16, 8, 4, 8), dtau=0.005, n_chains=2, loops=4, seed=42,
              grow_after=10**9)
    ref, _ = field.run_field_frames(field.init_field_state(FieldConfig(**kw)),
                                    phi4.get_field("phi4"), FieldConfig(**kw), 1)
    cfg = TFieldConfig(**kw)
    got, _ = field_kernel_nd.run_field_frames_nd(tfield.init_field_state(cfg, device="cpu"),
                                                 actions.get_field("phi4"), cfg, 1)
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(ref.phi), rtol=2e-6, atol=2e-6)
