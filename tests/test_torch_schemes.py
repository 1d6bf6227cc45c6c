"""The port's plain-path schemes against the JAX package's: Scheme.LM,
Scheme.EXACT (chains under the three boundary conditions; fields as the
exact free propagator and as ETD1), the power-spectrum channel and the
translation-averaged correlator.  Same inputs through both, tolerance stated
per test; the exact-covariance cases of tests/test_exact_scheme.py run through
the port at a small size."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jact
from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import ChainConfig as JChainConfig
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu.integrators import langevin as jl
from stochquant_tpu.observables import exact
from stochquant_tpu_torch import actions as tact
from stochquant_tpu_torch.actions import phi4 as tphi4
from stochquant_tpu_torch.config import (
    BoundaryCondition,
    ChainConfig,
    FieldConfig,
    Formulation,
    Scheme,
    Sweep,
)
from stochquant_tpu_torch.integrators import field as tfield
from stochquant_tpu_torch.integrators import langevin as tl
from stochquant_tpu_torch.io import checkpoint

torch.set_num_threads(1)

EXACT_LEAVES = ("runs", "stab_cnt", "step")
PERIODIC, FIXED_BG, DIRICHLET = (BoundaryCondition.PERIODIC, BoundaryCondition.FIXED_BG,
                                 BoundaryCondition.DIRICHLET)


def jax_chain(cfg):
    jcfg = JChainConfig.from_json(cfg.to_json())
    act = jact.get(cfg.action)
    s0 = jl.init_chain_state(jcfg, act)
    if cfg.bc == DIRICHLET:
        s0 = s0._replace(f=s0.f.at[:, 0].set(0.0).at[:, -1].set(0.0))
    return jcfg, act, s0


def to_port(jstate):
    return checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(jstate._fields, jstate)}, "cpu")


def assert_state(got, want, tol, label=""):
    for name, g, w in zip(got._fields, got, want):
        w, g = np.asarray(w), g.numpy()
        if name in EXACT_LEAVES:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=f"{label}:{name}")
        else:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{label}:{name}")


# ---------------------------------------------------------------------------
# Scheme.LM
# ---------------------------------------------------------------------------

LM_CASES = {
    # the kink background with its collective coordinate: ω's noise is averaged too
    "double_well_bg": ChainConfig(action="double_well", n_sites=24, dt=0.1, dtau=1e-3, n_chains=4,
                                  loops=10, seed=5, scheme=Scheme.LM),
    "harmonic_periodic": ChainConfig(action="harmonic", n_sites=32, dt=0.25, dtau=0.02,
                                     n_chains=4, loops=8, bc=PERIODIC,
                                     formulation=Formulation.DIRECT, seed=99, scheme=Scheme.LM),
    "anharmonic_tf13": ChainConfig(action="anharmonic", n_sites=20, dt=0.3, dtau=0.005,
                                   n_chains=3, loops=6, bc=PERIODIC, rng_impl="threefry13",
                                   formulation=Formulation.DIRECT, seed=13, scheme=Scheme.LM),
}


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_lm_matches_jax(name):
    """Float32 trajectories on the same Threefry counters: 2e-6, the bar of the
    EM and Heun comparisons."""
    cfg = LM_CASES[name]
    jcfg, act, s0 = jax_chain(cfg)
    want, wm = jl.run_frames(s0, act, jcfg, 3)
    got, gm = tl.run_frames(to_port(s0), tact.get(cfg.action), cfg, 3)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    assert_state(got, want, 2e-6, name)


def test_lm_frame_split_and_checkpoint_resume_are_bitwise(tmp_path):
    """The pair drawn ahead is drawn again by the next frame from the same
    counters: 2 frames ≡ 1 + 1, also through a checkpoint on disk."""
    cfg = LM_CASES["double_well_bg"]
    act = tact.get(cfg.action)
    s0 = tl.init_chain_state(cfg, act, device="cpu")
    a2, _ = tl.run_frames(s0, act, cfg, 2)
    b1, _ = tl.run_frames(s0, act, cfg, 1)
    checkpoint.save(tmp_path / "lm.npz", b1, cfg)
    loaded, lcfg = checkpoint.load(tmp_path / "lm.npz", "cpu")
    assert lcfg == cfg
    b2, _ = tl.run_frames(loaded, act, cfg, 1)
    for name, x, y in zip(a2._fields, a2, b2):
        assert torch.equal(x, y), name


def test_lm_requires_even_loops():
    cfg = ChainConfig(action="harmonic", n_sites=8, loops=3, scheme=Scheme.LM)
    act = tact.get(cfg.action)
    state = tl.init_chain_state(dataclasses.replace(cfg, loops=2), act, device="cpu")
    with pytest.raises(ValueError, match="even"):
        tl.run_frames(state, act, cfg, 1)
    with pytest.raises(ValueError, match="even"):
        tl.frame_sums(state, act, cfg)


# ---------------------------------------------------------------------------
# Scheme.EXACT, chains
# ---------------------------------------------------------------------------

def exact_cfg(bc, dtype="float32", **kw):
    base = dict(action="harmonic", n_sites=16, dt=0.1, dtau=2.0, n_chains=3, loops=4, seed=41,
                scheme=Scheme.EXACT, formulation=Formulation.BACKGROUND, bc=bc, dtype=dtype)
    if bc == FIXED_BG:
        base.update(action="double_well", dt=0.05, dtau=1.0, parisi=False, seed=7)
    base.update(kw)
    return ChainConfig(**base)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("float64", 1e-11)])
@pytest.mark.parametrize("bc", [PERIODIC, FIXED_BG, DIRICHLET], ids=lambda b: b.name)
def test_exact_propagator_ops_match_jax(bc, dtype, tol):
    """P, S and μ (never U: the two eigh differ in sign and, under PERIODIC's
    doubly degenerate λ, in the basis).  float32: 2e-4 absolute on entries of
    order 1 (a float32 eigh of a matrix with λ up to 4·m/Δt² ≈ 1600 resolves
    its small eigenvalues to about λ_max·2⁻²⁴ in either library); float64: 1e-11."""
    cfg = exact_cfg(bc, dtype)
    jcfg, act, s0 = jax_chain(cfg)
    dtau = np.linspace(0.5, 2.0, cfg.n_chains)
    want = jl.exact_propagator_ops(act, jcfg, s0.omega, jnp.asarray(dtau, s0.f.dtype))
    got = tl.exact_propagator_ops(tact.get(cfg.action), cfg, to_port(s0).omega,
                                  torch.tensor(dtau, dtype=cfg.torch_dtype))
    for name, g, w in zip(("P", "S", "mu"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    if bc == DIRICHLET:
        P, S, _ = got
        assert not P[:, 0].any() and not P[:, :, -1].any() and not S[:, -1].any()


def test_exact_propagator_zero_mode_takes_the_diffusive_limit():
    """A massless periodic chain has λ₀ = 0 (below the 1e-8 threshold in both
    packages): its variance is the diffusive 2Δτ·c²/Δt, not 0/0."""

    class Massless(tact.HarmonicOscillator):
        def ddV(self, x):
            return torch.zeros_like(x)

    class JMassless(jact.HarmonicOscillator):
        def ddV(self, x):
            return jnp.zeros_like(x)

    cfg = exact_cfg(PERIODIC, "float64", n_sites=8, dtau=0.3)
    jcfg = JChainConfig.from_json(cfg.to_json())
    om = np.zeros(cfg.n_chains)
    want = jl.exact_propagator_ops(JMassless(), jcfg, jnp.asarray(om))
    got = tl.exact_propagator_ops(Massless(), cfg, torch.tensor(om))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-9)
    # the uniform mode diffuses: 1ᵀ S 1 / N = sqrt(2 Δτ c² / Δt)
    S = got[1][0].numpy()
    np.testing.assert_allclose(S.sum() / cfg.n_sites,
                               np.sqrt(2 * cfg.dtau * cfg.noise_amp**2 / cfg.dt), rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("float64", 2e-6)])
@pytest.mark.parametrize("bc", [PERIODIC, FIXED_BG, DIRICHLET], ids=lambda b: b.name)
def test_exact_run_frames_match_jax(bc, dtype, tol):
    """Trajectories under the exact propagator, Δτ far beyond EM's stability.
    float32 inherits the propagators' 2e-4 (the state is O(1), a few steps);
    float64 has exact propagators (1e-11 above) and is left with the normals,
    which are float32 draws in both packages and differ in the last place of
    their transcendentals: 2e-6, the bar of the EM comparisons.  Δτ stays
    frozen and every frame is accepted."""
    cfg = exact_cfg(bc, dtype)
    jcfg, act, s0 = jax_chain(cfg)
    want, wm = jl.run_frames(s0, act, jcfg, 2)
    got, gm = tl.run_frames(to_port(s0), tact.get(cfg.action), cfg, 2)
    assert gm["stable"].all() and np.asarray(wm["stable"]).all()
    assert torch.equal(got.dtau, to_port(s0).dtau)
    assert_state(got, want, tol, bc.name)
    if bc == DIRICHLET:
        assert not got.f[:, 0].any() and not got.f[:, -1].any()


@pytest.mark.parametrize("change,match", [
    (dict(action="anharmonic", formulation=Formulation.DIRECT, bc=PERIODIC), "BACKGROUND"),
    (dict(action="double_well", parisi=True), "parisi"),
])
def test_exact_scheme_validation_surfaces(change, match):
    cfg = ChainConfig(n_sites=8, n_chains=2, loops=2, scheme=Scheme.EXACT, **change)
    act = tact.get(cfg.action)
    state = tl.init_chain_state(cfg, act, device="cpu")
    with pytest.raises(ValueError, match=match):
        tl.run_frames(state, act, cfg, 1)
    with pytest.raises(ValueError, match=match):
        tl.check_supported(cfg, act)
    with pytest.raises(ValueError, match=match):
        jl.make_frame_fn(jact.get(cfg.action), JChainConfig.from_json(cfg.to_json()))


def _z(sim, theory, n_chains):
    return np.abs(sim.mean(0) - theory) / (sim.std(0) / np.sqrt(n_chains) + 1e-12)


def _equilibrate(cfg, burn, frames, omega=None):
    act = tact.get(cfg.action)
    s = tl.init_chain_state(cfg, act, device="cpu")
    if omega is not None:
        s = s._replace(omega=torch.full_like(s.omega, omega))
    s, _ = tl.run_frames(s, act, cfg, burn)
    s, m = tl.run_frames(tl.reset_means(s), act, cfg, frames)
    assert m["stable"].all()
    assert torch.equal(s.dtau, torch.full((cfg.n_chains,), cfg.dtau))  # EXACT never adapts Δτ
    return s


@pytest.mark.parametrize("bc,seed", [(PERIODIC, 41), (DIRICHLET, 43)], ids=["PERIODIC", "DIRICHLET"])
def test_exact_scheme_hits_target_cov_at_huge_dtau(bc, seed):
    """tests/test_exact_scheme.py's gates at half its lattice: Δτ·λ_max ≈ 400,
    where EM, Heun and LM explode; ⟨x²⟩ against diag(B⁻¹)/Δt and ⟨x⁴⟩ against
    3σ⁴ per site within 6 standard errors; DIRICHLET edges pinned at 0."""
    cfg = exact_cfg(bc, n_sites=16, n_chains=128, loops=20, seed=seed)
    B = exact.harmonic_drift_matrix(cfg.n_sites, cfg.dt, bc=cfg.bc)
    assert cfg.dtau * np.linalg.eigvalsh(B).max() > 100.0
    s = _equilibrate(cfg, burn=3, frames=30)
    sig2 = np.diag(exact.target_cov(B, cfg.dt))
    x2, x4 = s.x2_mean.double().numpy(), s.x4_mean.double().numpy()
    if bc == DIRICHLET:
        assert not s.f[:, 0].any() and not s.f[:, -1].any()
        x2, x4 = x2[:, 1:-1], x4[:, 1:-1]
    assert _z(x2, sig2, cfg.n_chains).max() < 6.0
    assert _z(x4, 3.0 * sig2**2, cfg.n_chains).max() < 6.0


def test_exact_scheme_double_well_frozen_omega_mean_and_cov():
    """The kink background with FIXED_BG ghost sources and a frozen ω at a Δτ
    far beyond EM stability: mean μ + x_cl, covariance the unbiased B⁻¹/Δt."""
    cfg = exact_cfg(FIXED_BG, n_sites=16, n_chains=128, loops=20)
    act = tact.get("double_well")
    om0 = 0.5 * (cfg.n_sites - 1) * cfg.dt
    t = torch.arange(cfg.n_sites, dtype=torch.float64) * cfg.dt
    x_cl = act.x_cl(t, torch.tensor(om0, dtype=torch.float64)).numpy()
    ddv = act.ddV(torch.from_numpy(x_cl)).numpy()
    inv = act.mass / cfg.dt**2
    B = np.diag(2.0 * inv + ddv)
    i_ = np.arange(cfg.n_sites - 1)
    B[i_, i_ + 1] = B[i_ + 1, i_] = -inv
    ghost = lambda side, tt: act.boundary_asymptote(side) - float(  # noqa: E731
        act.x_cl(torch.tensor(tt, dtype=torch.float64), torch.tensor(om0, dtype=torch.float64)))
    src = np.zeros(cfg.n_sites)
    src[0], src[-1] = inv * ghost(-1, -cfg.dt), inv * ghost(+1, cfg.n_sites * cfg.dt)
    mx = np.linalg.solve(B, src) + x_cl
    sig2 = np.diag(exact.target_cov(B, cfg.dt))
    s = _equilibrate(cfg, burn=3, frames=30, omega=om0)
    assert _z(s.x_mean.double().numpy(), mx, cfg.n_chains).max() < 6.0
    assert _z(s.x2_mean.double().numpy(), sig2 + mx**2, cfg.n_chains).max() < 6.0


# ---------------------------------------------------------------------------
# the power-spectrum channel
# ---------------------------------------------------------------------------

SPEC_CFG = ChainConfig(action="anharmonic", n_sites=32, dt=0.25, dtau=0.01, n_chains=4, loops=10,
                       bc=PERIODIC, formulation=Formulation.DIRECT, seed=14,
                       accumulate_spectrum=True)


@pytest.mark.parametrize("change", [{}, dict(scheme=Scheme.LM), dict(n_sites=25),
                                    dict(dtau=0.5, loops=6)],
                         ids=["em", "lm", "odd_sites", "rejected_frames"])
def test_power_spectrum_and_translation_averaged_correlator_match_jax(change):
    """|rfft x|² summed per micro-step (pocketfft in both packages, the sums in
    another order): relative 2e-5 of the largest mode per chain.  A rejected
    frame leaves the running spectrum as it was."""
    cfg = dataclasses.replace(SPEC_CFG, **change)
    jcfg, act, s0 = jax_chain(cfg)
    want, wm = jl.run_frames(s0, act, jcfg, 3)
    got, gm = tl.run_frames(to_port(s0), tact.get(cfg.action), cfg, 3)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    if "dtau" in change:
        assert not gm["stable"].all(), "case must reject a frame"
    else:
        assert float(got.spec_mean.min()) >= 0 and float(got.spec_mean.max()) > 0
    w = np.asarray(want.spec_mean)
    scale = np.abs(w).max(axis=1, keepdims=True) + 1e-30
    np.testing.assert_allclose(got.spec_mean.numpy() / scale, w / scale, rtol=0, atol=2e-5)
    assert_state(got._replace(spec_mean=got.spec_mean * 0), want._replace(spec_mean=want.spec_mean * 0),
                 2e-6)
    corr = tl.translation_averaged_correlator(got).numpy()
    wcorr = np.asarray(jl.translation_averaged_correlator(want))
    assert corr.shape == wcorr.shape == (cfg.n_chains, cfg.n_sites) and corr.dtype == wcorr.dtype
    np.testing.assert_allclose(corr, wcorr, rtol=0, atol=2e-5 * max(np.abs(wcorr).max(), 1e-30))
    # Parseval: lag 0 of the correlator is the site-averaged ⟨x²⟩
    np.testing.assert_allclose(corr[:, 0], got.x2_mean.mean(dim=1).numpy(), rtol=2e-5, atol=1e-7)
    assert not tl.reset_means(got).spec_mean.any()


def test_spectrum_survives_a_checkpoint_and_resumes_bitwise(tmp_path):
    cfg = SPEC_CFG
    act = tact.get(cfg.action)
    s0 = tl.init_chain_state(cfg, act, device="cpu")
    full, _ = tl.run_frames(s0, act, cfg, 3)
    half, _ = tl.run_frames(s0, act, cfg, 2)
    checkpoint.save(tmp_path / "s.npz", half, cfg)
    loaded, _ = checkpoint.load(tmp_path / "s.npz", "cpu")
    assert torch.equal(loaded.spec_mean, half.spec_mean) and loaded.spec_mean.any()
    rest, _ = tl.run_frames(loaded, act, cfg, 1)
    for name, x, y in zip(full._fields, full, rest):
        assert torch.equal(x, y), name


def test_spectrum_leaf_is_sharded_and_gathered_with_its_chains():
    from stochquant_tpu_torch import parallel
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    cfg = SPEC_CFG
    act = tact.get(cfg.action)
    state, _ = tl.run_frames(tl.init_chain_state(cfg, act, device="cpu"), act, cfg, 1)
    mesh = parallel.make_mesh([("chain", 2)], devices="cpu")
    spec = mesh_mod.chain_state_spec("chain")
    shards = mesh_mod.shard_state(state, spec, mesh)
    assert [tuple(s.spec_mean.shape) for s in shards] == [(2, 17), (2, 17)]
    assert torch.equal(shards[1].spec_mean, state.spec_mean[2:]) and state.spec_mean.any()
    whole = mesh_mod.gather_state(shards, spec, mesh, torch.device("cpu"))
    for name, x, y in zip(state._fields, state, whole):
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# Scheme.EXACT, fields
# ---------------------------------------------------------------------------

def jax_field(cfg):
    jcfg = JFieldConfig.from_json(cfg.to_json())
    return jcfg, jfield.init_field_state(jcfg)


FIELD_SUMS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean",
              "corr_mean")


@pytest.mark.parametrize("name,action,shape,dtau", [
    ("free_2d", "free_field", (8, 16), 2.0),
    ("etd1_2d", "phi4", (8, 16), 0.3),
    ("free_3d", "free_field", (4, 6, 8), 0.7),
    ("etd1_odd_last_dim", "phi4", (6, 7), 0.2),
])
def test_field_exact_matches_jax(name, action, shape, dtau):
    """The per-mode factors to 1e-6 relative; φ after 2 frames to 2e-5 (rfftn
    round trips in float32, summed in another order than XLA's); the means at
    rtol 3e-5 / atol 3e-6 as on the EM path.  free_field leaves Δτ frozen, ETD1
    keeps the controller."""
    cfg = FieldConfig(action=action, shape=shape, dtau=dtau, n_chains=3, loops=5, seed=11,
                      scheme=Scheme.EXACT, grow_after=1)
    jcfg, s0 = jax_field(cfg)
    jact_, act = jphi4.get_field(action), tphi4.get_field(action)
    ops = tfield.exact_field_mode_ops(act, cfg, to_port(s0).dtau)
    bhat = sum(2.0 * (1.0 - np.cos(2 * np.pi * (np.fft.rfftfreq(n) if d == len(shape) - 1
                                                  else np.fft.fftfreq(n))))
               .reshape([-1 if k == d else 1 for k in range(len(shape))])
               for d, n in enumerate(shape)) + act.m2
    np.testing.assert_allclose(ops[0][0].numpy(), np.exp(-bhat * dtau), rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(ops[1][0].numpy() ** 2, (1 - np.exp(-2 * bhat * dtau)) / bhat,
                               rtol=1e-5)
    np.testing.assert_allclose(ops[2][0].numpy(), (1 - np.exp(-bhat * dtau)) / bhat, rtol=1e-5)

    want, wm = jfield.run_field_frames(s0, jact_, jcfg, 2)
    got, gm = tfield.run_field_frames(to_port(s0), act, cfg, 2)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    assert gm["stable"].all()
    np.testing.assert_allclose(gm["dtau"].numpy(), np.asarray(wm["dtau"]), rtol=2e-6)
    if action == "free_field":
        assert torch.equal(got.dtau, to_port(s0).dtau)
    else:
        assert (got.dtau > to_port(s0).dtau).all()
    for leaf, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if leaf in EXACT_LEAVES:
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=leaf)
        elif leaf in FIELD_SUMS:
            np.testing.assert_allclose(g.numpy(), w, rtol=3e-5, atol=3e-6, err_msg=leaf)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5, err_msg=leaf)


def test_field_exact_validation_surfaces():
    class NoM2(tphi4.FieldAction):
        def V(self, p):
            return p * p

    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=2, scheme=Scheme.EXACT)
    state = tfield.init_field_state(cfg, device="cpu")
    for act, c, match in (
        (NoM2(), cfg, "m2"),
        (tphi4.ScalarPhi4(m2=-1.0, lam=1.0), cfg, "positive Gaussian curvature"),
        (tphi4.FreeField(m2=0.0), cfg, "positive Gaussian curvature"),
        (tphi4.get_field("free_field"), dataclasses.replace(cfg, sweep=Sweep.CHECKERBOARD), "SYNC"),
        (tphi4.get_field("phi4"), dataclasses.replace(cfg, mesh_axes=("x", None)),
         "single-program"),
    ):
        with pytest.raises(ValueError, match=match):
            tfield.run_field_frames(state, act, c, 1)
        with pytest.raises(ValueError, match=match):
            tfield.check_field_supported(c, act)
    tfield.check_field_supported(cfg, tphi4.get_field("phi4"))  # phi4 (m² = 1) is supported


def test_field_exact_interacting_reduces_to_free_at_zero_coupling():
    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=4, loops=6, dtau=0.3, seed=5,
                      grow_after=10**9, scheme=Scheme.EXACT)
    s0 = tfield.init_field_state(cfg, device="cpu")
    a, ma = tfield.run_field_frames(s0, tphi4.ScalarPhi4(m2=1.0, lam=0.0), cfg, 2)
    b, mb = tfield.run_field_frames(s0, tphi4.FreeField(m2=1.0), cfg, 2)
    assert torch.equal(a.phi, b.phi) and torch.equal(a.phi2_mean, b.phi2_mean)
    assert ma["stable"].all() and mb["stable"].all()


def test_field_exact_interacting_stable_where_em_diverges_and_trips_on_the_remainder():
    base = dict(action="phi4", shape=(8, 8), n_chains=4, loops=10, dtau=0.5, seed=3,
                grow_after=10**9)
    act = tphi4.ScalarPhi4(m2=1.0, lam=0.5)
    em_cfg, ex_cfg = FieldConfig(**base), FieldConfig(**base, scheme=Scheme.EXACT)
    _, m_em = tfield.run_field_frames(tfield.init_field_state(em_cfg, device="cpu"), act, em_cfg, 2)
    s_ex, m_ex = tfield.run_field_frames(tfield.init_field_state(ex_cfg, device="cpu"), act,
                                         ex_cfg, 2)
    assert not m_em["stable"].all() and m_ex["stable"].all()
    assert torch.isfinite(s_ex.phi).all() and torch.isfinite(s_ex.phi2_mean).all()
    # the explicit dV_int remainder can still diverge: the detector trips, the
    # frame is rejected and Δτ shrinks
    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=6, dtau=2.0, seed=7,
                      grow_after=10**9, scheme=Scheme.EXACT)
    s0 = tfield.init_field_state(cfg, device="cpu")
    out, m = tfield.run_field_frames(s0, tphi4.ScalarPhi4(m2=1.0, lam=4000.0), cfg, 1)
    assert not m["stable"].any() and torch.equal(out.phi, s0.phi)
    np.testing.assert_allclose(out.dtau.numpy(), cfg.dtau * cfg.shrink, rtol=1e-6)


def test_field_exact_free_field_2d_hits_target_phi2():
    """tests/test_exact_scheme.py's gate at 8² × 64: Δτ·B̂_max = 18, site-averaged
    ⟨φ²⟩ = mean_k 1/B̂(k) within 6 standard errors."""
    cfg = FieldConfig(action="free_field", shape=(8, 8), dtau=2.0, n_chains=64, loops=20, seed=11,
                      scheme=Scheme.EXACT)
    act = tphi4.get_field("free_field")
    s = tfield.init_field_state(cfg, device="cpu")
    s, _ = tfield.run_field_frames(s, act, cfg, 3)
    s, m = tfield.run_field_frames(tfield.reset_field_means(s), act, cfg, 30)
    assert m["stable"].all() and torch.equal(s.dtau, torch.full((64,), 2.0))
    k = 2.0 * np.pi * np.fft.fftfreq(8)
    bhat = 2.0 * (1.0 - np.cos(k))[:, None] + 2.0 * (1.0 - np.cos(k))[None, :] + 1.0
    phi2 = s.phi2_mean.double().numpy()
    assert _z(phi2[:, None], np.mean(1.0 / bhat), cfg.n_chains).max() < 6.0
