"""The port's complex actions and its 0-D / chain complex-Langevin integrators
against the JAX package on the CPU, and the JAX package's known-answer tests
of the sector run on the port.

Tolerances: the Threefry noise bit for bit (tests/test_torch_rng.py); the
decisions, ``runs``, ``stab_cnt`` and ``step`` exact; every float leaf within
rtol 1e-5, atol 1e-6 (the transcendentals of the Box–Muller noise and of
float32 arithmetic fused differently by XLA); ``dS`` within rtol 1e-6."""

import math

import numpy as np
import pytest
import torch

from stochquant_tpu.actions import complex_actions as jca
from stochquant_tpu.integrators import complex_langevin as jcl
from stochquant_tpu_torch.actions import complex_actions as ca
from stochquant_tpu_torch.integrators import complex_langevin as cl
from stochquant_tpu_torch.io import checkpoint

torch.set_num_threads(1)

EXACT = ("runs", "stab_cnt", "step")
ACTIONS = [("complex_gaussian", {}), ("complex_quartic", dict(lam=2.0))]


def to_port(jstate):
    return checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(jstate._fields, jstate)}, "cpu")


def assert_matches_jax(got, want, label=""):
    assert type(got).__name__ == type(want).__name__
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in EXACT:
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=label + name)
        else:
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=label + name)


def assert_metrics_match(got, want):
    for key in ("stable", "dtau", "drift_max"):
        w = np.asarray(want[key])
        if key == "stable":
            np.testing.assert_array_equal(got[key].numpy(), w)
        else:
            np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name,params", ACTIONS)
def test_ds_matches_jax(name, params):
    rng = np.random.default_rng(4)
    z = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    want = np.asarray(jca.get_complex(name, **params).dS(z))
    gr, gi = ca.get_complex(name, **params).dS(torch.from_numpy(z.real.copy()),
                                              torch.from_numpy(z.imag.copy()))
    np.testing.assert_allclose(gr.numpy(), want.real, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gi.numpy(), want.imag, rtol=1e-6, atol=1e-7)
    sr, si = ca.get_complex(name, **params).S(torch.from_numpy(z.real.copy()),
                                              torch.from_numpy(z.imag.copy()))
    s = np.asarray(jca.get_complex(name, **params).S(z))
    np.testing.assert_allclose(sr.numpy() + 1j * si.numpy(), s, rtol=1e-5, atol=1e-6)
    assert ca.complex_names() == jca.complex_names()


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("name,params", ACTIONS)
def test_cl_frames_match_jax(name, params, frames):
    # a drift cap below the quartic's drift, so the step control is exercised
    cfg = cl.ComplexLangevinConfig(action=name, n_chains=64, dtau=1e-2, loops=7, seed=3,
                                   drift_cap=1.5, grow_after=1, dtau_max=0.0105,
                                   action_params=tuple(params.items()))
    jc = jcl.ComplexLangevinConfig.from_json(cfg.to_json())
    assert jc.to_json() == cfg.to_json()
    js0 = jcl.init_cl_state(jc)
    assert_matches_jax(cl.init_cl_state(cfg, device="cpu"), js0, "init ")
    ja, ta = jca.get_complex(name, **params), ca.get_complex(name, **params)
    js, jm = jcl.run_cl_frames(js0, ja, jc, frames)
    ts, tm = cl.run_cl_frames(to_port(js0), ta, cfg, frames)
    assert_matches_jax(ts, js)
    assert_metrics_match(tm, jm)
    assert cl.z2_estimate(ts) == pytest.approx(jcl.z2_estimate(js), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("loops", [6, 7])
@pytest.mark.parametrize("name,params", ACTIONS)
def test_ccl_frames_match_jax(name, params, loops):
    """Even loops (pairs only) and odd loops (a tail drawing at its step and
    dropping e1), one and three frames."""
    cfg = cl.ComplexChainConfig(action=name, n_sites=12, dt=0.4, n_chains=5, dtau=5e-3,
                                loops=loops, seed=7, drift_cap=8.0)
    jc = jcl.ComplexChainConfig.from_json(cfg.to_json())
    ja, ta = jca.get_complex(name), ca.get_complex(name)
    js0 = jcl.init_ccl_state(jc)
    assert_matches_jax(cl.init_ccl_state(cfg, device="cpu"), js0, "init ")
    for frames in (1, 3):
        js, jm = jcl.run_ccl_frames(js0, ja, jc, frames)
        ts, tm = cl.run_ccl_frames(to_port(js0), ta, cfg, frames)
        assert_matches_jax(ts, js, f"{frames} frames ")
        assert_metrics_match(tm, jm)


def test_rejected_frame_rolls_back_like_jax():
    """A clamp below the excursions: frames are rejected, Δτ shrinks, the
    state rolls back and ``step`` still advances, as in the JAX package."""
    cfg = cl.ComplexChainConfig(action="complex_quartic", n_sites=8, n_chains=6, dtau=2e-2,
                                loops=5, seed=2, clamp=0.25)
    jc = jcl.ComplexChainConfig.from_json(cfg.to_json())
    js0 = jcl.init_ccl_state(jc)
    js, jm = jcl.run_ccl_frames(js0, jca.get_complex(cfg.action), jc, 3)
    ts, tm = cl.run_ccl_frames(to_port(js0), ca.get_complex(cfg.action), cfg, 3)
    assert not np.asarray(jm["stable"]).all()
    assert_matches_jax(ts, js)
    assert_metrics_match(tm, jm)


def test_reset_means():
    cfg = cl.ComplexLangevinConfig(n_chains=4, loops=3)
    s, _ = cl.run_cl_frames(cl.init_cl_state(cfg, device="cpu"), ca.get_complex(cfg.action),
                            cfg, 1)
    r = cl.reset_cl_means(s)
    for name in ("z2r_mean", "z2i_mean", "zr_mean", "zi_mean", "runs"):
        assert not torch.count_nonzero(getattr(r, name)), name
    assert torch.equal(r.zr, s.zr) and int(r.step) == int(s.step)
    ccfg = cl.ComplexChainConfig(n_sites=4, n_chains=2, loops=3)
    c, _ = cl.run_ccl_frames(cl.init_ccl_state(ccfg, device="cpu"),
                             ca.get_complex(ccfg.action), ccfg, 1)
    rc = cl.reset_ccl_means(c)
    assert not torch.count_nonzero(rc.z2r_mean) and not torch.count_nonzero(rc.runs)


# ---------------------------------------------------------------------------
# the JAX package's known-answer tests (tests/test_complex_langevin.py), on the port
# ---------------------------------------------------------------------------


def _run(cfg, action, burn=20, measure=60):
    s = cl.init_cl_state(cfg, device="cpu")
    s, _ = cl.run_cl_frames(s, action, cfg, burn)
    s = cl.reset_cl_means(s)
    return cl.run_cl_frames(s, action, cfg, measure)


def test_complex_gaussian_z2_matches_exact():
    act = ca.get_complex("complex_gaussian", sigma_re=1.0, sigma_im=0.5)
    cfg = cl.ComplexLangevinConfig(n_chains=4096, dtau=2e-3, loops=100, seed=9,
                                   grow_after=10**9)
    s, m = _run(cfg, act)
    assert m["stable"].all()
    got = cl.z2_estimate(s)
    want = 1.0 / act.sigma
    re, im = s.z2r_mean.double(), s.z2i_mean.double()
    err = math.hypot(float(re.std()), float(im.std())) / math.sqrt(cfg.n_chains)
    # finite-Δτ bias ~ O(Δτ·|σ|): the JAX test's systematic allowance
    assert abs(got - want) < 6 * err + 6 * cfg.dtau, (got, want, err)


@pytest.mark.slow  # the JAX twin is slow-marked (tests/test_complex_langevin.py:37)
def test_complex_quartic_z2_matches_quadrature():
    act = ca.get_complex("complex_quartic", sigma_re=1.0, sigma_im=1.0, lam=1.0)
    x = np.linspace(-12, 12, 200001)
    w = np.exp(-(0.5 * (1 + 1j) * x**2 + 0.25 * x**4))
    want = np.trapezoid(x * x * w, x) / np.trapezoid(w, x)
    cfg = cl.ComplexLangevinConfig(action="complex_quartic", n_chains=8192, dtau=5e-4, loops=200,
                                   seed=4, grow_after=10**9)
    s, _ = _run(cfg, act, burn=20, measure=80)
    got = cl.z2_estimate(s)
    re, im = s.z2r_mean.double(), s.z2i_mean.double()
    err = math.hypot(float(re.std()), float(im.std())) / math.sqrt(cfg.n_chains)
    assert abs(got - want) < 8 * err + 0.02, (got, want, err)


def test_drift_norm_monitor_records_and_caps():
    act = ca.get_complex("complex_quartic", lam=5.0)
    cfg = cl.ComplexLangevinConfig(action="complex_quartic", n_chains=256, dtau=1e-2, loops=50,
                                   seed=2, drift_cap=1.0)
    s, _ = cl.run_cl_frames(cl.init_cl_state(cfg, device="cpu"), act, cfg, 20)
    assert (s.drift_max > 0).all()
    assert torch.isfinite(s.zr).all() and torch.isfinite(s.zi).all()


def test_cl_determinism():
    act = ca.get_complex("complex_gaussian")
    cfg = cl.ComplexLangevinConfig(n_chains=16, dtau=1e-3, loops=10, seed=5)
    a, _ = cl.run_cl_frames(cl.init_cl_state(cfg, device="cpu"), act, cfg, 4)
    b1, _ = cl.run_cl_frames(cl.init_cl_state(cfg, device="cpu"), act, cfg, 2)
    b2, _ = cl.run_cl_frames(b1, act, cfg, 2)
    for name, x, y in zip(a._fields, a, b2):
        assert torch.equal(x, y), name


@pytest.mark.slow  # the JAX twin is slow-marked (tests/test_complex_langevin.py:87)
def test_complex_chain_gaussian_matches_exact_propagator():
    sigma = 1.0 + 0.5j
    act = ca.get_complex("complex_gaussian", sigma_re=1.0, sigma_im=0.5)
    cfg = cl.ComplexChainConfig(n_sites=16, dt=0.4, n_chains=1024, dtau=2e-3, loops=100,
                                seed=12, grow_after=10**9)
    s, _ = cl.run_ccl_frames(cl.init_ccl_state(cfg, device="cpu"), act, cfg, 30)
    s, m = cl.run_ccl_frames(cl.reset_ccl_means(s), act, cfg, 80)
    assert m["stable"].all()
    q = 2 * np.pi * np.arange(cfg.n_sites) / cfg.n_sites
    want = np.mean(1.0 / (cfg.dt * (2 * cfg.mass * (1 - np.cos(q)) / cfg.dt**2 + sigma)))
    re, im = s.z2r_mean.double(), s.z2i_mean.double()
    got = complex(float(re.mean()), float(im.mean()))
    err = math.hypot(float(re.mean(dim=1).std()), float(im.mean(dim=1).std())) / math.sqrt(
        cfg.n_chains)
    assert abs(got - want) < 6 * err + 0.03 * abs(want), (got, want, err)


def test_complex_chain_determinism():
    act = ca.get_complex("complex_quartic")
    cfg = cl.ComplexChainConfig(action="complex_quartic", n_sites=8, dt=0.5, n_chains=4,
                                dtau=5e-4, loops=11, seed=3)
    a, _ = cl.run_ccl_frames(cl.init_ccl_state(cfg, device="cpu"), act, cfg, 4)
    b1, _ = cl.run_ccl_frames(cl.init_ccl_state(cfg, device="cpu"), act, cfg, 2)
    b2, _ = cl.run_ccl_frames(b1, act, cfg, 2)
    for name, x, y in zip(a._fields, a, b2):
        assert torch.equal(x, y), name
