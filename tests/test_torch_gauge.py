"""The port's compact gauge actions, loops and plain integrator against the
JAX package on the CPU: drift, plaquette, action and drift norm of U(1),
SU(2) and SU(3) at D = 2 (8×8) and D = 4 (4⁴); the SU(3) exponential and
projection; the quaternion exponential; Polyakov and Wilson loops; and
``run_gauge_frames`` against the JAX XLA path through hot starts, odd
``loops``, an active drift cap, a rejected frame and Δτ growth.  Links
within rtol 2e-6 / atol 2e-6 (u1, su2) and rtol 2e-5 / atol 2e-6 (su3),
``plaq_mean`` within rtol 1e-5 / atol 1e-6, decisions and counters exact
(the tolerances of tests/test_gauge_kernel.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from stochquant_tpu.actions import gauge as jga
from stochquant_tpu.integrators import gauge as jg
from stochquant_tpu.observables import gauge_loops as jloops
from stochquant_tpu_torch.actions import gauge as ga
from stochquant_tpu_torch.integrators import gauge as tg
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.observables import gauge_loops

torch.set_num_threads(1)

BETA = {"u1": 1.0, "su2": 2.0, "su3": 5.0}
LINKS_TOL = {"u1": dict(rtol=2e-6, atol=2e-6), "su2": dict(rtol=2e-6, atol=2e-6),
             "su3": dict(rtol=2e-5, atol=2e-6)}
GEOMETRIES = [(g, s) for g in ("u1", "su2", "su3") for s in ((8, 8), (4, 4, 4, 4))]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_state(jstate):
    return checkpoint.state_from_numpy({n: np.asarray(v) for n, v in zip(jstate._fields, jstate)},
                                       "cpu")


@pytest.fixture(scope="module")
def hot_links():
    """(group, shape) -> disordered links of 2 chains from the JAX package."""
    out = {}
    for group, shape in GEOMETRIES:
        cfg = jg.GaugeConfig(group=group, beta=BETA[group], shape=shape, n_chains=2, seed=5,
                             hot_start=True)
        out[group, shape] = np.asarray(jg.init_gauge_state(cfg).links)
    return out


@pytest.mark.parametrize("group,shape", GEOMETRIES)
def test_action_terms_match_jax(hot_links, group, shape):
    links = hot_links[group, shape]
    ndim = len(shape)
    ja, ta = jga.get_gauge(group, beta=BETA[group]), ga.get_gauge(group, beta=BETA[group])
    tl = torch.from_numpy(links.copy())
    jf, tf = ja.drift(jnp.asarray(links), ndim), ta.drift(tl, ndim)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ta.drift_norm(tf)), np.asarray(ja.drift_norm(jf)), rtol=2e-6)
    np.testing.assert_allclose(_np(ta.mean_plaquette(tl, ndim)),
                               np.asarray(ja.mean_plaquette(jnp.asarray(links), ndim)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(ta.action(tl, ndim)),
                               np.asarray(ja.action(jnp.asarray(links), ndim)), rtol=1e-5)
    if group == "u1":
        np.testing.assert_allclose(_np(ta.plaquette_angle(tl, 0, 1, ndim)),
                                   np.asarray(ja.plaquette_angle(jnp.asarray(links), 0, 1, ndim)),
                                   rtol=2e-6, atol=2e-6)
    else:
        np.testing.assert_allclose(_np(ta.plaquette(tl, 0, ndim - 1)),
                                   np.asarray(ja.plaquette(jnp.asarray(links), 0, ndim - 1)),
                                   **LINKS_TOL[group])
    # one exact group step with the same ω
    rng = np.random.default_rng(3)
    eta = rng.standard_normal(ta.noise_shape(2, ndim, shape)).astype(np.float32)
    dtau = np.array([1e-3, 2e-3], np.float32)
    tom = ta.omega(tf, torch.from_numpy(eta), torch.from_numpy(dtau))
    d = dtau.reshape((2,) + (1,) * (np.asarray(jf).ndim - 1))
    jom = d * jf + jnp.sqrt(2.0 * jnp.asarray(d)).astype(jf.dtype) * ja.noise_to_tangent(
        jnp.asarray(eta))
    np.testing.assert_allclose(_np(tom), np.asarray(jom), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(_np(ta.apply_update(tl, tom)),
                               np.asarray(ja.apply_update(jnp.asarray(links), jom)),
                               **LINKS_TOL[group])


def _hermitian_traceless(rng, n, scale):
    a = rng.standard_normal((n, 3, 3)) + 1j * rng.standard_normal((n, 3, 3))
    h = (a + np.conj(np.swapaxes(a, -1, -2))) / 2
    h -= np.trace(h, axis1=-2, axis2=-1)[:, None, None] * np.eye(3) / 3
    return (scale[:, None, None] * h).astype(np.complex64)


def test_expi_su3_matches_jax_and_expm():
    rng = np.random.default_rng(7)
    # ordinary, near zero (the Taylor branch), large, and both signs of det Q
    scale = np.concatenate([np.full(8, 0.3), np.full(4, 1e-5), np.full(4, 2.0)])
    q = _hermitian_traceless(rng, scale.size, scale)
    q = np.concatenate([q, -q])
    got = _np(ga.expi_su3(torch.from_numpy(q)))
    np.testing.assert_allclose(got, np.asarray(jga.expi_su3(jnp.asarray(q))), atol=2e-6)
    np.testing.assert_allclose(got, np.stack([expm(1j * m.astype(np.complex128)) for m in q]),
                               atol=2e-6)
    # mmul, dag, retr against numpy in float64
    a, b = q[:4] + 0.5, q[4:8] - 0.25j
    np.testing.assert_allclose(_np(ga.mmul(torch.from_numpy(a), torch.from_numpy(b))), a @ b,
                               atol=2e-6)
    np.testing.assert_array_equal(_np(ga.dag(torch.from_numpy(a))),
                                  np.conj(np.swapaxes(a, -1, -2)))
    np.testing.assert_allclose(_np(ga.retr(torch.from_numpy(a))),
                               np.trace(a, axis1=-2, axis2=-1).real, rtol=1e-6)


def test_project_su3_matches_jax():
    rng = np.random.default_rng(8)
    u = np.stack([expm(1j * m.astype(np.complex128))
                  for m in _hermitian_traceless(rng, 6, np.full(6, 0.7))])
    u = (u + 1e-3 * rng.standard_normal(u.shape)).astype(np.complex64)  # off the group
    got = _np(ga.project_su3(torch.from_numpy(u)))
    np.testing.assert_allclose(got, np.asarray(jga.project_su3(jnp.asarray(u))), atol=2e-6)
    np.testing.assert_allclose(np.linalg.det(got.astype(np.complex128)), 1.0, atol=1e-5)


def test_qexp_su2_at_and_near_zero():
    v = np.array([[0.0, 0.0, 0.0], [1e-7, -2e-7, 3e-7], [1e-5, 0.0, 0.0], [0.3, -0.2, 0.9],
                  [2.0, 1.0, -3.0]], np.float32).T
    got = ga.qexp_su2(*(torch.from_numpy(c.copy()) for c in v))
    want = jga.qexp_su2(*(jnp.asarray(c) for c in v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(got[0])[0], 1.0)
    norm = sum(_np(c).astype(np.float64) ** 2 for c in got)
    np.testing.assert_allclose(norm, 1.0, atol=1e-6)


@pytest.mark.parametrize("group,shape", GEOMETRIES)
def test_loops_match_jax(hot_links, group, shape):
    links = hot_links[group, shape]
    ja, ta = jga.get_gauge(group, beta=BETA[group]), ga.get_gauge(group, beta=BETA[group])
    tl = torch.from_numpy(links.copy())
    np.testing.assert_allclose(_np(gauge_loops.polyakov_loop(ta, tl, 0)),
                               np.asarray(jloops.polyakov_loop(ja, jnp.asarray(links), 0)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(_np(gauge_loops.wilson_loop_table(ta, tl, 0, 1, 3, 2)),
                               np.asarray(jloops.wilson_loop_table(ja, jnp.asarray(links), 0, 1,
                                                                   3, 2)),
                               rtol=2e-5, atol=2e-6)
    # W(1, 1) is the (0, 1) plaquette
    np.testing.assert_allclose(_np(gauge_loops.wilson_loop(ta, tl, 0, 1, 1, 1)),
                               _np(ta.mean_plaquette(tl, 2)) if len(shape) == 2 else
                               np.asarray(jloops.wilson_loop(ja, jnp.asarray(links), 0, 1, 1, 1)),
                               rtol=2e-5, atol=2e-6)


def test_cold_links_and_exact_plaquette():
    for group in ("u1", "su2", "su3"):
        cfg = tg.GaugeConfig(group=group, shape=(4, 6), n_chains=2)
        act = tg.resolve_gauge_action(cfg)
        s = tg.init_gauge_state(cfg, act, device="cpu")
        np.testing.assert_allclose(_np(act.mean_plaquette(s.links, 2)), 1.0, atol=1e-6)
        np.testing.assert_allclose(_np(gauge_loops.polyakov_loop(act, s.links, 1)),
                                   [[1.0, 0.0]] * 2, atol=1e-6)
        assert int(s.step) == 1 and s.runs.shape == (2, 2)
        for beta in (1.0, 2.5):
            assert tg.exact_plaquette_2d(group, beta) == pytest.approx(
                jg.exact_plaquette_2d(group, beta), rel=1e-12)
    # the complexified groups resolve with Im β; a compact group refuses one, as in JAX
    act = tg.resolve_gauge_action(tg.GaugeConfig(group="cu1", beta_im=0.5))
    assert act.beta_im == 0.5 and act.obs_dtype == "complex64"
    with pytest.raises(TypeError):
        tg.resolve_gauge_action(tg.GaugeConfig(group="u1", beta_im=0.5))
    with pytest.raises(TypeError):
        jg.resolve_gauge_action(jg.GaugeConfig(group="u1", beta_im=0.5))


# (group, case) -> config changes and whether chain 1 starts with a NaN link
INTEGRATOR_CASES = {
    # hot start, odd loops, and a chain whose frames are rejected
    "hot_odd_rejected": (dict(hot_start=True, loops=5), True),
    # the drift cap active every micro-step; Δτ grows into dtau_max
    "capped_growth": (dict(hot_start=True, loops=4, drift_cap=0.5, grow_after=1,
                           dtau_max_factor=1.03), False),
}


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
@pytest.mark.parametrize("case", sorted(INTEGRATOR_CASES))
def test_run_gauge_frames_matches_jax_xla(group, case):
    change, nan_chain = INTEGRATOR_CASES[case]
    change = dict(change)
    dtau = {"u1": 5e-3, "su2": 2e-3, "su3": 1e-3}[group]
    factor = change.pop("dtau_max_factor", None)
    if factor:
        change["dtau_max"] = dtau * factor
    cfg = tg.GaugeConfig(group=group, beta=BETA[group], shape=(8, 8), n_chains=3, dtau=dtau,
                         seed=13, **change)
    jcfg = jg.GaugeConfig.from_json(cfg.to_json())
    js = jg.init_gauge_state(jcfg)
    ts = tg.init_gauge_state(cfg, device="cpu")
    np.testing.assert_allclose(_np(ts.links), np.asarray(js.links), **LINKS_TOL[group])
    if nan_chain:
        links = np.asarray(js.links).copy()
        links.reshape(3, -1)[1, 7] = np.nan
        js = js._replace(links=jnp.asarray(links))
    ts = _port_state(js)
    want, wm = jg.run_gauge_frames(js, jg.resolve_gauge_action(jcfg), jcfg, 3)
    got, gm = tg.run_gauge_frames(ts, tg.resolve_gauge_action(cfg), cfg, 3)

    stable = _np(gm["stable"])
    np.testing.assert_array_equal(stable, np.asarray(wm["stable"]))
    if nan_chain:
        assert not stable[:, 1].any() and stable[:, [0, 2]].all()
        assert np.isnan(_np(gm["drift_max"])[:, 1]).all()
    else:
        assert _np(gm["drift_max"]).min() > cfg.drift_cap  # the cap rescaled every step
        np.testing.assert_array_equal(_np(got.dtau), np.float32(cfg.dtau_max))
    for key in ("dtau", "drift_max"):
        np.testing.assert_allclose(_np(gm[key]), np.asarray(wm[key]), rtol=2e-6, atol=0)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(_np(g).astype(w.dtype), w, err_msg=name)
        elif name == "links":
            np.testing.assert_allclose(_np(g), w, err_msg=name, **LINKS_TOL[group])
        elif name == "plaq_mean":
            np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=2e-6, atol=0, err_msg=name)


def test_run_gauge_frames_4d_matches_jax_xla():
    cfg = tg.GaugeConfig(group="su2", beta=2.2, shape=(4, 4, 4, 4), n_chains=2, dtau=1e-3,
                         loops=3, seed=2, hot_start=True)
    jcfg = jg.GaugeConfig.from_json(cfg.to_json())
    want, wm = jg.run_gauge_frames(jg.init_gauge_state(jcfg), jg.resolve_gauge_action(jcfg),
                                   jcfg, 2)
    got, gm = tg.run_gauge_frames(tg.init_gauge_state(cfg, device="cpu"),
                                  tg.resolve_gauge_action(cfg), cfg, 2)
    np.testing.assert_allclose(_np(got.links), np.asarray(want.links), **LINKS_TOL["su2"])
    np.testing.assert_allclose(_np(got.plaq_mean), np.asarray(want.plaq_mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(_np(gm["stable"]), np.asarray(wm["stable"]))
    np.testing.assert_array_equal(_np(got.runs).astype(np.uint32), np.asarray(want.runs))


def test_frame_helpers_compose_and_reset():
    cfg = tg.GaugeConfig(group="u1", shape=(4, 8), n_chains=2, loops=3, seed=4)
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    frame = tg.make_gauge_frame_fn(act, cfg)
    a, _ = frame(frame(s0)[0])
    b, m = tg.run_gauge_frames(s0, act, cfg, 2)
    for name, x, y in zip(a._fields, a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    assert m["stable"].shape == (2, 2) and int(b.step) == 1 + 2 * cfg.loops
    r = tg.reset_gauge_means(b)
    assert torch.count_nonzero(r.plaq_mean) == 0 and torch.count_nonzero(r.runs) == 0
    assert torch.equal(r.links, b.links)
    assert dataclasses.replace(cfg, shape=(2, 3, 4)).ndim == 3
