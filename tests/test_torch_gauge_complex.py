"""The port's complexified gauge groups (cu1, csu2, csu3) with gauge cooling,
their loop observables, the Creutz ratio and the Wilson flow, against the
JAX package on the CPU; and the JAX package's known-answer tests of them
(tests/test_gauge_complex.py, tests/test_gauge_loops.py) run on the port.

Tolerances: ``expm_taylor`` / ``inv22`` / ``inv33`` within rtol 1e-5, atol
1e-6 of the JAX package (2e-6 of the exact inverse); drift, plaquette,
action, unitarity norm and one group step on hot non-unitary links within
rtol 1e-5, atol 1e-6 (csu links rtol 2e-5, as su3's); frames: decisions,
``runs``, ``stab_cnt`` and ``step`` exact, links rtol 1e-5 (csu 2e-5), atol
2e-6, ``plaq_mean`` (a lattice sum) rtol 3e-5, atol 3e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from stochquant_tpu.actions import gauge as jga
from stochquant_tpu.actions import gauge_complex as jgc
from stochquant_tpu.integrators import gauge as jg
from stochquant_tpu.observables import gauge_loops as jloops
from stochquant_tpu_torch.actions import gauge as ga
from stochquant_tpu_torch.actions import gauge_complex as gc
from stochquant_tpu_torch.integrators import gauge as tg
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.observables import gauge_loops

torch.set_num_threads(1)

GROUPS = {"cu1": (1.3, 0.4), "csu2": (1.3, 0.3), "csu3": (1.3, 0.5)}
TOL = {"cu1": dict(rtol=1e-5, atol=1e-6), "csu2": dict(rtol=2e-5, atol=1e-6),
       "csu3": dict(rtol=2e-5, atol=1e-6)}
SHAPE = (6, 6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _actions(group):
    beta, beta_im = GROUPS[group]
    cfg = tg.GaugeConfig(group=group, beta=beta, beta_im=beta_im, shape=SHAPE)
    return jg.resolve_gauge_action(jg.GaugeConfig.from_json(cfg.to_json())), \
        tg.resolve_gauge_action(cfg)


@pytest.fixture(scope="module")
def hot_links():
    """group -> hot, non-unitary links of 2 chains (the JAX hot start, pushed
    off the unitary manifold by a seeded perturbation)."""
    r = np.random.default_rng(17)
    out = {}
    for group in GROUPS:
        cfg = jg.GaugeConfig(group=group, beta=1.0, shape=SHAPE, n_chains=2, seed=5,
                             hot_start=True)
        links = np.asarray(jg.init_gauge_state(cfg).links)
        noise = r.normal(size=links.shape) + 1j * r.normal(size=links.shape)
        scale = 0.2j * r.normal(size=links.shape) if group == "cu1" else 0.1 * noise
        out[group] = (links + scale).astype(np.complex64)
    return out


def test_expm_taylor_matches_jax_and_scipy():
    r = np.random.default_rng(1)
    a = (0.3 * (r.normal(size=(5, 3, 3)) + 1j * r.normal(size=(5, 3, 3)))).astype(np.complex64)
    got = _np(gc.expm_taylor(torch.from_numpy(a)))
    np.testing.assert_allclose(got, np.asarray(jgc.expm_taylor(jnp.asarray(a))), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got, np.stack([expm(m) for m in a.astype(np.complex128)]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 3])
def test_inv_closed_form_matches_jax_and_numpy(n):
    r = np.random.default_rng(2)
    a = (r.normal(size=(7, n, n)) + 1j * r.normal(size=(7, n, n))).astype(np.complex64)
    inv, jinv = (gc.inv22, jgc.inv22) if n == 2 else (gc.inv33, jgc.inv33)
    got = _np(inv(torch.from_numpy(a)))
    np.testing.assert_allclose(got, np.asarray(jinv(jnp.asarray(a))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.inv(a.astype(np.complex128)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(gc.mmul(torch.from_numpy(a), torch.from_numpy(got))),
                               np.broadcast_to(np.eye(n), a.shape), atol=2e-5)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_action_terms_match_jax_on_non_unitary_links(hot_links, group):
    links = hot_links[group]
    ja, ta = _actions(group)
    jl, tl = jnp.asarray(links), torch.from_numpy(links.copy())
    jf, tf = ja.drift(jl, 2), ta.drift(tl, 2)
    assert tf.dtype == torch.complex64 and tf.shape == jf.shape
    np.testing.assert_allclose(_np(tf), np.asarray(jf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(ta.drift_norm(tf)), np.asarray(ja.drift_norm(jf)), rtol=1e-6)
    for name in ("mean_plaquette", "action", "unitarity_norm"):
        np.testing.assert_allclose(_np(getattr(ta, name)(tl, 2)),
                                   np.asarray(getattr(ja, name)(jl, 2)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(_np(ta.cool(tl, 2, 0.05, 3)), np.asarray(ja.cool(jl, 2, 0.05, 3)),
                               **TOL[group])
    # one Langevin step with the same ω: the JAX integrator's expression
    r = np.random.default_rng(3)
    eta = r.standard_normal(ta.noise_shape(2, 2, SHAPE)).astype(np.float32)
    dtau = np.array([1e-3, 2e-3], np.float32)
    d = jnp.asarray(dtau).reshape((2,) + (1,) * (jf.ndim - 1))
    jom = d * jf + jnp.sqrt(2.0 * d).astype(jf.dtype) * ja.noise_to_tangent(jnp.asarray(eta))
    tom = ta.omega(tf, torch.from_numpy(eta), torch.from_numpy(dtau))
    np.testing.assert_allclose(_np(tom), np.asarray(jom), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(ta.noise_to_tangent(torch.from_numpy(eta))),
                               np.asarray(ja.noise_to_tangent(jnp.asarray(eta))), rtol=0, atol=0)
    np.testing.assert_allclose(_np(ta.apply_update(tl, tom)),
                               np.asarray(ja.apply_update(jl, jom)), **TOL[group])
    # the halo runner's per-site density averages to the mean plaquette
    np.testing.assert_allclose(_np(ta.plaquette_site_mean(tl, 2).mean(dim=(1, 2))),
                               _np(ta.mean_plaquette(tl, 2)), rtol=1e-5, atol=1e-6)


def test_cu1_update_wraps_the_real_part_half_to_even():
    ta = _actions("cu1")[1]
    two_pi = np.float32(2 * np.pi)
    theta = torch.complex(torch.tensor([[[0.0]]]), torch.tensor([[[0.25]]]))
    omega = torch.complex(torch.tensor([[[float(np.float32(0.5) * two_pi)]]]),
                          torch.tensor([[[0.5]]]))
    got = ta.apply_update(theta, omega)
    want = np.asarray(_actions("cu1")[0].apply_update(jnp.asarray(theta.numpy()),
                                                      jnp.asarray(omega.numpy())))
    np.testing.assert_array_equal(_np(got), want)


# (group, config change)
FRAME_CASES = {
    "cu1_cooling_odd": ("cu1", dict(loops=5, cooling_rate=0.05)),
    "cu1_hot_cap": ("cu1", dict(loops=4, hot_start=True, drift_cap=0.5, cooling_rate=0.3,
                                cooling_steps=2)),
    "csu2_cooling": ("csu2", dict(loops=4, cooling_rate=0.05, hot_start=True)),
    "csu3_cooling_odd": ("csu3", dict(loops=3, cooling_rate=0.05, hot_start=True)),
    "csu3_real_beta": ("csu3", dict(loops=2, beta_im=0.0)),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_gauge_frames_with_cooling_match_jax(case):
    group, change = FRAME_CASES[case]
    beta, beta_im = GROUPS[group]
    cfg = tg.GaugeConfig(**{**dict(group=group, beta=beta, beta_im=beta_im, shape=SHAPE,
                                   n_chains=2, dtau=5e-3, seed=4), **change})
    jc = jg.GaugeConfig.from_json(cfg.to_json())
    assert jc.to_json() == cfg.to_json()
    ja, ta = jg.resolve_gauge_action(jc), tg.resolve_gauge_action(cfg)
    js0 = jg.init_gauge_state(jc)
    ts0 = tg.init_gauge_state(cfg, ta, device="cpu")
    assert ts0.plaq_mean.dtype == torch.complex64 and ts0.links.dtype == torch.complex64
    np.testing.assert_allclose(_np(ts0.links), np.asarray(js0.links), **TOL[group])
    port = checkpoint.state_from_numpy({n: np.asarray(v) for n, v in zip(js0._fields, js0)}, "cpu")
    js, jm = jg.run_gauge_frames(js0, ja, jc, 2)
    ts, tm = tg.run_gauge_frames(port, ta, cfg, 2)
    for name, g, w in zip(ts._fields, ts, js):
        w = np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(_np(g).astype(w.dtype), w, err_msg=name)
        elif name == "plaq_mean":
            np.testing.assert_allclose(_np(g), w, rtol=3e-5, atol=3e-6, err_msg=name)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=TOL[group]["rtol"], atol=2e-6,
                                       err_msg=name)
    np.testing.assert_array_equal(_np(tm["stable"]), np.asarray(jm["stable"]))
    for key in ("dtau", "drift_max", "unitarity_norm"):
        np.testing.assert_allclose(_np(tm[key]), np.asarray(jm[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_loops_creutz_and_flow_match_jax(hot_links, group):
    links = hot_links[group]
    ja, ta = _actions(group)
    jl, tl = jnp.asarray(links), torch.from_numpy(links.copy())
    np.testing.assert_allclose(_np(gauge_loops.polyakov_loop(ta, tl, 1)),
                               np.asarray(jloops.polyakov_loop(ja, jl, 1)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(gauge_loops.wilson_loop(ta, tl, 0, 1, 2, 3)),
                               np.asarray(jloops.wilson_loop(ja, jl, 0, 1, 2, 3)),
                               rtol=1e-5, atol=1e-6)
    tab = gauge_loops.wilson_loop_table(ta, tl, 0, 1, 3, 3)
    jtab = jloops.wilson_loop_table(ja, jl, 0, 1, 3, 3)
    np.testing.assert_allclose(_np(tab), np.asarray(jtab), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(gauge_loops.creutz_ratio(tab, 2, 3)),
                               np.asarray(jloops.creutz_ratio(jtab, 2, 3)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(gauge_loops.wilson_flow(ta, tl, 2, 0.02, 2)),
                               np.asarray(jloops.wilson_flow(ja, jl, 2, 0.02, 2)), **TOL[group])


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
def test_flow_and_creutz_of_the_compact_groups_match_jax(group):
    cfg = jg.GaugeConfig(group=group, beta=2.0, shape=SHAPE, n_chains=2, seed=1, hot_start=True)
    links = np.asarray(jg.init_gauge_state(cfg).links)
    ja, ta = jga.get_gauge(group, beta=2.0), ga.get_gauge(group, beta=2.0)
    tol = dict(rtol=2e-5, atol=2e-6) if group == "su3" else dict(rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(
        _np(gauge_loops.wilson_flow(ta, torch.from_numpy(links.copy()), 2, 0.02, 3)),
        np.asarray(jloops.wilson_flow(ja, jnp.asarray(links), 2, 0.02, 3)), **tol)
    tab = gauge_loops.wilson_loop_table(ta, torch.from_numpy(links.copy()), 0, 1, 3, 3)
    jtab = jloops.wilson_loop_table(ja, jnp.asarray(links), 0, 1, 3, 3)
    np.testing.assert_allclose(_np(gauge_loops.creutz_ratio(tab, 3, 2)),
                               np.asarray(jloops.creutz_ratio(jtab, 3, 2)), rtol=1e-4, atol=1e-4)


def test_exact_plaquette_2d_at_complex_beta_matches_jax():
    for group in ("cu1", "csu2", "csu3"):
        for beta in (1.0 + 0.5j, 2.0 - 0.3j, 0.7):
            got, want = tg.exact_plaquette_2d(group, beta), jg.exact_plaquette_2d(group, beta)
            assert type(got) is type(want) and got == pytest.approx(want, rel=1e-12), (group, beta)
    for group in ("u1", "su2", "su3"):
        assert tg.exact_plaquette_2d(group, 1.7) == pytest.approx(jg.exact_plaquette_2d(group, 1.7),
                                                                  rel=1e-12)
    with pytest.raises(KeyError):
        tg.exact_plaquette_2d("so3", 1.0)


# ---------------------------------------------------------------------------
# the JAX package's known-answer tests, on the port
# ---------------------------------------------------------------------------


def _random_su(n, shape, seed=0):
    """Haar-ish random SU(n) field via QR of a complex Gaussian."""
    r = np.random.default_rng(seed)
    a = r.normal(size=shape + (n, n)) + 1j * r.normal(size=shape + (n, n))
    q, rr = np.linalg.qr(a)
    d = np.diagonal(rr, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    q = q / np.linalg.det(q)[..., None, None] ** (1.0 / n)
    return torch.from_numpy(q.astype(np.complex64))


def test_complex_drift_reduces_to_real_at_unitary_links():
    beta = 1.3
    u = _random_su(3, (3, 2, 4, 4), seed=5)
    hol = _np(ga.get_gauge("csu3", beta=beta).drift(u, 2))
    np.testing.assert_allclose(hol, _np(ga.get_gauge("su3", beta=beta).drift(u, 2)), rtol=0,
                               atol=2e-4)
    u2 = _random_su(2, (3, 2, 4, 4), seed=5)
    c2 = ga.get_gauge("csu2", beta=beta)
    assert float(c2.action(u2, 2).imag.abs().max()) < 1e-3
    hol2 = _np(c2.drift(u2, 2))
    np.testing.assert_allclose(hol2, np.conj(np.swapaxes(hol2, -1, -2)), rtol=0, atol=2e-4)


def test_cu1_drift_is_holomorphic_gradient():
    """cu1 drift ≡ −∂S/∂θ = −(∂ReS/∂Reθ − i·∂ReS/∂Imθ) (Cauchy–Riemann), by autograd."""
    a = ga.get_gauge("cu1", beta=0.9, beta_im=0.4)
    r = np.random.default_rng(3)
    tr = torch.tensor(r.normal(size=(2, 2, 6, 6)), dtype=torch.float32, requires_grad=True)
    ti = torch.tensor(0.1 * r.normal(size=(2, 2, 6, 6)), dtype=torch.float32,
                      requires_grad=True)
    s = a.action(torch.complex(tr, ti), 2).real.sum()
    gr, gi = torch.autograd.grad(s, (tr, ti))
    got = _np(a.drift(torch.complex(tr, ti).detach(), 2))
    np.testing.assert_allclose(got, -(gr.numpy() - 1j * gi.numpy()), rtol=0, atol=1e-4)


def test_csun_action_matches_real_wilson_on_su3():
    u = _random_su(3, (2, 2, 5, 5), seed=7)
    s_c = _np(ga.get_gauge("csu3", beta=2.1).action(u, 2))
    np.testing.assert_allclose(s_c.real, _np(ga.get_gauge("su3", beta=2.1).action(u, 2)),
                               rtol=0, atol=5e-3)
    assert np.max(np.abs(s_c.imag)) < 5e-3


def _gauge_transform_su(u, eps, seed):
    """U_μ(x) ← G(x) U_μ(x) G(x+μ̂)⁻¹ with G = exp(h), h hermitian traceless O(eps)."""
    n = u.shape[-1]
    r = np.random.default_rng(seed)
    coef = eps * r.normal(size=(u.shape[0],) + tuple(u.shape[2:-2]) + (n * n - 1,))
    h = np.einsum("...a,aij->...ij", coef, np.asarray(jgc._sun_generators(n))).astype(np.complex64)
    g, gi = gc.expm_taylor(torch.from_numpy(h)), gc.expm_taylor(torch.from_numpy(-h))
    return torch.stack([gc.mmul(gc.mmul(g, u[:, mu]), torch.roll(gi, -1, dims=mu + 1))
                        for mu in range(u.shape[1])], dim=1)


@pytest.mark.parametrize("cgroup", ["csu2", "csu3"])
def test_cooling_recovers_unitarity_and_preserves_plaquette(cgroup):
    n = int(cgroup[-1])
    a = ga.get_gauge(cgroup, beta=1.0)
    u = _gauge_transform_su(_random_su(n, (2, 2, 6, 6), seed=11), 0.3, seed=12)
    norm0 = float(a.unitarity_norm(u, 2).max())
    plaq0 = _np(a.mean_plaquette(u, 2))
    assert norm0 > 1e-2
    u_cool = a.cool(u, 2, rate=0.05, steps=60)
    norm1 = float(a.unitarity_norm(u_cool, 2).max())
    np.testing.assert_allclose(_np(a.mean_plaquette(u_cool, 2)), plaq0, rtol=0, atol=5e-4)
    assert norm1 < 0.05 * norm0 and norm1 < 1e-3


def test_cu1_cooling_gauge_invariance():
    a = ga.get_gauge("cu1", beta=1.0)
    r = np.random.default_rng(13)
    th = torch.from_numpy((r.normal(size=(2, 2, 8, 8))
                           + 0.3j * r.normal(size=(2, 2, 8, 8))).astype(np.complex64))
    plaq0 = _np(a.mean_plaquette(th, 2))
    norm0 = float(a.unitarity_norm(th, 2).max())
    th_c = a.cool(th, 2, rate=0.1, steps=50)
    np.testing.assert_allclose(_np(a.mean_plaquette(th_c, 2)), plaq0, rtol=0, atol=1e-4)
    assert float(a.unitarity_norm(th_c, 2).max()) < norm0


def test_cu1_drift_keeps_imaginary_angles_free_of_divergence():
    """cu1's drift is a lattice curl, so from unitary links (Im θ = 0) Im θ
    never gains a gauge (gradient) part and cooling has nothing to remove: a
    frame with cooling gives the links of a frame without it to rounding."""
    cfg = tg.GaugeConfig(group="cu1", beta=1.0, beta_im=0.5, shape=(8, 8), n_chains=2,
                         dtau=5e-3, loops=20, seed=2)
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    cooled, _ = tg.run_gauge_frames(s0, act, dataclasses.replace(cfg, cooling_rate=0.05), 1)
    plain, _ = tg.run_gauge_frames(s0, act, cfg, 1)
    im = plain.links.imag
    div = sum(im[:, mu] - torch.roll(im[:, mu], 1, dims=1 + mu) for mu in range(2))
    assert float(im.abs().max()) > 1e-3 and float(div.abs().max()) < 1e-5
    torch.testing.assert_close(cooled.links, plain.links, rtol=0, atol=1e-5)


def test_creutz_ratio_on_synthetic_area_law():
    """χ(r,t) = σ exactly for W = exp(−σ·r·t)."""
    sigma = 0.23
    table = torch.tensor(np.exp(-sigma * np.arange(1, 5)[:, None] * np.arange(1, 5)[None, :]))[None]
    assert abs(float(gauge_loops.creutz_ratio(table, 3, 3)[0]) - sigma) < 1e-6


@pytest.mark.slow  # the JAX twin is slow-marked (tests/test_gauge_loops.py:87)
def test_wilson_flow_monotone_and_smooths():
    for group in ("u1", "su2", "su3"):
        act = ga.get_gauge(group, beta=2.0)
        cfg = tg.GaugeConfig(group=group, beta=2.0, shape=(8, 8), n_chains=2, seed=1,
                             hot_start=True)
        links = tg.init_gauge_state(cfg, act, device="cpu").links
        actions = [float(act.action(links, 2).sum())]
        for _ in range(5):
            links = gauge_loops.wilson_flow(act, links, 2, eps=0.02, steps=5)
            actions.append(float(act.action(links, 2).sum()))
        assert all(b < a for a, b in zip(actions, actions[1:])), (group, actions)


def _physics(cfg, burn):
    action = tg.resolve_gauge_action(cfg)
    state, _ = tg.run_gauge_frames(tg.init_gauge_state(cfg, action, device="cpu"), action, cfg,
                                   burn)
    return tg.run_gauge_frames(tg.reset_gauge_means(state), action, cfg, cfg.frames)


@pytest.mark.slow  # the JAX twin is slow-marked (tests/test_gauge_complex.py:199)
def test_cu1_complex_beta_matches_analytic_continuation():
    beta = 1.0 + 0.5j
    cfg = tg.GaugeConfig(group="cu1", beta=beta.real, beta_im=beta.imag, shape=(8, 8),
                         n_chains=64, dtau=5e-3, loops=100, frames=60, seed=3, drift_cap=20.0,
                         cooling_rate=0.05)
    state, metrics = _physics(cfg, 20)
    vals = state.plaq_mean.numpy()
    est = complex(vals.mean())
    err = float(vals.real.std() + vals.imag.std()) / np.sqrt(len(vals)) + 1e-3
    assert abs(est - tg.exact_plaquette_2d("cu1", beta)) < 6.0 * err
    assert float(metrics["unitarity_norm"][-1].max()) < 0.5


@pytest.mark.slow  # the JAX twin is slow-marked (tests/test_gauge_complex.py:233)
def test_csu2_complex_beta_matches_weyl_integral():
    beta = 1.2 + 0.4j
    cfg = tg.GaugeConfig(group="csu2", beta=beta.real, beta_im=beta.imag, shape=(6, 6),
                         n_chains=48, dtau=2e-3, loops=100, frames=80, seed=5, drift_cap=20.0,
                         cooling_rate=0.05, cooling_steps=1)
    state, metrics = _physics(cfg, 30)
    vals = state.plaq_mean.numpy()
    est = complex(vals.mean())
    err = float(vals.real.std() + vals.imag.std()) / np.sqrt(len(vals)) + 2e-3
    assert abs(est - tg.exact_plaquette_2d("csu2", beta)) < 6.0 * err
    assert float(metrics["unitarity_norm"][-1].max()) < 0.5


@pytest.mark.slow  # the JAX twin is slow-marked (tests/test_gauge_complex.py:264)
def test_complex_group_real_beta_reduces_to_compact_answer():
    cfg = tg.GaugeConfig(group="csu3", beta=2.0, shape=(4, 4), n_chains=32, dtau=2e-3, loops=60,
                         frames=40, seed=9, cooling_rate=0.05)
    state, _ = _physics(cfg, 20)
    vals = state.plaq_mean.numpy()
    est = complex(vals.mean())
    err = float(vals.real.std()) / np.sqrt(len(vals)) + 2e-3
    want = tg.exact_plaquette_2d("su3", 2.0)
    assert abs(est.real - want) < 6.0 * err and abs(est.imag) < 6.0 * err

