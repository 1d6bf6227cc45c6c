"""The port's complex Langevin on D-dim field lattices against the JAX
package on the CPU (2-D and 3-D, even and odd ``loops``, one and three
frames), and the JAX package's known-answer tests of it run on the port.

Tolerances: decisions, ``runs``, ``stab_cnt`` and ``step`` exact; ``zr``,
``zi``, ``drift_max`` and ``dtau`` within rtol 1e-5, atol 1e-6; the
site-averaged means (``z2r_mean``, ``z2i_mean``, ``zim_mean``: sums over the
lattice in another order) within rtol 3e-5, atol 3e-6."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from stochquant_tpu.actions import complex_actions as jca
from stochquant_tpu.integrators import complex_field as jcf
from stochquant_tpu_torch.actions import complex_actions as ca
from stochquant_tpu_torch.integrators import complex_field as cf
from stochquant_tpu_torch.io import checkpoint

torch.set_num_threads(1)

EXACT = ("runs", "stab_cnt", "step")
SITE_MEANS = ("z2r_mean", "z2i_mean", "zim_mean")


def to_port(jstate):
    return checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(jstate._fields, jstate)}, "cpu")


def assert_matches_jax(got, want, label=""):
    assert type(got).__name__ == type(want).__name__
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in EXACT:
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=label + name)
        elif name in SITE_MEANS:
            np.testing.assert_allclose(g.numpy(), w, rtol=3e-5, atol=3e-6, err_msg=label + name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=label + name)


CASES = {
    "2d_gaussian_even": dict(shape=(8, 6), loops=6),
    "2d_quartic_odd": dict(action="complex_quartic", shape=(6, 8), loops=7, drift_cap=2.0,
                           action_params=(("lam", 2.0), ("sigma_im", 0.5))),
    "3d_gaussian_odd_spacing": dict(shape=(4, 4, 6), loops=5, spacing=0.8,
                                    action_params=(("sigma_re", 2.0),)),
    "2d_rejected": dict(action="complex_quartic", shape=(6, 6), loops=5, dtau=3e-2, clamp=0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cfield_frames_match_jax(case):
    cfg = cf.ComplexFieldConfig(**{**dict(n_chains=3, dtau=1e-2, seed=5), **CASES[case]})
    jc = jcf.ComplexFieldConfig.from_json(cfg.to_json())
    assert jc.to_json() == cfg.to_json() and cf.ComplexFieldConfig.from_json(cfg.to_json()) == cfg
    params = dict(cfg.action_params)
    ja, ta = jca.get_complex(cfg.action, **params), ca.get_complex(cfg.action, **params)
    js0 = jcf.init_cfield_state(jc)
    assert_matches_jax(cf.init_cfield_state(cfg, device="cpu"), js0, "init ")
    for frames in (1, 3):
        js, jm = jcf.run_cfield_frames(js0, ja, jc, frames)
        ts, tm = cf.run_cfield_frames(to_port(js0), ta, cfg, frames)
        assert_matches_jax(ts, js, f"{frames} frames ")
        np.testing.assert_array_equal(tm["stable"].numpy(), np.asarray(jm["stable"]))
        for key in ("dtau", "drift_max"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-5,
                                       atol=1e-6)
    if case == "2d_rejected":
        assert not np.asarray(jm["stable"]).all()


def test_exact_gaussian_z2_and_reset_match_jax():
    for shape, a, sigma in (((8, 8), 0.7, 1 + 0.5j), ((4, 4, 4), 1.0, 2.0), ((5, 3), 1.3, 0.4j)):
        assert cf.exact_gaussian_z2(shape, a, sigma) == jcf.exact_gaussian_z2(shape, a, sigma)
    cfg = cf.ComplexFieldConfig(shape=(4, 4), n_chains=2, loops=3)
    s, _ = cf.run_cfield_frames(cf.init_cfield_state(cfg, device="cpu"),
                                ca.get_complex(cfg.action), cfg, 1)
    r = cf.reset_cfield_means(s)
    for name in ("z2r_mean", "z2i_mean", "zim_mean", "runs"):
        assert not torch.count_nonzero(getattr(r, name)), name
    assert torch.equal(r.zr, s.zr) and torch.equal(r.drift_max, s.drift_max)


# ---------------------------------------------------------------------------
# the JAX package's known-answer tests (tests/test_complex_field.py), on the port
# ---------------------------------------------------------------------------


@pytest.mark.slow  # the JAX twin is slow-marked (tests/test_complex_field.py:11)
def test_complex_gaussian_field_2d_matches_exact_propagator():
    sigma = 1.0 + 0.5j
    act = ca.get_complex("complex_gaussian", sigma_re=1.0, sigma_im=0.5)
    cfg = cf.ComplexFieldConfig(shape=(8, 8), spacing=0.7, n_chains=512, dtau=2e-3, loops=100,
                                seed=11, grow_after=10**9)
    s, _ = cf.run_cfield_frames(cf.init_cfield_state(cfg, device="cpu"), act, cfg, 30)
    s, m = cf.run_cfield_frames(cf.reset_cfield_means(s), act, cfg, 80)
    assert m["stable"].all()
    want = cf.exact_gaussian_z2(cfg.shape, cfg.spacing, sigma)
    re, im = s.z2r_mean.double(), s.z2i_mean.double()
    got = complex(float(re.mean()), float(im.mean()))
    err = math.hypot(float(re.std()), float(im.std())) / math.sqrt(cfg.n_chains)
    assert abs(got - want) < 6 * err + 0.05 * abs(want), (got, want, err)


def test_complex_field_3d_free_limit_is_real():
    """With sigma_im = 0 the process stays on the real manifold (zi stays 0)
    and reproduces the real propagator."""
    act = ca.get_complex("complex_gaussian", sigma_re=2.0, sigma_im=0.0)
    cfg = cf.ComplexFieldConfig(shape=(4, 4, 4), n_chains=128, dtau=2e-3, loops=60, seed=3,
                                grow_after=10**9)
    s, m = cf.run_cfield_frames(cf.init_cfield_state(cfg, device="cpu"), act, cfg, 40)
    assert m["stable"].all()
    assert not torch.count_nonzero(s.zi) and not torch.count_nonzero(s.zim_mean)
    s, _ = cf.run_cfield_frames(cf.reset_cfield_means(s), act, cfg, 60)
    want = cf.exact_gaussian_z2(cfg.shape, cfg.spacing, 2.0).real
    re = s.z2r_mean.double()
    err = float(re.std()) / math.sqrt(cfg.n_chains)
    assert abs(float(re.mean()) - want) < 6 * err + 0.05 * want, (float(re.mean()), want, err)


def test_complex_field_drift_cap_keeps_finite():
    act = ca.get_complex("complex_quartic", sigma_re=1.0, sigma_im=1.0, lam=5.0)
    cfg = cf.ComplexFieldConfig(action="complex_quartic", shape=(8, 8), n_chains=64, dtau=5e-3,
                                loops=50, seed=7, drift_cap=1.0)
    s, _ = cf.run_cfield_frames(cf.init_cfield_state(cfg, device="cpu"), act, cfg, 20)
    assert torch.isfinite(s.zr).all() and torch.isfinite(s.zi).all()
    assert (s.drift_max > 0).all()


def test_complex_field_checkpoint_bitwise_resume(tmp_path):
    act = ca.get_complex("complex_gaussian")
    cfg = cf.ComplexFieldConfig(shape=(4, 4), n_chains=8, dtau=1e-3, loops=10, seed=6)
    full, _ = cf.run_cfield_frames(cf.init_cfield_state(cfg, device="cpu"), act, cfg, 4)
    half, _ = cf.run_cfield_frames(cf.init_cfield_state(cfg, device="cpu"), act, cfg, 2)
    p = tmp_path / "cf.npz"
    checkpoint.save(p, half, cfg)
    loaded, loaded_cfg = checkpoint.load(p, "cpu")
    assert loaded_cfg == cfg and type(loaded) is cf.ComplexFieldState
    resumed, _ = cf.run_cfield_frames(loaded, act, loaded_cfg, 2)
    for name, x, y in zip(full._fields, full, resumed):
        assert torch.equal(x, y), name


def test_complex_field_determinism_and_split_run():
    act = ca.get_complex("complex_gaussian")
    cfg = cf.ComplexFieldConfig(shape=(4, 4), n_chains=8, dtau=1e-3, loops=9, seed=5)
    a, _ = cf.run_cfield_frames(cf.init_cfield_state(cfg, device="cpu"), act, cfg, 4)
    b1, _ = cf.run_cfield_frames(cf.init_cfield_state(cfg, device="cpu"), act, cfg, 2)
    b2, _ = cf.run_cfield_frames(b1, act, dataclasses.replace(cfg), 2)
    for name, x, y in zip(a._fields, a, b2):
        assert torch.equal(x, y), name
