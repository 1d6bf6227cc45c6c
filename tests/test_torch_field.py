"""The port's plain PyTorch field integrator against the JAX package's XLA
integrator (stochquant_tpu.integrators.field): same Threefry counters and
expression order, so the trajectory (φ, lrg_vl, Δτ) agrees to float32
rounding of the transcendentals (2e-6) with accept/reject decisions, runs
and step exact; the site means (M, φ², s, slice correlator) agree within
rtol 3e-5 / atol 3e-6, since their sums are taken in another order — the
bar tests/test_field_kernel.py holds the Pallas kernel to."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import FieldConfig, Scheme, Sweep
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.io import checkpoint

torch.set_num_threads(1)

EXACT = ("runs", "stab_cnt", "step")
MEANS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean",
         "corr_mean")
CASES = {
    "sync": FieldConfig(shape=(16, 32), dtau=0.005, n_chains=3, loops=6, seed=23),
    "checkerboard_odd_loops_tf13": FieldConfig(shape=(12, 20), dtau=0.01, n_chains=3, loops=7,
                                               seed=4, sweep=Sweep.CHECKERBOARD,
                                               rng_impl="threefry13"),
    "rejections": FieldConfig(shape=(8, 32), dtau=0.5, n_chains=3, loops=4, seed=2),
    # near EM's stability bound 2/(8 + m²): some frames trip, others grow Δτ
    "grow_shrink_dtau_max": FieldConfig(shape=(8, 16), dtau=0.17, n_chains=3, loops=4, seed=7,
                                        grow_after=1, dtau_max=0.1734),
    "free_field_checkerboard": FieldConfig(action="free_field", shape=(10, 16), dtau=0.02,
                                           n_chains=2, loops=5, seed=8,
                                           sweep=Sweep.CHECKERBOARD),
    "phi4_4d": FieldConfig(shape=(4, 4, 4, 4), dtau=0.005, n_chains=2, loops=4, seed=1),
}


def jax_start(cfg, stab_cnt=None):
    jcfg = JFieldConfig.from_json(cfg.to_json())
    s0 = jfield.init_field_state(jcfg)
    if stab_cnt is not None:
        s0 = s0._replace(stab_cnt=jnp.asarray(stab_cnt, jnp.int32))
    return jcfg, jphi4.get_field(cfg.action), s0


def to_port(jstate):
    return checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(jstate._fields, jstate)}, "cpu"
    )


def assert_matches_jax(got, want, label=""):
    for name, g, w in zip(got._fields, got, want):
        w, g = np.asarray(w), g.numpy()
        if name in EXACT:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=f"{label}:{name}")
            continue
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        tol = dict(rtol=3e-5, atol=3e-6) if name in MEANS else dict(rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(g, w, err_msg=f"{label}:{name}", **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_field_frames_matches_jax(name):
    cfg = CASES[name]
    # stability counters 0, 1, 2, … around grow_after: accepted frames grow Δτ
    # on some chains (capped by dtau_max where set), rejected ones shrink it
    jcfg, jact, s0 = jax_start(cfg, stab_cnt=np.arange(cfg.n_chains) * (cfg.grow_after // 2 + 1))
    want, wm = jfield.run_field_frames(s0, jact, jcfg, 3)
    got, gm = field.run_field_frames(to_port(s0), actions.get_field(cfg.action), cfg, 3)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    for key in ("dtau", "max_phi"):
        np.testing.assert_allclose(gm[key].numpy(), np.asarray(wm[key]), rtol=2e-6, err_msg=key)
    assert_matches_jax(got, want, label=name)
    if name == "rejections":
        assert not gm["stable"].all(), "case must trip the detector"
    if name == "grow_shrink_dtau_max":
        assert (gm["dtau"] == np.float32(0.1734)).any(), "case must hit the dtau_max cap"
        assert (gm["dtau"] < np.float32(0.17)).any(), "case must shrink dtau"


@pytest.mark.parametrize("cfg", [CASES["sync"], CASES["checkerboard_odd_loops_tf13"],
                                 CASES["phi4_4d"]])
def test_init_field_state_matches_jax(cfg):
    """Threefry bits are equal in both packages; φ differs only by the
    rounding of the CPU's log/cos (≤ a few ulp), every other leaf exactly."""
    _, _, want = jax_start(cfg)
    got = field.init_field_state(cfg, device="cpu")
    assert got.step.device.type == "cpu" and int(got.step) == 1
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in ("phi", "lrg_vl"):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)


def test_observables_and_reset_match_jax():
    cfg = CASES["sync"]
    jcfg, jact, s0 = jax_start(cfg)
    want, _ = jfield.run_field_frames(s0, jact, jcfg, 2)
    got, _ = field.run_field_frames(to_port(s0), actions.get_field(cfg.action), cfg, 2)
    volume = cfg.shape[0] * cfg.shape[1]
    np.testing.assert_allclose(field.susceptibility(got, volume).numpy(),
                               np.asarray(jfield.susceptibility(want, volume)), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(field.binder_cumulant(got).numpy(),
                               np.asarray(jfield.binder_cumulant(want)), rtol=1e-4, atol=1e-6)
    assert_matches_jax(field.reset_field_means(got), jfield.reset_field_means(want), "reset")
    fresh = field.binder_cumulant(field.init_field_state(cfg, device="cpu"))
    assert torch.isfinite(fresh).all() and (fresh == 1.0).all()


def test_checkerboard_mask_matches_jax():
    for shape in ((4, 6), (3, 5, 2)):
        np.testing.assert_array_equal(field.checkerboard_mask(shape, len(shape)).numpy(),
                                      np.asarray(jfield.checkerboard_mask(shape, len(shape))))


@pytest.mark.parametrize("change,feature", [
    (dict(scheme=Scheme.EXACT), "EXACT"),
    (dict(scheme=Scheme.EXACT, action="free_field"), "EXACT"),
    (dict(rng_impl="hardware"), "hardware"),
])
def test_unported_field_features_raise(change, feature):
    """The name dates from when these raised.  Each now runs on the plain path
    and matches the JAX XLA path: Scheme.EXACT as ETD1 on phi4 (m² = 1 > 0) and
    as the pure exact-OU step on free_field; under rng_impl='hardware' both
    plain runners draw Threefry-20, the 'threefry' trajectory."""
    base = CASES["sync"]
    cfg = dataclasses.replace(base, **change)
    jcfg, jact, s0 = jax_start(cfg)
    want, wm = jfield.run_field_frames(s0, jact, jcfg, 2)
    got, gm = field.run_field_frames(to_port(s0), actions.get_field(cfg.action), cfg, 2)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    assert gm["stable"].all()
    # EXACT: pocketfft in both, but the transforms sum in another order than
    # XLA's: φ to 2e-5 (float32 FFT round trips), the rest at the usual bars
    if feature == "EXACT":
        np.testing.assert_allclose(got.phi.numpy(), np.asarray(want.phi), rtol=2e-5, atol=2e-5)
        got, want = got._replace(phi=got.phi * 0), want._replace(phi=want.phi * 0)
    assert_matches_jax(got, want, label=feature)
    if feature == "hardware":
        plain, _ = field.run_field_frames(to_port(s0), actions.get_field(cfg.action), base, 2)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
