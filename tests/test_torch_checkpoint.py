"""Chain, field, gauge and complex-Langevin checkpoints interchange between
the JAX package and the port, and resume bitwise inside the port."""

import json
import warnings

import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jact
from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import ChainConfig as JChainConfig
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu.integrators import gauge as jgauge
from stochquant_tpu.integrators import langevin as jl
from stochquant_tpu.io import checkpoint as jck
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import ChainConfig, FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field, gauge, langevin
from stochquant_tpu_torch.io import checkpoint

torch.set_num_threads(1)

CFG = ChainConfig(action="double_well", n_sites=24, dt=0.1, dtau=0.0005, n_chains=3,
                  loops=20, seed=8)
FCFG = FieldConfig(shape=(8, 12), dtau=0.01, n_chains=3, loops=4, seed=8,
                   sweep=Sweep.CHECKERBOARD)


def _jax(cfg):
    jcfg = JChainConfig.from_json(cfg.to_json())
    return jcfg, jact.get(cfg.action)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jcfg, ja = _jax(CFG)
    s2, _ = jl.run_frames(jl.init_chain_state(jcfg, ja), ja, jcfg, 2)
    path = tmp_path / "jax.npz"
    jck.save(path, s2, jcfg, frames_done=2)
    want, _ = jl.run_frames(s2, ja, jcfg, 1)

    state, cfg = checkpoint.load(path, "cpu")
    assert cfg == CFG and checkpoint.read_meta(path)["frames_done"] == 2
    for name, leaf in zip(s2._fields, s2):
        np.testing.assert_array_equal(checkpoint.state_to_numpy(state)[name],
                                      np.asarray(leaf), err_msg=name)
    assert state.runs.dtype == torch.int64 and state.step.dtype == torch.int64
    got, _ = langevin.run_frames(state, actions.get(cfg.action), cfg, 1)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=2e-6, err_msg=name)


def test_port_checkpoint_loads_in_jax(tmp_path):
    act = actions.get(CFG.action)
    state, _ = langevin.run_frames(langevin.init_chain_state(CFG, act, device="cpu"), act,
                                   CFG, 2)
    path = tmp_path / "port.npz"
    checkpoint.save(path, state, CFG, frames_done=2)
    jstate, jcfg = jck.load(path)
    assert jcfg == _jax(CFG)[0]
    assert jck.read_meta(path) == {"kind": "chain", "config": CFG.to_json(), "version": 1,
                                   "frames_done": 2}
    host = checkpoint.state_to_numpy(state)
    for name, leaf in zip(jstate._fields, jstate):
        leaf = np.asarray(leaf)
        assert leaf.dtype == host[name].dtype, name
        np.testing.assert_array_equal(leaf, host[name], err_msg=name)
    assert np.asarray(jstate.runs).dtype == np.uint32 and np.asarray(jstate.step).shape == ()


def test_resume_then_run_is_bitwise_in_the_port(tmp_path):
    act = actions.get(CFG.action)
    s0 = langevin.init_chain_state(CFG, act, device="cpu")
    full, _ = langevin.run_frames(s0, act, CFG, 6)
    half, _ = langevin.run_frames(s0, act, CFG, 3)
    path = tmp_path / "ck.npz"
    checkpoint.save(path, half, CFG)
    loaded, cfg2 = checkpoint.load(path, "cpu")
    assert cfg2 == CFG
    resumed, _ = langevin.run_frames(loaded, act, cfg2, 3)
    for name, a, b in zip(full._fields, full, resumed):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_old_layouts_upgrade_and_other_kinds_raise(tmp_path):
    act = actions.get(CFG.action)
    state = langevin.init_chain_state(CFG, act, device="cpu")
    host = checkpoint.state_to_numpy(state)
    payload = {f"state_{k}": v for k, v in host.items() if k != "x4_mean"}
    payload["state_runs"] = host["runs"][:, 0]  # pre-(lo, hi) layout: (C,) uint32
    meta = {"kind": "chain", "config": CFG.to_json(), "version": 1}
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = tmp_path / "old.npz"
    np.savez(path, **payload)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loaded, _ = checkpoint.load(path, "cpu")
    assert any("x4_mean" in str(w.message) for w in caught)
    assert loaded.runs.shape == (CFG.n_chains, 2) and int(loaded.runs[:, 1].abs().sum()) == 0
    assert torch.count_nonzero(loaded.x4_mean) == 0

    # every kind of the JAX package's single-file format is ported; an unknown tag raises
    meta = {"kind": "spin_glass", "config": "{}", "version": 1}
    gpath = tmp_path / "spin_glass.npz"
    np.savez(gpath, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    with pytest.raises(ValueError, match="spin_glass"):
        checkpoint.load(gpath, "cpu")
    with pytest.raises(ValueError, match="no single state class"):
        checkpoint.state_from_numpy({"phi": np.zeros(2)}, "cpu")


def test_jax_field_checkpoint_resumes_in_the_port(tmp_path):
    jcfg = JFieldConfig.from_json(FCFG.to_json())
    ja = jphi4.get_field(FCFG.action)
    s2, _ = jfield.run_field_frames(jfield.init_field_state(jcfg), ja, jcfg, 2)
    path = tmp_path / "jax_field.npz"
    jck.save(path, s2, jcfg, frames_done=2)
    want, _ = jfield.run_field_frames(s2, ja, jcfg, 1)

    state, cfg = checkpoint.load(path, "cpu")
    assert cfg == FCFG and type(state) is field.FieldState
    host = checkpoint.state_to_numpy(state)
    for name, leaf in zip(s2._fields, s2):
        np.testing.assert_array_equal(host[name], np.asarray(leaf), err_msg=name)
    got, _ = field.run_field_frames(state, actions.get_field(cfg.action), cfg, 1)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
        elif name in ("phi", "dtau", "lrg_vl"):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=2e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=3e-5, atol=3e-6, err_msg=name)


def test_port_field_checkpoint_loads_in_jax_and_resumes_bitwise(tmp_path):
    act = actions.get_field(FCFG.action)
    s0 = field.init_field_state(FCFG, device="cpu")
    full, _ = field.run_field_frames(s0, act, FCFG, 4)
    half, _ = field.run_field_frames(s0, act, FCFG, 2)
    path = tmp_path / "port_field.npz"
    checkpoint.save(path, half, FCFG, frames_done=2)
    jstate, jcfg = jck.load(path)
    assert jcfg == JFieldConfig.from_json(FCFG.to_json())
    assert jck.read_meta(path) == {"kind": "field", "config": FCFG.to_json(), "version": 1,
                                   "frames_done": 2}
    host = checkpoint.state_to_numpy(half)
    for name, leaf in zip(jstate._fields, jstate):
        leaf = np.asarray(leaf)
        assert leaf.dtype == host[name].dtype, name
        np.testing.assert_array_equal(leaf, host[name], err_msg=name)
    loaded, cfg2 = checkpoint.load(path, "cpu")
    resumed, _ = field.run_field_frames(loaded, act, cfg2, 2)
    for name, a, b in zip(full._fields, full, resumed):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_field_checkpoint_without_mag4_is_backfilled(tmp_path):
    state = field.init_field_state(FCFG, device="cpu")
    host = checkpoint.state_to_numpy(state)
    payload = {f"state_{k}": v for k, v in host.items() if k != "mag4_mean"}
    payload["state_runs"] = host["runs"][:, 0]
    meta = {"kind": "field", "config": FCFG.to_json(), "version": 1}
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = tmp_path / "old_field.npz"
    np.savez(path, **payload)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loaded, _ = checkpoint.load(path, "cpu")
    assert any("mag4_mean" in str(w.message) for w in caught)
    assert loaded.runs.shape == (FCFG.n_chains, 2)
    assert torch.count_nonzero(loaded.mag4_mean) == 0 and loaded.mag4_mean.shape == (3,)


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
def test_gauge_checkpoints_resume_in_either_package(group, tmp_path):
    cfg = gauge.GaugeConfig(group=group, beta=2.0, shape=(4, 8), n_chains=2, dtau=2e-3, loops=3,
                            seed=6, hot_start=True)
    jcfg = jgauge.GaugeConfig.from_json(cfg.to_json())
    ja = jgauge.resolve_gauge_action(jcfg)
    s1, _ = jgauge.run_gauge_frames(jgauge.init_gauge_state(jcfg, ja), ja, jcfg, 1)
    jpath = tmp_path / "jax_gauge.npz"
    jck.save(jpath, s1, jcfg, frames_done=1)
    want, _ = jgauge.run_gauge_frames(s1, ja, jcfg, 1)

    # JAX -> port: the same leaves, then one more frame agrees with JAX's
    state, cfg2 = checkpoint.load(jpath, "cpu")
    assert cfg2 == cfg and type(state) is gauge.GaugeState
    host = checkpoint.state_to_numpy(state)
    for name, leaf in zip(s1._fields, s1):
        leaf = np.asarray(leaf)
        assert host[name].dtype == leaf.dtype, name
        np.testing.assert_array_equal(host[name], leaf, err_msg=name)
    act = gauge.resolve_gauge_action(cfg)
    got, _ = gauge.run_gauge_frames(state, act, cfg, 1)
    tol = dict(rtol=2e-5 if group == "su3" else 2e-6, atol=2e-6)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **tol)

    # port -> JAX: byte-equal leaves (SU(3) links complex64), and the port
    # resumes its own checkpoint bitwise
    ppath = tmp_path / "port_gauge.npz"
    checkpoint.save(ppath, got, cfg, frames_done=2)
    jstate, jcfg2 = jck.load(ppath)
    assert jcfg2 == jcfg and jck.read_meta(ppath)["kind"] == "gauge"
    host = checkpoint.state_to_numpy(got)
    for name, leaf in zip(jstate._fields, jstate):
        leaf = np.asarray(leaf)
        assert leaf.dtype == host[name].dtype, name
        np.testing.assert_array_equal(leaf, host[name], err_msg=name)
    if group == "su3":
        assert host["links"].dtype == np.complex64
    loaded, _ = checkpoint.load(ppath, "cpu")
    a, _ = gauge.run_gauge_frames(loaded, act, cfg, 1)
    b, _ = gauge.run_gauge_frames(got, act, cfg, 1)
    for name, x, y in zip(a._fields, a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------------------
# complex Langevin and the complexified gauge groups
# ---------------------------------------------------------------------------

from stochquant_tpu.actions import complex_actions as jca  # noqa: E402
from stochquant_tpu.integrators import complex_field as jcf  # noqa: E402
from stochquant_tpu.integrators import complex_langevin as jcl  # noqa: E402
from stochquant_tpu_torch.actions import complex_actions as ca  # noqa: E402
from stochquant_tpu_torch.integrators import complex_field as cf  # noqa: E402
from stochquant_tpu_torch.integrators import complex_langevin as cl  # noqa: E402

# kind -> (port config, JAX module's init, run and config class, port's init and run)
COMPLEX_KINDS = {
    "complex0d": (cl.ComplexLangevinConfig(action="complex_quartic", n_chains=6, dtau=1e-2,
                                           loops=5, seed=3),
                  jcl.init_cl_state, jcl.run_cl_frames, jcl.ComplexLangevinConfig,
                  cl.init_cl_state, cl.run_cl_frames),
    "complex_chain": (cl.ComplexChainConfig(n_sites=8, n_chains=3, dtau=1e-2, loops=5, seed=3),
                      jcl.init_ccl_state, jcl.run_ccl_frames, jcl.ComplexChainConfig,
                      cl.init_ccl_state, cl.run_ccl_frames),
    "complex_field": (cf.ComplexFieldConfig(shape=(4, 6), n_chains=3, dtau=1e-2, loops=5, seed=3),
                      jcf.init_cfield_state, jcf.run_cfield_frames, jcf.ComplexFieldConfig,
                      cf.init_cfield_state, cf.run_cfield_frames),
}


def test_complex_states_are_told_apart_by_their_exact_leaves():
    """ComplexChainState's leaves are a subset of CLState's and
    ComplexFieldState's: each class is found by its exact leaf set (or its
    kind), never by a subset."""
    for kind, (cfg, jinit, _, jcfg_cls, tinit, _) in COMPLEX_KINDS.items():
        js = jinit(jcfg_cls.from_json(cfg.to_json()))
        arrays = {n: np.asarray(v) for n, v in zip(js._fields, js)}
        state = checkpoint.state_from_numpy(arrays, "cpu")
        assert type(state) is type(tinit(cfg, device="cpu")), kind
        assert type(checkpoint.state_from_numpy(arrays, "cpu", kind)) is type(state)
        for name, leaf in zip(js._fields, js):
            np.testing.assert_array_equal(checkpoint.state_to_numpy(state)[name],
                                          np.asarray(leaf), err_msg=name)
    with pytest.raises(ValueError, match="no single state class"):
        checkpoint.state_from_numpy({n: np.zeros(2) for n in cl.CLState._fields if n != "zi"},
                                    "cpu")


@pytest.mark.parametrize("kind", sorted(COMPLEX_KINDS))
def test_complex_checkpoints_resume_across_packages_bitwise(kind, tmp_path):
    cfg, jinit, jrun, jcfg_cls, tinit, trun = COMPLEX_KINDS[kind]
    jcfg = jcfg_cls.from_json(cfg.to_json())
    assert jcfg.to_json() == cfg.to_json()
    params = dict(getattr(cfg, "action_params", ()))
    ja, ta = jca.get_complex(cfg.action, **params), ca.get_complex(cfg.action, **params)
    s1, _ = jrun(jinit(jcfg), ja, jcfg, 1)
    jpath = tmp_path / "jax.npz"
    jck.save(jpath, s1, jcfg, frames_done=1)

    # JAX -> port: the same bits, and the port's next frame from them is the port's
    state, cfg2 = checkpoint.load(jpath, "cpu")
    assert cfg2 == cfg and checkpoint.read_meta(jpath)["kind"] == kind
    host = checkpoint.state_to_numpy(state)
    for name, leaf in zip(s1._fields, s1):
        assert host[name].dtype == np.asarray(leaf).dtype, name
        np.testing.assert_array_equal(host[name], np.asarray(leaf), err_msg=name)

    # port -> JAX: the port's state after one more frame loads in JAX bit for bit
    got, _ = trun(state, ta, cfg2, 1)
    ppath = tmp_path / "port.npz"
    checkpoint.save(ppath, got, cfg2, frames_done=2)
    jstate, jcfg3 = jck.load(ppath)
    assert jcfg3 == jcfg and jck.read_meta(ppath)["kind"] == kind
    for name, leaf in zip(jstate._fields, jstate):
        np.testing.assert_array_equal(np.asarray(leaf), checkpoint.state_to_numpy(got)[name],
                                      err_msg=name)
    # and a resume in the port is bitwise its uninterrupted run
    straight, _ = trun(tinit(cfg, device="cpu"), ta, cfg, 3)
    half, _ = trun(tinit(cfg, device="cpu"), ta, cfg, 2)
    checkpoint.save(ppath, half, cfg)
    resumed, _ = trun(checkpoint.load(ppath, "cpu")[0], ta, cfg, 1)
    for name, a, b in zip(straight._fields, straight, resumed):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("group", ["cu1", "csu3"])
def test_complexified_gauge_checkpoints_resume_across_packages_bitwise(group, tmp_path):
    cfg = gauge.GaugeConfig(group=group, beta=1.5, beta_im=0.5, shape=(4, 6), n_chains=2,
                            dtau=2e-3, loops=3, seed=6, hot_start=True, cooling_rate=0.05)
    jcfg = jgauge.GaugeConfig.from_json(cfg.to_json())
    assert jcfg.to_json() == cfg.to_json()
    ja, ta = jgauge.resolve_gauge_action(jcfg), gauge.resolve_gauge_action(cfg)
    s1, _ = jgauge.run_gauge_frames(jgauge.init_gauge_state(jcfg, ja), ja, jcfg, 1)
    jpath = tmp_path / "jax_gauge.npz"
    jck.save(jpath, s1, jcfg, frames_done=1)
    state, cfg2 = checkpoint.load(jpath, "cpu")
    assert cfg2 == cfg and state.links.dtype == torch.complex64
    assert state.plaq_mean.dtype == torch.complex64
    host = checkpoint.state_to_numpy(state)
    for name, leaf in zip(s1._fields, s1):
        assert host[name].dtype == np.asarray(leaf).dtype, name
        np.testing.assert_array_equal(host[name], np.asarray(leaf), err_msg=name)
    got, _ = gauge.run_gauge_frames(state, ta, cfg2, 1)
    ppath = tmp_path / "port_gauge.npz"
    checkpoint.save(ppath, got, cfg2, frames_done=2)
    jstate, jcfg3 = jck.load(ppath)
    assert jcfg3 == jcfg
    for name, leaf in zip(jstate._fields, jstate):
        np.testing.assert_array_equal(np.asarray(leaf), checkpoint.state_to_numpy(got)[name],
                                      err_msg=name)
    straight, _ = gauge.run_gauge_frames(gauge.init_gauge_state(cfg, ta, device="cpu"), ta, cfg, 3)
    half, _ = gauge.run_gauge_frames(gauge.init_gauge_state(cfg, ta, device="cpu"), ta, cfg, 2)
    checkpoint.save(ppath, half, cfg)
    resumed, _ = gauge.run_gauge_frames(checkpoint.load(ppath, "cpu")[0], ta, cfg, 1)
    for name, a, b in zip(straight._fields, straight, resumed):
        assert torch.equal(a, b), name
