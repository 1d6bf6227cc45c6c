"""The port's gauge halo and chunk runners on a mesh of repeated CPU devices:
links split over the mesh give the unsplit plain integrator's links bit for
bit (the chunk runner: while the drift cap is quiescent), the plaquette mean
to float tolerance (a sum completed across shards), and agree with the JAX
package's ``make_gauge_halo_runner`` on its 8-device CPU mesh (links within
2e-6, su3 rtol 2e-5; decisions exact)."""

import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu.integrators import gauge as jg
from stochquant_tpu.parallel import make_mesh as jmake_mesh
from stochquant_tpu.parallel.gauge_halo import make_gauge_halo_runner as jmake_gauge_halo_runner
from stochquant_tpu.parallel.gauge_halo import shard_gauge_state as jshard_gauge_state
from stochquant_tpu_torch.integrators import gauge as tg
from stochquant_tpu_torch.integrators.gauge import GaugeConfig
from stochquant_tpu_torch.kernels import gauge_kernel as gk
from stochquant_tpu_torch.parallel import (
    gather_gauge_state, make_mesh, shard_gauge_state, shard_state_from_numpy,
)
from stochquant_tpu_torch.parallel.gauge_halo import (
    make_gauge_chunk_runner, make_gauge_halo_runner,
)

torch.set_num_threads(1)

BITWISE = ("links", "drift_max", "dtau", "runs", "stab_cnt", "step")
LINKS_TOL = {"u1": dict(rtol=2e-6, atol=2e-6), "su2": dict(rtol=2e-6, atol=2e-6),
             "su3": dict(rtol=2e-5, atol=2e-6)}


def run_split(cfg, mesh_shape, make, frames=2, s0=None, **kw):
    """(unsplit plain run, split run gathered, their metrics, the runner)."""
    act = tg.resolve_gauge_action(cfg)
    base = dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None, exchange_steps=0)
    if s0 is None:
        s0 = tg.init_gauge_state(base, act, device="cpu")
    ref, mref = tg.run_gauge_frames(s0, act, base, frames)
    mesh = make_mesh(mesh_shape, devices="cpu")
    runner = make(act, cfg, mesh, **kw)
    out, mout = runner(shard_gauge_state(s0, act, mesh, cfg), frames)
    return ref, gather_gauge_state(out, act, mesh, cfg), mref, mout, runner


def assert_same_run(ref, out, mref, mout):
    for name in BITWISE:
        assert torch.equal(getattr(ref, name), getattr(out, name)), name
    for key in ("stable", "dtau", "drift_max", "unitarity_norm"):
        assert torch.equal(mref[key], mout[key]), key
    torch.testing.assert_close(out.plaq_mean, ref.plaq_mean, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the per-step halo runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_axes,mesh_shape,chain_ax", [  # tests/test_gauge_halo.py:49-56
    (("x", None), [("x", 4)], None),
    (("x", "y"), [("x", 2), ("y", 2)], None),
    (("x", "y"), [("chain", 2), ("x", 2), ("y", 2)], "chain"),
])
def test_u1_halo_matches_unsplit(mesh_axes, mesh_shape, chain_ax):
    cfg = GaugeConfig(group="u1", beta=1.0, shape=(8, 8), n_chains=4, dtau=5e-3, loops=5, seed=11,
                      hot_start=True, mesh_axes=mesh_axes, mesh_chain_axis=chain_ax)
    assert_same_run(*run_split(cfg, mesh_shape, make_gauge_halo_runner, frames=3)[:4])


@pytest.mark.parametrize("group,beta,dtau,shape,mesh_axes,mesh_shape,cap", [
    ("su2", 2.0, 2e-3, (8, 8), ("x", "y"), [("x", 2), ("y", 2)], 20.0),
    ("su2", 2.0, 2e-3, (8, 8), (None, "y"), [("y", 4)], 1.0),     # the cap rescales every step
    ("su3", 5.0, 1e-3, (4, 4), ("x", "y"), [("x", 2), ("y", 2)], 20.0),
    ("su3", 5.0, 1e-3, (4, 8), ("x", None), [("x", 2)], 2.0),
    ("u1", 1.0, 5e-3, (4, 4, 2, 2), ("x", None, "y", None), [("x", 2), ("y", 2)], 20.0),
    ("u1", 1.0, 5e-3, (8, 8), ("x", "y"), [("x", 2), ("y", 1)], 0.5),  # an axis of size 1
])
def test_halo_matches_unsplit_for_every_group_and_a_4d_lattice(group, beta, dtau, shape,
                                                               mesh_axes, mesh_shape, cap):
    cfg = GaugeConfig(group=group, beta=beta, shape=shape, n_chains=2, dtau=dtau, loops=4, seed=7,
                      hot_start=True, mesh_axes=mesh_axes, drift_cap=cap)
    ref, out, mref, mout, _ = run_split(cfg, mesh_shape, make_gauge_halo_runner)
    assert_same_run(ref, out, mref, mout)
    assert bool((mref["drift_max"] > cap).any()) == (cap < 20.0)  # the cap was live, or not


def test_halo_runner_rejects_a_frame_on_every_shard_of_the_chain():
    """A NaN link on one shard rejects the chain's frame on all of them (the
    non-finite flag is completed across the lattice axes)."""
    cfg = GaugeConfig(group="u1", shape=(8, 8), n_chains=2, dtau=5e-3, loops=3, seed=3,
                      hot_start=True, mesh_axes=("x", "y"))
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    links = s0.links.clone()
    links[1, 0, 6, 1] = float("nan")
    ref, out, mref, mout, _ = run_split(cfg, [("x", 2), ("y", 2)], make_gauge_halo_runner,
                                        s0=s0._replace(links=links))
    assert mout["stable"].tolist() == [[True, False]] * 2
    for name in ("dtau", "runs", "stab_cnt", "step"):
        assert torch.equal(getattr(ref, name), getattr(out, name)), name
    torch.testing.assert_close(out.links, ref.links, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(mref["stable"], mout["stable"])


@pytest.mark.parametrize("group,shape,mesh_axes,mesh_shape,chain_ax", [
    ("u1", (8, 8), ("x", "y"), [("chain", 2), ("x", 2), ("y", 2)], "chain"),
    ("su2", (8, 8), ("x", None), [("x", 4)], None),
    ("su3", (4, 4), ("x", "y"), [("x", 2), ("y", 2)], None),
])
def test_halo_runner_matches_jax_halo_runner(group, shape, mesh_axes, mesh_shape, chain_ax):
    cfg = GaugeConfig(group=group, beta={"u1": 1.0, "su2": 2.0, "su3": 5.0}[group], shape=shape,
                      n_chains=2, dtau=2e-3, loops=4, seed=5, hot_start=True, mesh_axes=mesh_axes,
                      mesh_chain_axis=chain_ax)
    jcfg = jg.GaugeConfig.from_json(cfg.to_json())
    jact = jg.resolve_gauge_action(jcfg)
    js = jg.init_gauge_state(jcfg, jact)
    jmesh = jmake_mesh(mesh_shape)
    want, wm = jmake_gauge_halo_runner(jact, jcfg, jmesh)(
        jshard_gauge_state(js, jact, jmesh, jcfg), 2)
    act = tg.resolve_gauge_action(cfg)
    mesh = make_mesh(mesh_shape, devices="cpu")
    arrays = {name: np.asarray(leaf) for name, leaf in zip(js._fields, js)}
    out, gm = make_gauge_halo_runner(act, cfg, mesh)(
        shard_state_from_numpy(arrays, mesh, cfg, act), 2)
    got = gather_gauge_state(out, act, mesh, cfg)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    np.testing.assert_allclose(gm["drift_max"].numpy(), np.asarray(wm["drift_max"]), rtol=2e-6)
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        elif name == "links":
            np.testing.assert_allclose(g, w, err_msg=name, **LINKS_TOL[group])
        elif name == "plaq_mean":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the chunk runner (kernel 12)
# ---------------------------------------------------------------------------


def _chunk_cfg(group="u1", **kw):
    base = dict(group=group, beta={"u1": 1.0, "su2": 2.0, "su3": 5.0}[group], shape=(16, 16),
                n_chains=4, dtau={"u1": 5e-3, "su2": 2e-3, "su3": 1e-3}[group], loops=6, seed=11,
                hot_start=True, mesh_axes=("x", None), grow_after=10**9)
    base.update(kw)
    return GaugeConfig(**base)


@pytest.mark.parametrize("mesh_shape,chain_ax,W,want_W", [  # tests/test_gauge_halo.py:173-181
    ([("x", 2)], None, 0, 6),                   # auto: min(8, loc0 = 8, loops = 6)
    ([("x", 4)], None, 0, 4),                   # thin slabs: loc0 = 4, then a W = 2 tail
    ([("chain", 2), ("x", 2)], "chain", 4, 4),  # with a chain split, W = 4 and a tail
    ([("x", 1)], None, 2, 2),                   # a ring of one
])
def test_u1_chunk_matches_unsplit_frame(mesh_shape, chain_ax, W, want_W):
    cfg = _chunk_cfg(mesh_chain_axis=chain_ax, exchange_steps=W)
    ref, out, mref, mout, runner = run_split(cfg, mesh_shape, make_gauge_chunk_runner, frames=3)
    assert runner.exchange_steps == want_W
    assert_same_run(ref, out, mref, mout)
    assert float(ref.drift_max.max()) < cfg.drift_cap  # the cap stayed quiescent


@pytest.mark.parametrize("group,shape", [("su2", (8, 16)), ("su3", (8, 8))])
def test_su2_su3_chunk_matches_unsplit_frame(group, shape):
    cfg = _chunk_cfg(group, shape=shape, n_chains=2, loops=4, seed=7)
    assert_same_run(*run_split(cfg, [("x", 2)], make_gauge_chunk_runner)[:4])


def test_chunk_runner_equals_the_halo_runner_and_counts_its_chunks():
    calls = []

    def chunk(ext, dtau, action, cfg, loc0, W, step, chain_off, row_off):
        calls.append((W, step, chain_off, row_off, tuple(ext.shape)))
        return gk.gauge_chunk_ref(ext, dtau, action, cfg, loc0, W, step, chain_off, row_off)

    cfg = _chunk_cfg(mesh_chain_axis="chain", exchange_steps=4)
    mesh_shape = [("chain", 2), ("x", 2)]
    ref, out, mref, mout, _ = run_split(cfg, mesh_shape, make_gauge_chunk_runner, frames=1,
                                        chunk=chunk)
    assert_same_run(ref, out, mref, mout)
    # per shard a W = 4 chunk from step 1 and a W = 2 tail from step 5, on 8 + 2 H rows
    assert calls[:4] == [(4, 1, 0, 0, (2, 2, 16, 16)), (4, 1, 0, 8, (2, 2, 16, 16)),
                         (4, 1, 2, 0, (2, 2, 16, 16)), (4, 1, 2, 8, (2, 2, 16, 16))]
    assert [c[:2] for c in calls[4:]] == [(2, 5)] * 4 and calls[4][4] == (2, 2, 12, 16)
    halo = run_split(cfg, mesh_shape, make_gauge_halo_runner, frames=1)[1]
    for name in BITWISE:
        assert torch.equal(getattr(halo, name), getattr(out, name)), name


def test_chunk_cap_event_rejects_frame():
    """A drift-cap event rejects the frame (rollback and Δτ shrink) instead of
    the unsplit path's per-step rescale; the drift_max metric is the rejected
    trajectory's, the state's is rolled back."""
    cfg = _chunk_cfg(n_chains=2, loops=4, drift_cap=1e-6)
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    mesh = make_mesh([("x", 2)], devices="cpu")
    out, m = make_gauge_chunk_runner(act, cfg, mesh)(shard_gauge_state(s0, act, mesh, cfg), 1)
    out = gather_gauge_state(out, act, mesh, cfg)
    assert not m["stable"].any()
    assert torch.equal(out.links, s0.links) and torch.equal(out.runs, s0.runs)
    assert torch.equal(out.drift_max, s0.drift_max) and bool((m["drift_max"] > 1e-6).all())
    torch.testing.assert_close(out.dtau, s0.dtau * cfg.shrink, rtol=1e-6, atol=0)
    assert int(out.step) == int(s0.step) + cfg.loops  # a rejected frame still advances step
    # one chain's NaN link rejects that chain alone, on every shard
    links = s0.links.clone()
    links[1, 0, 12, 3] = float("nan")
    ok = dataclasses.replace(cfg, drift_cap=20.0)
    out, m = make_gauge_chunk_runner(act, ok, mesh)(
        shard_gauge_state(s0._replace(links=links), act, mesh, ok), 1)
    assert m["stable"].tolist() == [[True, False]]


@pytest.mark.parametrize("kw,mesh_shape,match", [
    (dict(mesh_axes=None), [("x", 2)], "mesh_axes"),
    (dict(loops=5), [("x", 2)], "even"),
    (dict(mesh_axes=(None, "x")), [("x", 2)], "dim 0"),
    (dict(mesh_axes=("x", "y")), [("x", 2), ("y", 2)], "dim 0"),
    (dict(exchange_steps=7), [("x", 2)], "even"),
    (dict(exchange_steps=4), [("x", 8)], "exceeds the local slab"),
    (dict(), [("x", 16)], "W >= 2"),
    (dict(shape=(4, 4, 4, 4), mesh_axes=("x", None, None, None)), [("x", 2)], "2-D"),
    (dict(cooling_rate=0.1), [("x", 2)], "no cooling"),
    (dict(shape=(12, 16)), [("x", 8)], "not divisible"),
])
def test_chunk_runner_validation(kw, mesh_shape, match):
    cfg = _chunk_cfg(**kw)
    mesh = make_mesh(mesh_shape, devices="cpu")
    with pytest.raises(ValueError, match=match):
        make_gauge_chunk_runner(tg.resolve_gauge_action(cfg), cfg, mesh)


def test_chunk_runner_w_contracts():
    """An explicit W beyond the frame length is clamped (loops 4, W = 8 runs
    one chunk of 4, H = 4 <= loc0 = 8) and still gives the unsplit links."""
    cfg = _chunk_cfg(n_chains=2, loops=4, exchange_steps=8)
    ref, out, mref, mout, runner = run_split(cfg, [("x", 2)], make_gauge_chunk_runner)
    assert runner.exchange_steps == 4
    assert_same_run(ref, out, mref, mout)


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_axes=None), "mesh_axes required"),
    (dict(cooling_rate=0.1), "cooling is not supported"),
    (dict(group="cu1"), "not ported"),
    (dict(mesh_axes=("x",)), "one entry per lattice dim"),
    (dict(shape=(6, 8)), "not divisible"),
])
def test_halo_runner_validation(kw, match):
    cfg = GaugeConfig(**{**dict(group="u1", shape=(8, 8), n_chains=2, mesh_axes=("x", None)), **kw})
    mesh = make_mesh([("x", 4)], devices="cpu")
    with pytest.raises(ValueError, match=match):
        make_gauge_halo_runner(_action(cfg), cfg, mesh)


def _action(cfg):
    """The action of a config whose group the port has (the refusal under
    test comes from the runner, not from resolving the action)."""
    return tg.resolve_gauge_action(dataclasses.replace(cfg, group="u1"))
