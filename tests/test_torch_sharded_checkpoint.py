"""Sharded checkpoints in the port: every case of
``tests/test_sharded_checkpoint.py``, and sharded files crossing between the
packages both ways.

One process holds every shard here (a mesh of the CPU, the device repeated),
which runs the whole index-matching path; the cycle across processes is in
``tests/test_torch_distributed.py``.  Tolerances: none — a restored state is
the saved one bit for bit, and a resumed run the uninterrupted one; across
the packages the arrays on disk are compared bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu.io import checkpoint as jck
from stochquant_tpu.parallel import make_mesh as jmake_mesh
from stochquant_tpu.parallel import shard_field_state as jshard_field_state
from stochquant_tpu_torch import actions, metrics, runtime
from stochquant_tpu_torch.config import ChainConfig, FieldConfig
from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint as ckpt
from stochquant_tpu_torch.parallel import make_mesh, shard_field_state
from stochquant_tpu_torch.parallel import mesh as mesh_mod
from stochquant_tpu_torch.parallel.halo import make_halo_runner

torch.set_num_threads(1)


def _halo_cfg(**kw):
    base = dict(action="phi4", shape=(8, 8), dtau=0.01, n_chains=4, loops=4, frames=2, seed=21,
                mesh_axes=("x", "y"), mesh_chain_axis="chain")
    base.update(kw)
    return FieldConfig(**base)


def _mesh():
    return make_mesh([("chain", 2), ("x", 2), ("y", 2)], devices="cpu")


def _start(cfg, mesh):
    return shard_field_state(field_mod.init_field_state(cfg, device="cpu"), mesh, cfg)


def _same_shards(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        for name, u, v in zip(x._fields, x, y):
            assert torch.equal(u, v), (i, name)


def test_sharded_roundtrip_bitwise_and_resume_continues(tmp_path):
    cfg, mesh = _halo_cfg(), _mesh()
    runner = make_halo_runner(actions.get_field(cfg.action), cfg, mesh)
    s2, _ = runner(_start(cfg, mesh), 2)
    path = str(tmp_path / "ck")
    out = ckpt.save_sharded(path, s2, cfg, mesh, frames_done=2)
    assert out.endswith(".proc0-of-1.npz")
    assert ckpt.is_sharded_checkpoint(path)
    assert ckpt.read_meta_any(path)["frames_done"] == 2
    restored, loaded_cfg = ckpt.load_sharded(path, mesh)
    assert loaded_cfg == cfg
    _same_shards(s2, restored)  # values and placement (each shard's own block)
    s3_direct, _ = runner(s2, 1)
    s3_resumed, _ = runner(restored, 1)
    _same_shards(s3_direct, s3_resumed)


def test_runtime_field_halo_sharded_checkpoint_cycle(tmp_path):
    """run_field on a mesh: a sharded checkpoint after half the frames,
    resumed through the runtime, equals the uninterrupted run bitwise."""
    cfg, mesh = _halo_cfg(frames=4), _mesh()
    full = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink())
    half = runtime.run_field(dataclasses.replace(cfg, frames=2), mesh=mesh,
                             sink=metrics.MetricsSink())
    ck = str(tmp_path / "halo_ck")
    ckpt.save_sharded(ck, shard_field_state(half.state, mesh, cfg), cfg, mesh, frames_done=2)
    recs = []
    res = runtime.run_field(cfg, mesh=mesh, checkpoint_in=ck, resume_progress=True,
                            sink=metrics.MetricsSink(callback=recs.append))
    assert [r["frame"] for r in recs if r["type"] == "frame"] == [2, 3]
    for name, a, b in zip(full.state._fields, full.state, res.state):
        assert torch.equal(a, b), name
    # without a mesh a sharded checkpoint is refused, as the JAX runner refuses it
    with pytest.raises(ValueError, match="sharded checkpoint"):
        runtime.run_field(dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None),
                          device="cpu", checkpoint_in=ck, sink=metrics.MetricsSink())


def test_load_sharded_rejects_misaligned_mesh(tmp_path):
    cfg, mesh = _halo_cfg(), _mesh()
    path = str(tmp_path / "ck")
    ckpt.save_sharded(path, _start(cfg, mesh), cfg, mesh)
    bad_mesh = make_mesh([("chain", 1), ("x", 4), ("y", 2)], devices="cpu")
    with pytest.raises(ValueError, match="missing shard"):
        ckpt.load_sharded(path, bad_mesh)


def test_resave_prunes_stale_shard_generations(tmp_path):
    cfg, mesh = _halo_cfg(), _mesh()
    state = _start(cfg, mesh)
    path = str(tmp_path / "ck")
    # generation 1: the shards of a mesh said to span 4 processes, this one the first
    ckpt.save_sharded(path, state, cfg, dataclasses.replace(mesh, process_count=4))
    assert (tmp_path / "ck.proc0-of-4.npz").exists()
    ckpt.save_sharded(path, state, cfg, mesh)  # generation 2 supersedes it
    assert not (tmp_path / "ck.proc0-of-4.npz").exists()
    assert (tmp_path / "ck.proc0-of-1.npz").exists()
    restored, _ = ckpt.load_sharded(path, mesh)
    _same_shards(state, restored)


def test_single_file_resave_supersedes_sharded(tmp_path):
    cfg, mesh = _halo_cfg(), _mesh()
    state = _start(cfg, mesh)
    path = str(tmp_path / "ck")
    ckpt.save_sharded(path, state, cfg, mesh)
    assert ckpt.is_sharded_checkpoint(path)
    whole = mesh_mod.gather_field_state(state, mesh, cfg)
    ckpt.save(path, whole, cfg)
    assert not ckpt.is_sharded_checkpoint(path)
    restored, _ = ckpt.load(path, "cpu")
    assert torch.equal(restored.phi, whole.phi)


def test_load_sharded_rejects_mixed_generations(tmp_path, monkeypatch):
    cfg, mesh = _halo_cfg(), _mesh()
    state = _start(cfg, mesh)
    path = str(tmp_path / "ck")
    ckpt.save_sharded(path, state, cfg, mesh)
    monkeypatch.setattr(ckpt, "_prune_stale_shards", lambda *a, **k: None)
    ckpt.save_sharded(path, state, cfg, dataclasses.replace(mesh, process_count=4))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="mixed shard generations"):
        ckpt.load_sharded(path, mesh)


def test_save_auto_picks_single_file_when_addressable(tmp_path):
    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=2, frames=1)
    state = field_mod.init_field_state(cfg, device="cpu")
    p = tmp_path / "plain.npz"
    ckpt.save_auto(str(p), state, cfg, frames_done=1)
    assert p.exists() and not ckpt.is_sharded_checkpoint(str(p))
    # the shards of a one-process mesh: gathered into the whole-state file
    cfg, mesh = _halo_cfg(), _mesh()
    shards = _start(cfg, mesh)
    q = tmp_path / "split.npz"
    ckpt.save_auto(str(q), shards, cfg, mesh=mesh, frames_done=1)
    loaded, _ = ckpt.load(q, "cpu")
    assert torch.equal(loaded.phi, mesh_mod.gather_field_state(shards, mesh, cfg).phi)
    assert not ckpt.is_sharded_checkpoint(str(q))
    # a mesh across processes: each writes its own file
    across = dataclasses.replace(mesh, process_count=2)
    ckpt.save_auto(str(q), shards, cfg, mesh=across, frames_done=1)
    assert (tmp_path / "split.npz.proc0-of-2.npz").exists()


def _jax_split_state(cfg):
    jcfg = JFieldConfig.from_json(cfg.to_json())
    jmesh = jmake_mesh([("chain", 2), ("x", 2), ("y", 2)])
    return jcfg, jmesh, jshard_field_state(jfield.init_field_state(jcfg), jmesh, jcfg)


def test_a_jax_sharded_checkpoint_resumes_in_the_port(tmp_path):
    """JAX save_sharded on the 8-device virtual CPU mesh (one file holding
    every shard) → the port's load_sharded takes the blocks its mesh needs,
    bit for bit, on a mesh of other boundaries along the chains too; then
    run_field resumes from it and equals the port's run from the same bits."""
    cfg = _halo_cfg(frames=3)
    jcfg, _, jstate = _jax_split_state(cfg)
    path = str(tmp_path / "jck")
    jck.save_sharded(path, jstate, jcfg, frames_done=1)
    whole = {n: np.asarray(x) for n, x in zip(jstate._fields, jstate)}
    for mesh in (_mesh(), make_mesh([("chain", 4), ("x", 2), ("y", 1)], devices="cpu")):
        if mesh.axis_size("chain") == 4:
            with pytest.raises(ValueError, match="missing shard"):  # boundaries must align
                ckpt.load_sharded(path, mesh)
            continue
        shards, loaded_cfg = ckpt.load_sharded(path, mesh)
        assert loaded_cfg == cfg
        got = ckpt.state_to_numpy(mesh_mod.gather_field_state(shards, mesh, cfg))
        for name, want in whole.items():
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    res = runtime.run_field(cfg, mesh=_mesh(), checkpoint_in=path, resume_progress=True,
                            sink=metrics.MetricsSink())
    start = ckpt.state_from_numpy(whole, "cpu", "field")
    runner = make_halo_runner(actions.get_field(cfg.action), cfg, _mesh())
    want, _ = runner(shard_field_state(start, _mesh(), cfg), 2)
    for name, a, b in zip(res.state._fields, res.state,
                          mesh_mod.gather_field_state(want, _mesh(), cfg)):
        assert torch.equal(a, b), name


def test_a_port_sharded_checkpoint_loads_in_jax(tmp_path):
    cfg = _halo_cfg()
    mesh = _mesh()
    act = actions.get_field(cfg.action)
    shards, _ = make_halo_runner(act, cfg, mesh)(_start(cfg, mesh), 1)
    path = str(tmp_path / "pck")
    ckpt.save_sharded(path, shards, cfg, mesh, frames_done=1)
    assert jck.read_meta_any(path)["frames_done"] == 1
    jcfg, jmesh, jstate = _jax_split_state(cfg)
    restored, loaded = jck.load_sharded(path, jmesh)
    assert loaded == jcfg
    want = ckpt.state_to_numpy(mesh_mod.gather_field_state(shards, mesh, cfg))
    for name, leaf in zip(restored._fields, restored):
        np.testing.assert_array_equal(np.asarray(leaf), want[name], err_msg=name)
        if leaf.ndim:  # placed as the JAX runner places them
            assert leaf.sharding.spec == getattr(jstate, name).sharding.spec, name


def test_the_files_keys_and_meta_are_the_jax_packages(tmp_path):
    """The same state saved by both packages: the same file name, the same
    keys with the same arrays, the same meta record."""
    cfg = _halo_cfg()
    jcfg, _, jstate = _jax_split_state(cfg)
    jpath, ppath = str(tmp_path / "j"), str(tmp_path / "p")
    jout = jck.save_sharded(jpath, jstate, jcfg, frames_done=3)
    whole = ckpt.state_from_numpy({n: np.asarray(x) for n, x in zip(jstate._fields, jstate)},
                                  "cpu", "field")
    pout = ckpt.save_sharded(ppath, shard_field_state(whole, _mesh(), cfg), cfg, _mesh(),
                             frames_done=3)
    assert jout[len(jpath):] == pout[len(ppath):] == ".proc0-of-1.npz"
    with np.load(jout) as j, np.load(pout) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            if k != "meta":
                assert j[k].dtype == p[k].dtype, k
                np.testing.assert_array_equal(j[k], p[k], err_msg=k)
    assert jck.read_meta(jout) == ckpt.read_meta(pout)


def test_chain_and_gauge_states_shard_and_restore(tmp_path):
    from stochquant_tpu_torch.integrators import gauge as gauge_mod

    cfg = ChainConfig(action="double_well", n_sites=16, n_chains=8, loops=4, seed=3,
                      mesh_chain_axis="chain")
    mesh = make_mesh([("chain", 4)], devices="cpu")
    whole = langevin.init_chain_state(cfg, actions.get(cfg.action), device="cpu")
    ckpt.save_sharded(str(tmp_path / "c"), mesh_mod.shard_chain_state(whole, mesh), cfg, mesh)
    back, loaded = ckpt.load_sharded(str(tmp_path / "c"), mesh)
    assert loaded == cfg and back[1].f.shape == (2, 16)
    for name, a, b in zip(whole._fields, whole, mesh_mod.gather_chain_state(back, mesh)):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="missing shard"):  # coarser blocks: not saved
        ckpt.load_sharded(str(tmp_path / "c"), make_mesh([("chain", 2)], devices="cpu"))
    # the split is read from the config: one that does not name the chain axis raises
    with pytest.raises(ValueError, match="mesh_chain_axis"):
        ckpt.save_sharded(str(tmp_path / "x"), mesh_mod.shard_chain_state(whole, mesh),
                          dataclasses.replace(cfg, mesh_chain_axis=None), mesh)

    gcfg = gauge_mod.GaugeConfig(group="su2", beta=2.0, shape=(8, 4), n_chains=2, loops=2,
                                 hot_start=True, mesh_axes=("x", None), mesh_chain_axis="chain")
    act = gauge_mod.resolve_gauge_action(gcfg)
    gmesh = make_mesh([("chain", 2), ("x", 2)], devices="cpu")
    links = gauge_mod.init_gauge_state(gcfg, act, device="cpu")
    ckpt.save_sharded(str(tmp_path / "g"), mesh_mod.shard_gauge_state(links, act, gmesh, gcfg),
                      gcfg, gmesh, frames_done=0)
    back, loaded = ckpt.load_sharded(str(tmp_path / "g"), gmesh)
    assert loaded == gcfg
    for name, a, b in zip(links._fields, links,
                          mesh_mod.gather_gauge_state(back, act, gmesh, gcfg)):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="no sharded layout"):
        mesh_mod.state_spec(tuple, cfg)
