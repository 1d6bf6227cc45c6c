"""A lattice run across processes stops and resumes, and what such a mesh
refuses: gloo processes on the CPU (``tests/torch_process_worker.py``, no
JAX in them).

Two processes run ``runtime.run_field`` / ``run_gauge`` for two frames and
write their ``save_sharded`` files; two new processes resume from them for a
third frame.  Tolerances: none.  The resumed shards are the uninterrupted
one-process three-frame run's bit for bit, and the same files loaded in one
process are its two-frame state."""

import dataclasses

import pytest
import torch

import torch_process_worker as worker
from stochquant_tpu_torch.config import ChainConfig, FieldConfig
from stochquant_tpu_torch.integrators.gauge import GaugeConfig
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.parallel import make_mesh
from stochquant_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

RUNS = {
    # two shards a process; the run's own checkpoints on the torch backend
    "field": ("field", [("x", 4)], FieldConfig(action="phi4", shape=(16, 16), dtau=0.01,
                                               n_chains=2, loops=6, seed=5, frames=3,
                                               mesh_axes=("x", None))),
    "gauge": ("gauge", [("x", 2)], GaugeConfig(group="u1", beta=1.0, shape=(8, 8), n_chains=2,
                                               dtau=5e-3, loops=4, seed=3, hot_start=True,
                                               frames=3, mesh_axes=("x", None))),
}


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    first, second = [], []
    for name, (kind, mesh, cfg) in RUNS.items():
        two_frames = dataclasses.replace(cfg, frames=2)
        first.append({"name": name, "kind": kind, "mesh": mesh, "cfg": two_frames.to_json(),
                      "checkpoint_out": str(tmp / f"{name}_ck")})
        second.append({"name": name, "kind": kind, "mesh": mesh, "cfg": cfg.to_json(),
                       "checkpoint_in": str(tmp / f"{name}_ck")})
    worker.spawn(first, 2, tmp / "first")
    return tmp, worker.spawn(second, 2, tmp / "second")


@pytest.mark.parametrize("name", list(RUNS))
def test_new_processes_resume_bitwise_from_the_sharded_files(resumed, name):
    tmp, out = resumed
    kind, mesh_shape, cfg = RUNS[name]
    assert sorted(p.name for p in tmp.glob(f"{name}_ck.proc*")) == [
        f"{name}_ck.proc0-of-2.npz", f"{name}_ck.proc1-of-2.npz"]
    mesh = make_mesh(mesh_shape, devices="cpu")
    want = worker.run({"name": name, "kind": kind, "cfg": cfg.to_json()}, mesh)
    got = worker.joined_shards(out[name])
    for g, w in zip(got, want["shards"]):
        for leaf in w:
            assert torch.equal(g[leaf], w[leaf]), leaf
    # the resumed processes' one record is the uninterrupted run's third
    frames = [r for r in want["records"] if r.get("type") == "frame"]
    for r in out[name]:
        got_frames = [x for x in r["records"] if x.get("type") == "frame"]
        assert worker.same_records(got_frames, frames[2:])


@pytest.mark.parametrize("name", list(RUNS))
def test_the_sharded_files_load_whole_in_one_process(resumed, name):
    tmp, _ = resumed
    kind, mesh_shape, cfg = RUNS[name]
    mesh = make_mesh(mesh_shape, devices="cpu")
    shards, loaded = checkpoint.load_sharded(str(tmp / f"{name}_ck"), mesh)
    assert loaded == dataclasses.replace(cfg, frames=2)
    two = worker.run({"name": name, "kind": kind, "cfg": loaded.to_json()}, mesh)
    for s, w in zip(shards, two["shards"]):
        for leaf in w:
            assert torch.equal(getattr(s, leaf), w[leaf]), leaf


@pytest.fixture(scope="module")
def refused(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refusals")
    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=2, frames=1,
                      mesh_axes=("x", None))
    chain = ChainConfig(action="double_well", n_sites=16, n_chains=4, loops=2, frames=1,
                        mesh_chain_axis="chain")
    job = {"name": "refusals", "kind": "refusals", "mesh": [("x", 2)], "cfg": cfg.to_json(),
           "chain_cfg": chain.to_json(), "path": str(tmp / "whole.npz")}
    return worker.spawn([job], 2, tmp)["refusals"]


@pytest.mark.parametrize("what,match", [
    ("save", "save_sharded"),              # a whole-state checkpoint across processes
    ("gather_state", "save_sharded"),      # the lattice is never gathered across processes
    ("run_chain", "run in one process"),   # no cross-process run_chain, as in the JAX package
])
def test_a_mesh_across_processes_refuses(refused, what, match):
    for r in refused:
        assert match in r[what], r


def test_a_whole_state_save_of_shards_raises_in_one_process_too():
    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, mesh_axes=("x", None))
    from stochquant_tpu_torch.integrators import field

    shards = mesh_mod.shard_field_state(field.init_field_state(
        dataclasses.replace(cfg, mesh_axes=None), device="cpu"), make_mesh([("x", 2)], "cpu"), cfg)
    with pytest.raises(ValueError, match="save_sharded"):
        checkpoint.save("unused.npz", shards, cfg)
