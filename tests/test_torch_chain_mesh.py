"""Chains split over a mesh: ``runtime.run_chain(mesh=)`` and the chain
kernels' frame loop with a global ``chain_offset``, on the CPU (the kernel
wrappers run their plain versions on CPU tensors).

Tolerances: the split run against the unsplit one, bit for bit (every state
leaf, every metric, every record but its wall times): the noise is keyed by
global chain, and a record reads the gathered per-chain values in mesh
order.  Against the JAX package's ``langevin.run_frames`` on a
``shard_chain_state``-split state over the 8-device virtual CPU mesh
(``tests/test_parallel.py:20-45``'s config): decisions, ``runs``,
``stab_cnt`` and ``step`` exactly, floats within 2e-6 (the port's bar: the
CPU transcendentals of the two libraries differ by about an ulp)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jact
from stochquant_tpu.config import ChainConfig as JChainConfig
from stochquant_tpu.integrators import langevin as jl
from stochquant_tpu.io import checkpoint as jck
from stochquant_tpu.parallel import make_mesh as jmake_mesh
from stochquant_tpu.parallel import shard_chain_state as jshard_chain_state
from stochquant_tpu_torch import actions, metrics, runtime
from stochquant_tpu_torch.config import ChainConfig
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import chain_kernel as ck
from stochquant_tpu_torch.metrics import _np_default
from stochquant_tpu_torch.parallel import make_mesh, mesh as mesh_mod

torch.set_num_threads(1)

# tests/test_parallel.py:20-45
CFG = ChainConfig(action="double_well", n_sites=32, dt=0.05, dtau=0.001, n_chains=16, loops=25,
                  seed=31, frames=4)
SPLIT = dataclasses.replace(CFG, mesh_chain_axis="chain")
EXACT = ("runs", "stab_cnt", "step", "stable")
TIMING = ("wall_time", "mlups", "avg_mlups", "elapsed_s")


def _records(recs):
    return [json.loads(json.dumps({k: v for k, v in r.items() if k not in TIMING},
                                  default=_np_default)) for r in recs]


def _mesh(n=4):
    return make_mesh([("chain", n)], devices="cpu")


def _same_state(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.fixture
def kernel_route(monkeypatch):
    """run_chain on the kernel route ('cuda'), here on CPU tensors: the chain
    kernels' wrappers then run their plain versions (kernels 1 and 2's)."""
    monkeypatch.setattr(runtime, "select_backend", lambda backend, device, cfg: ("cuda", None))


@pytest.mark.parametrize("route", ["torch", "kernels"])
@pytest.mark.parametrize("fpl,rng,fps", [(1, "threefry", 1), (2, "threefry", 2),
                                         (2, "hardware", 1), (3, "threefry13", 3)])
def test_run_chain_on_a_4_shard_mesh_is_bitwise_the_unsplit_run(route, fpl, rng, fps,
                                                                 monkeypatch, tmp_path):
    if route == "kernels":
        monkeypatch.setattr(runtime, "select_backend", lambda b, d, c: ("cuda", None))
    cfg = dataclasses.replace(CFG, frames_per_launch=fpl, rng_impl=rng, fps=fps)
    ra, rb = [], []
    a = runtime.run_chain(cfg, device="cpu", burn_frames=1, checkpoint_out=str(tmp_path / "a"),
                          sink=metrics.MetricsSink(callback=ra.append))
    b = runtime.run_chain(dataclasses.replace(cfg, mesh_chain_axis="chain"), mesh=_mesh(),
                          burn_frames=1, checkpoint_out=str(tmp_path / "b"),
                          sink=metrics.MetricsSink(callback=rb.append))
    _same_state(a.state, b.state)
    assert _records(ra) == _records(rb)
    assert [r["type"] for r in rb].count("frame") == -(-cfg.frames // fps)
    wa, _ = checkpoint.load(tmp_path / "a", "cpu")
    wb, _ = checkpoint.load(tmp_path / "b", "cpu")  # one process: the whole-state file
    _same_state(wa, wb)
    assert not checkpoint.is_sharded_checkpoint(tmp_path / "b")


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("rng", ["threefry", "hardware"])
def test_kernel_frame_loop_per_shard_with_its_chain_offset(K, rng):
    """run_frames_kernel on each shard with its global chain offset: every leaf
    and metric bitwise the unsplit call's (kernel 1 + epilogue at K = 1,
    kernel 2 at K = 2; Philox keyed by global chain too)."""
    cfg = dataclasses.replace(CFG, rng_impl=rng)
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act, device="cpu")
    want, wm = ck.run_frames_kernel(s0, act, cfg, 2, frames_per_launch=K)
    mesh = _mesh()
    c_local, offsets = mesh_mod.chain_split(cfg.n_chains, mesh, "chain")
    local = dataclasses.replace(cfg, n_chains=c_local)
    out = [ck.run_frames_kernel(s, act, local, 2, frames_per_launch=K, chain_offset=off)
           for s, off in zip(mesh_mod.shard_chain_state(s0, mesh), offsets)]
    _same_state(want, mesh_mod.gather_chain_state([o[0] for o in out], mesh))
    got = mesh_mod.gather_metrics([o[1] for o in out], mesh, "chain")
    for key in wm:
        assert torch.equal(got[key], wm[key]), key
    # a shard run at offset 0 draws another chain's stream
    wrong, _ = ck.run_frames_kernel(mesh_mod.shard_chain_state(s0, mesh)[1], act, local, 2,
                                    frames_per_launch=K)
    assert not torch.equal(wrong.f, out[1][0].f)


def test_run_chain_mesh_agrees_with_jax_on_the_virtual_device_mesh(tmp_path):
    """The JAX package's initial state, saved by it, run 4 frames by the
    port's run_chain over an 8-shard mesh and by the JAX integrator on the
    state shard_chain_state placed over the 8 virtual CPU devices."""
    jcfg = JChainConfig.from_json(SPLIT.to_json())
    ja = jact.get(CFG.action)
    s0 = jl.init_chain_state(jcfg, ja)
    jout, _ = jl.run_frames(jshard_chain_state(s0, jmake_mesh([("chain", 8)])), ja, jcfg, 4)
    jck.save(tmp_path / "start.npz", s0, jcfg)

    recs = []
    res = runtime.run_chain(SPLIT, mesh=make_mesh([("chain", 8)], devices="cpu"),
                            checkpoint_in=str(tmp_path / "start.npz"),
                            sink=metrics.MetricsSink(callback=recs.append))
    got = checkpoint.state_to_numpy(res.state)
    for name, leaf in zip(jout._fields, jout):
        want = np.asarray(leaf)
        if name in EXACT:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want, rtol=2e-6, atol=2e-6, err_msg=name)
    assert [r["stable_frac"] for r in recs if r["type"] == "frame"] == [1.0] * 4


@pytest.mark.parametrize("sharded", [True, False])
def test_run_chain_mesh_resumes_bitwise(sharded, kernel_route, tmp_path):
    """Half the frames, a checkpoint (sharded, or the whole-state file a
    one-process mesh writes), then a resume on another mesh of the same chain
    split: bitwise the uninterrupted run."""
    full = runtime.run_chain(SPLIT, mesh=_mesh(), sink=metrics.MetricsSink())
    half = runtime.run_chain(dataclasses.replace(SPLIT, frames=2), mesh=_mesh(),
                             sink=metrics.MetricsSink())
    ck_path = str(tmp_path / "ck")
    if sharded:
        checkpoint.save_sharded(ck_path, mesh_mod.shard_chain_state(half.state, _mesh(2)),
                                SPLIT, _mesh(2), frames_done=2)
    else:
        checkpoint.save(ck_path, half.state, SPLIT, frames_done=2)
    recs = []
    res = runtime.run_chain(SPLIT, mesh=_mesh(2), checkpoint_in=ck_path, resume_progress=True,
                            sink=metrics.MetricsSink(callback=recs.append))
    _same_state(full.state, res.state)
    assert [r["frame"] for r in recs if r["type"] == "frame"] == [2, 3]


def test_run_chain_mesh_refusals(tmp_path):
    shards = mesh_mod.shard_chain_state(
        langevin.init_chain_state(CFG, actions.get(CFG.action), device="cpu"), _mesh())
    checkpoint.save_sharded(str(tmp_path / "ck"), shards, SPLIT, _mesh())
    with pytest.raises(ValueError, match="sharded checkpoint"):  # it needs its mesh
        runtime.run_chain(CFG, device="cpu", checkpoint_in=str(tmp_path / "ck"),
                          sink=metrics.MetricsSink())
    with pytest.raises(ValueError, match="mesh_chain_axis"):
        runtime.run_chain(CFG, mesh=_mesh(), sink=metrics.MetricsSink())
    with pytest.raises(ValueError, match="no mesh"):
        runtime.run_chain(SPLIT, device="cpu", sink=metrics.MetricsSink())
    with pytest.raises(ValueError, match="not divisible"):
        runtime.run_chain(dataclasses.replace(SPLIT, n_chains=6), mesh=_mesh(),
                          sink=metrics.MetricsSink())
    across = dataclasses.replace(_mesh(2), shape=(4,), process_count=2)
    with pytest.raises(ValueError, match="one process"):
        runtime.run_chain(SPLIT, mesh=across, sink=metrics.MetricsSink())
    with pytest.raises(ValueError, match="mixes device types"):
        mixed = mesh_mod.DeviceMesh(("chain",), (2,), (torch.device("cpu"), torch.device("meta")))
        runtime.run_chain(SPLIT, mesh=mixed, sink=metrics.MetricsSink())


@pytest.mark.cuda
@pytest.mark.parametrize("K,rng", [(1, "threefry"), (2, "threefry"), (1, "hardware"),
                                   (2, "hardware")])
def test_run_chain_on_a_mesh_of_the_card_is_bitwise_the_unsplit_kernel_run(K, rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    cfg = dataclasses.replace(CFG, n_chains=256, frames=2, frames_per_launch=K, fps=K,
                              rng_impl=rng)
    for fn in (ck.chain_frame, ck.chain_frames_multi):
        fn.launches = 0
    a = runtime.run_chain(cfg, device="cuda", sink=metrics.MetricsSink())
    b = runtime.run_chain(dataclasses.replace(cfg, mesh_chain_axis="chain"),
                          mesh=make_mesh([("chain", 2)], devices="cuda:0"),
                          sink=metrics.MetricsSink())
    torch.cuda.synchronize()
    _same_state(a.state, b.state)
    launched = ck.chain_frames_multi.launches if K > 1 else ck.chain_frame.launches
    assert launched == 3 * cfg.frames // K
