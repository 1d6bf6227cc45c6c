"""Several processes (``parallel.distributed``) on the CPU: two gloo
processes each run their half of the chains with its global chain offset,
write their ``save_sharded`` file, and two new processes load and continue —
the configs of ``tests/test_multiprocess.py``, whose JAX twins are marked
slow; these take seconds, the workers importing no JAX.

Tolerances: none.  The processes' states, concatenated in rank order, are
the single-process run's bit for bit (noise keyed by global chain), and the
stable fraction summed over the processes by gloo is the single-process
one."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import ChainConfig
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.parallel import distributed

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# tests/test_multiprocess.py's config, with two frames a launch (kernel 2's loop)
CFG = ChainConfig(action="double_well", n_sites=16, dt=0.1, dtau=5e-4, n_chains=8, loops=10,
                  seed=77, frames_per_launch=2)
SPLIT = dataclasses.replace(CFG, mesh_chain_axis="chain")
LEAVES = ("f", "omega", "x_mean", "xx0_mean", "x2_mean", "x4_mean", "runs", "dtau", "stab_cnt",
          "lrg_vl")

_WORKER = r"""
import dataclasses
import sys
import torch
torch.set_num_threads(1)
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import ChainConfig
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import chain_kernel
from stochquant_tpu_torch.parallel import distributed, mesh as mesh_mod

rank, store, outdir, phase = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
distributed.initialize(f"file://{store}", world_size=2, rank=rank, timeout_s=30)
cfg = ChainConfig.from_json(sys.argv[5])
act = actions.get(cfg.action)
per, off = distributed.process_local_chains(cfg.n_chains)
mesh = distributed.global_mesh([("chain", 4)], devices="cpu")   # two shards a process
c_local, offsets = mesh_mod.chain_split(cfg.n_chains, mesh, "chain")
assert offsets == [off, off + c_local], (offsets, off)
local = dataclasses.replace(cfg, n_chains=c_local, mesh_chain_axis=None)
ckpath = f"{outdir}/shard_ck"
if phase == "first":
    whole = langevin.init_chain_state(cfg, act, device="cpu")  # every process the same
    shards = mesh_mod.shard_chain_state(whole, mesh)
    n = 2
else:
    shards, loaded = checkpoint.load_sharded(ckpath, mesh)
    assert loaded == cfg
    n = 1
out = [chain_kernel.run_frames_kernel(s, act, local, n, frames_per_launch=cfg.frames_per_launch,
                                      chain_offset=o) for s, o in zip(shards, offsets)]
shards = [o[0] for o in out]
stable = sum(float(o[1]["stable"][-1].sum()) for o in out)
total, chains = distributed.all_sum([stable, per])
if phase == "first":
    checkpoint.save_sharded(ckpath, shards, cfg, mesh, frames_done=2)
torch.distributed.barrier()
torch.save({name: torch.cat([getattr(s, name) for s in shards]) for name in shards[0]._fields
            if name != "step"} | {"step": shards[0].step}, f"{outdir}/{phase}{rank}.pt")
assert "jax" not in sys.modules
print("WORKER_OK", rank, phase, total / chains, flush=True)
"""


def _run_phase(tmp_path, phase):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    store = tmp_path / f"store_{phase}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(store), str(tmp_path),
                               phase, SPLIT.to_json()], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=50)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{phase} rank {r} failed:\n{o[-3000:]}"
        assert f"WORKER_OK {r} {phase}" in o
    return [float(o.split(f"WORKER_OK {r} {phase} ")[1].split()[0]) for r, o in enumerate(outs)]


def _single_process(n_frames):
    act = actions.get(CFG.action)
    return langevin.run_frames(langevin.init_chain_state(CFG, act, device="cpu"), act, CFG,
                               n_frames)


def _joined(tmp_path, phase):
    parts = [torch.load(tmp_path / f"{phase}{r}.pt") for r in range(2)]
    return {name: torch.cat([p[name] for p in parts]) for name in LEAVES}, parts


def test_two_processes_run_their_chains_and_resume_from_their_sharded_files(tmp_path):
    """First phase: 2 frames a process, each writes its own shard file; the
    second phase's new processes load them and run 1 frame more."""
    fracs = _run_phase(tmp_path, "first")
    assert (tmp_path / "shard_ck.proc0-of-2.npz").exists()
    assert (tmp_path / "shard_ck.proc1-of-2.npz").exists()
    meta = checkpoint.read_meta_any(str(tmp_path / "shard_ck"))
    assert meta["process_count"] == 2 and meta["frames_done"] == 2
    ref, rm = _single_process(2)
    got, _ = _joined(tmp_path, "first")
    for name in LEAVES:
        assert torch.equal(got[name], getattr(ref, name)), name
    assert fracs == [float(rm["stable"][-1].float().mean())] * 2

    _run_phase(tmp_path, "resume")
    ref, _ = _single_process(3)
    got, parts = _joined(tmp_path, "resume")
    for name in LEAVES:
        assert torch.equal(got[name], getattr(ref, name)), name
    assert all(int(p["step"]) == int(ref.step) for p in parts)
    # the files also restore whole in one process, onto a mesh of the same boundaries
    from stochquant_tpu_torch.parallel import make_mesh, mesh as mesh_mod

    mesh = make_mesh([("chain", 4)], devices="cpu")
    shards, _ = checkpoint.load_sharded(str(tmp_path / "shard_ck"), mesh)
    two, _ = _single_process(2)
    whole = mesh_mod.gather_chain_state(shards, mesh)
    for name in LEAVES:
        assert torch.equal(getattr(whole, name), getattr(two, name)), name


def test_one_process_and_the_split_of_the_chains(monkeypatch):
    distributed.initialize()  # nothing configured: a no-op
    assert not torch.distributed.is_initialized()
    assert distributed.process_local_chains(8) == (8, 0)
    assert distributed.all_sum([1.5, 2]) == [1.5, 2.0]
    monkeypatch.setattr(distributed, "rank_and_size", lambda: (1, 2))
    assert distributed.process_local_chains(8) == (4, 4)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.process_local_chains(7)
    mesh = distributed.global_mesh([("chain", 4), ("x", 2)], devices="cpu")
    assert (mesh.shape, mesh.size, mesh.process_index, mesh.process_count) == ((4, 2), 4, 1, 2)
    assert [mesh.coords(i) for i in range(mesh.size)] == [(2, 0), (2, 1), (3, 0), (3, 1)]
    with pytest.raises(ValueError, match="must divide"):
        distributed.global_mesh([("chain", 3)], devices="cpu")
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    with pytest.raises(ValueError, match="every shard in this process"):
        mesh_mod.gather_chain_state([None] * 4, mesh)


@pytest.mark.parametrize("runner", ["chain"])
def test_runners_refuse_a_mesh_across_processes(monkeypatch, runner):
    """A chain run holds every shard of its mesh in one process: a mesh across
    processes (here rank 1 of 2) is refused by name before any shard runs.
    (Field and gauge runs cross processes: tests/test_torch_process_*.py.)"""
    from stochquant_tpu_torch import metrics, runtime

    monkeypatch.setattr(distributed, "rank_and_size", lambda: (1, 2))
    mesh = distributed.global_mesh([("chain", 4)], devices="cpu")
    assert mesh.process_count == 2
    with pytest.raises(ValueError, match="run in one process"):
        runtime.run_chain(SPLIT, mesh=mesh, sink=metrics.MetricsSink())
