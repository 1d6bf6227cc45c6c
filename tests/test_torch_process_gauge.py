"""Gauge links split across processes: two gloo processes on the CPU
(``tests/torch_process_worker.py``, no JAX in them) each run the chunk
runner (kernel 12's plain version on CPU tensors), the per-step halo runner
or ``runtime.run_gauge`` on their shards of ``distributed.global_mesh``, for
u1 and su2, one and two shards a process and a chain axis across them, and
the shard-local loop observables (``measure_loops``: the Polyakov loop every
record, the Wilson table at the end) on both runners' links.

Tolerances: none.  Joined in rank order, the processes' links, running
means, Δτ and decisions, their metrics, records and loops are the
one-process run's on the same mesh shape bit for bit."""

import pytest
import torch

import torch_process_worker as worker
from stochquant_tpu_torch.integrators.gauge import GaugeConfig
from stochquant_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)


def _cfg(group="u1", **kw):
    base = dict(group=group, beta={"u1": 1.0, "su2": 2.0}[group], shape=(16, 16), n_chains=2,
                dtau={"u1": 5e-3, "su2": 2e-3}[group], loops=6, seed=11, hot_start=True,
                mesh_axes=("x", None), grow_after=10**9, frames=2)
    base.update(kw)
    return GaugeConfig(**base)


X2, X4, CX = [("x", 2)], [("x", 4)], [("chain", 2), ("x", 2)]
# name -> (kind, mesh, runner, cfg)
CASES = {
    "u1_chunk_x2": ("gauge_halo", X2, "chunk", _cfg()),
    "u1_chunk_x4": ("gauge_halo", X4, "chunk", _cfg(exchange_steps=4)),      # W = 4, a W = 2 tail
    "u1_chunk_chain": ("gauge_halo", CX, "chunk", _cfg(n_chains=4, mesh_chain_axis="chain")),
    "su2_chunk_x2": ("gauge_halo", X2, "chunk", _cfg("su2", loops=4)),
    "u1_step_x2": ("gauge_halo", X2, "step", _cfg(loops=5)),
    "u1_step_xy": ("gauge_halo", [("x", 2), ("y", 2)], "step", _cfg(
        loops=3, shape=(8, 8), mesh_axes=("x", "y"))),                      # two split dims
    "su2_step_x2": ("gauge_halo", X2, "step", _cfg("su2", loops=3, shape=(8, 8))),
    "run_gauge_x2": ("gauge", X2, None, _cfg(loops=4, frames=3)),           # auto: per-step
    # the loop observables, shard-local: run_gauge (per-step runner) and both runners' links
    "loops_u1_x2": ("gauge", X2, None, _cfg(loops=4, measure_loops=True)),
    "loops_u1_xy": ("gauge", [("x", 2), ("y", 2)], None, _cfg(
        loops=3, shape=(8, 8), mesh_axes=("x", "y"), measure_loops=True)),
    "loops_su2_x2": ("gauge", X2, None, _cfg("su2", loops=3, shape=(8, 8), measure_loops=True)),
    "loops_u1_chunk_x2": ("gauge_halo", X2, "chunk", _cfg(measure_loops=True)),
    "loops_su2_chunk_x2": ("gauge_halo", X2, "chunk", _cfg("su2", loops=4, measure_loops=True)),
    "loops_su2_step_x2": ("gauge_halo", X2, "step", _cfg(
        "su2", loops=3, shape=(8, 8), measure_loops=True)),
}


def _jobs(cases):
    return [{"name": n, "kind": k, "mesh": m, "runner": r, "cfg": c.to_json(), "frames": c.frames}
            for n, (k, m, r, c) in cases.items()]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return worker.spawn(_jobs(CASES), 2, tmp_path_factory.mktemp("gauge2"))


@pytest.mark.parametrize("name", list(CASES))
def test_two_processes_run_the_one_process_gauge_run(two, name):
    job = _jobs({name: CASES[name]})[0]
    mesh = make_mesh(job["mesh"], devices="cpu")
    want = worker.run(job, mesh) if job["kind"] == "gauge" else worker.runner(job, mesh)
    got = worker.joined_shards(two[name])
    assert len(got) == len(want["shards"])
    for g, w in zip(got, want["shards"]):
        for leaf in w:
            assert torch.equal(g[leaf], w[leaf]), leaf
    for r in two[name]:
        if "metrics" in want:
            for key, m in want["metrics"].items():
                assert torch.equal(r["metrics"][key], m), key
        else:
            assert worker.same_records(r["records"], want["records"])
        for key, loop in want.get("loops", {}).items():
            assert torch.equal(r["loops"][key], loop), key
    if CASES[name][3].measure_loops:
        assert "loops" in want or any(rec.get("type") == "wilson_loops"
                                      for rec in want["records"])


@pytest.mark.cuda
def test_processes_on_the_card_measure_loops_bitwise(tmp_path):
    """``run_gauge(measure_loops=True)`` on the chunk runner (kernel 12) over
    two processes on cuda:0: shards and records (the Polyakov loop a frame,
    the Wilson table) bitwise the one-process run on the repeated device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the IPC transport maps device memory")
    cases = {"card_u1_loops": _cfg(shape=(32, 64), loops=4, measure_loops=True),
             "card_su2_loops": _cfg("su2", shape=(32, 64), loops=4, measure_loops=True)}
    jobs = [{"name": n, "kind": "gauge", "mesh": X2, "backend": "cuda", "cfg": c.to_json(),
             "frames": c.frames, "device": "cuda:0"} for n, c in cases.items()]
    out = worker.spawn(jobs, 2, tmp_path, timeout=600)
    for job in jobs:
        want = worker.run(job, make_mesh(job["mesh"], devices="cuda:0"))
        assert any(r.get("type") == "wilson_loops" for r in want["records"])
        for g, w in zip(worker.joined_shards(out[job["name"]]), want["shards"]):
            for leaf in w:
                assert torch.equal(g[leaf], w[leaf]), leaf
        for r in out[job["name"]]:
            assert worker.same_records(r["records"], want["records"])
