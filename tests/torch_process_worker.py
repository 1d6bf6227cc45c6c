"""One process of a run split across processes, on the CPU (gloo): the worker
of tests/test_torch_process_*.py.  It imports no JAX.

    python tests/torch_process_worker.py RANK WORLD STORE JOBS OUTDIR

Joins the process group through the file store STORE, then runs each job of
the JSON file JOBS on ``distributed.global_mesh(job["mesh"], devices="cpu")``
and writes ``OUTDIR/<job name>.rank<RANK>.pt``:

* ``kind`` "field" / "gauge": ``runtime.run_field`` / ``run_gauge`` with the
  job's config, backend, frames and checkpoint paths; writes this process's
  per-shard states (leaf name -> tensor) and its records;
* ``kind`` "halo" / "gauge_halo": the field halo runner on ``backend`` (the
  kernels' plain versions on CPU tensors), or the gauge ``runner`` ("chunk"
  or "step"), built directly from the seed's state; writes the per-shard
  states and the metrics;

A job's ``device`` (default "cpu"; "cuda:0" on the card) holds every shard.
* ``kind`` "collectives": every collective of ``parallel.mesh`` on the
  tensors that ``collective_inputs`` makes for this process's positions;
  writes the outputs per collective; "cuda_collectives" the same on
  ``cuda:0`` through the IPC transport, with gloo's all-gathers made to
  raise (the card only); "cuda_timeout" rank 1 holds back its part of a
  ``ppermute`` until rank 0's wait has raised past its limit (the card only);
* ``kind`` "refusals": what a mesh across processes refuses, each message.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

from stochquant_tpu_torch import actions, metrics, runtime  # noqa: E402
from stochquant_tpu_torch.config import ChainConfig, FieldConfig  # noqa: E402
from stochquant_tpu_torch.integrators import field  # noqa: E402
from stochquant_tpu_torch.integrators import gauge  # noqa: E402
from stochquant_tpu_torch.integrators.gauge import GaugeConfig  # noqa: E402
from stochquant_tpu_torch.io import checkpoint  # noqa: E402
from stochquant_tpu_torch.kernels import field_halo_kernel, field_kernel  # noqa: E402
from stochquant_tpu_torch.kernels import field_kernel_nd, gauge_kernel  # noqa: E402
from stochquant_tpu_torch.parallel import distributed, gauge_halo, halo  # noqa: E402
from stochquant_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402


def collective_inputs(g: int) -> dict:
    """The inputs of global position ``g``: a float block (NaN at position 1,
    for pmax), a flag, from numpy's generator seeded by ``g``."""
    r = np.random.default_rng(100 + g)
    x = torch.from_numpy(r.standard_normal((3, 4)).astype(np.float32))
    if g == 1:
        x[1, 2] = float("nan")
    return {"x": x, "flag": torch.tensor([g % 3 == 2, False])}


def collectives(mesh, device="cpu") -> dict:
    """Every collective over every axis set of ``mesh`` on this process's
    shards, their inputs on ``device``; the outputs on the CPU."""
    ins = [collective_inputs(mesh.global_index(i)) for i in range(mesh.size)]
    xs, flags = [d["x"].to(device) for d in ins], [d["flag"].to(device) for d in ins]
    out = {}
    names = list(mesh.axis_names)
    axis_sets = [(n,) for n in names] + ([tuple(names)] if len(names) > 1 else [])
    for ax in names:
        for delta in (-1, +1, 2):
            out[f"ppermute {ax} {delta}"] = mesh_mod.ppermute(xs, mesh, ax, delta)
    for axes in axis_sets:
        out[f"psum {axes}"] = mesh_mod.psum(xs, mesh, axes)
        out[f"pmax {axes}"] = mesh_mod.pmax(xs, mesh, axes)
        out[f"pany {axes}"] = mesh_mod.pany(flags, mesh, axes)
        out[f"pcat {axes}"] = mesh_mod.pcat(xs, mesh, axes, dim=1)
    out["pfrom 0"] = mesh_mod.pfrom(xs, mesh, lambda g: 0)
    out["gather_metrics"] = [mesh_mod.gather_metrics(
        [{"m": x[:, :2]} for x in xs], mesh, names[0])["m"]]
    return {k: [t.cpu() for t in v] for k, v in out.items()}


def cuda_collectives(mesh) -> dict:
    """:func:`collectives` on the card through the transport; gloo's
    all-gathers raise, so nothing of it goes through gloo."""
    from stochquant_tpu_torch.parallel import ipc

    def refuse(*a, **k):
        raise AssertionError("a CUDA collective reached gloo")

    distributed.all_gather = torch.distributed.all_gather = refuse
    mesh = ipc.attach(mesh)
    out = collectives(mesh, "cuda:0")
    mesh.transport.close()
    return out


def cuda_timeout(mesh, flag: Path) -> dict:
    """After one ppermute together (it sets the board up, which both attend),
    rank 0 waits for rank 1's tensor of a second, which rank 1 publishes only
    once rank 0 has written ``flag``: rank 0's ``settle`` raises past its 3 s
    limit, naming process 1; then both finish the collective and close."""
    import time

    from stochquant_tpu_torch.parallel import ipc

    transport = ipc.Transport(mesh, timeout_s=3.0)
    mesh = dataclasses.replace(mesh, transport=transport)
    xs = [torch.full((4,), float(mesh.process_index), device="cuda:0")]
    mesh_mod.ppermute(xs, mesh, "x", 1)
    transport.settle()
    out = {}
    if mesh.process_index == 0:
        got = mesh_mod.ppermute(xs, mesh, "x", 1)
        try:
            transport.settle()
        except TimeoutError as e:
            out["message"] = str(e)
        flag.write_text("go")
    else:
        while not flag.exists():
            time.sleep(0.05)
        got = mesh_mod.ppermute(xs, mesh, "x", 1)
    transport.timeout_s = 60.0
    transport.settle()
    out["got"] = [t.cpu() for t in got]
    transport.close()
    return out


def refusals(job, mesh) -> dict:
    """The messages of what a mesh across processes refuses."""
    out = {}
    cfg = FieldConfig.from_json(job["cfg"])
    res = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink())
    try:
        checkpoint.save(job["path"], res.state, cfg)
    except ValueError as e:
        out["save"] = str(e)
    try:
        mesh_mod.gather_state(res.state, mesh_mod.state_spec(type(res.state[0]), cfg), mesh)
    except ValueError as e:
        out["gather_state"] = str(e)
    chain = ChainConfig.from_json(job["chain_cfg"])
    try:
        runtime.run_chain(chain, mesh=distributed.global_mesh([("chain", 2)], devices="cpu"),
                          sink=metrics.MetricsSink())
    except ValueError as e:
        out["run_chain"] = str(e)
    return out


def _leaves(states) -> list:
    return [dict(zip(s._fields, s)) for s in states]


def run(job, mesh) -> dict:
    """The runtime's run of ``job`` on ``mesh``: its per-shard states (in one
    process the whole state split again) and its records."""
    recs = []
    is_field = job["kind"] == "field"
    cfg = (FieldConfig if is_field else GaugeConfig).from_json(job["cfg"])
    res = (runtime.run_field if is_field else runtime.run_gauge)(
        cfg, mesh=mesh, backend=job.get("backend", "auto"), sink=metrics.MetricsSink(
            callback=recs.append), checkpoint_out=job.get("checkpoint_out"),
        checkpoint_in=job.get("checkpoint_in"), resume_progress=bool(job.get("checkpoint_in")))
    states = res.state
    if not isinstance(states, list):
        states = mesh_mod.shard_state(states, mesh_mod.state_spec(type(states), cfg), mesh)
    return {"shards": _leaves(states), "records": recs}


#: the launch counters of the kernels a split run reaches
KERNELS = {"field_frame": field_kernel.field_frame, "field_pair_nd": field_kernel_nd.field_pair_nd,
           "field_chunk_nd": field_kernel_nd.field_chunk_nd,
           "field_chunk_rdma_nd": field_kernel_nd.field_chunk_rdma_nd,
           "field_halo_step": field_halo_kernel.field_halo_step,
           "gauge_chunk": gauge_kernel.gauge_chunk}


def runner(job, mesh) -> dict:
    """A halo runner built directly on the seed's state, ``job["frames"]``
    frames: its per-shard states, metrics and kernel launches."""
    device = mesh.devices[0]
    if job["kind"] == "halo":
        cfg = FieldConfig.from_json(job["cfg"])
        base = dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None)
        shards = mesh_mod.shard_field_state(field.init_field_state(base, device=device), mesh, cfg)
        run_ = halo.make_halo_runner(actions.get_field(cfg.action), cfg, mesh,
                                     backend=job["backend"])
    else:
        cfg = GaugeConfig.from_json(job["cfg"])
        act = gauge.resolve_gauge_action(cfg)
        base = dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None, exchange_steps=0)
        shards = mesh_mod.shard_gauge_state(gauge.init_gauge_state(base, act, device=device), act,
                                            mesh, cfg)
        make = (gauge_halo.make_gauge_chunk_runner if job["runner"] == "chunk"
                else gauge_halo.make_gauge_halo_runner)
        run_ = make(act, cfg, mesh)
    for fn in KERNELS.values():
        fn.launches = 0
    out, m = run_(shards, job["frames"])
    run_.close()
    return {"shards": [{k: v.cpu() for k, v in s.items()} for s in _leaves(out)],
            "metrics": {k: v.cpu() for k, v in m.items()},
            "launches": {k: fn.launches for k, fn in KERNELS.items() if fn.launches}}


def main() -> None:
    rank, world, store, jobs, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                        sys.argv[4], Path(sys.argv[5]))
    distributed.initialize(f"file://{store}", world_size=world, rank=rank, timeout_s=60)
    for job in json.loads(Path(jobs).read_text()):
        device = "cuda:0" if job["kind"].startswith("cuda_") else job.get("device", "cpu")
        mesh = distributed.global_mesh([tuple(a) for a in job["mesh"]], devices=device)
        if job["kind"] == "collectives":
            result = collectives(mesh)
        elif job["kind"] == "cuda_collectives":
            result = cuda_collectives(mesh)
        elif job["kind"] == "cuda_timeout":
            result = cuda_timeout(mesh, outdir / "go")
        elif job["kind"] == "refusals":
            result = refusals(job, mesh)
        elif job["kind"] in ("halo", "gauge_halo"):
            result = runner(job, mesh)
        else:
            result = run(job, mesh)
        torch.save(result, outdir / f"{job['name']}.rank{rank}.pt")
    distributed.barrier()
    assert "jax" not in sys.modules and "stochquant_tpu" not in sys.modules
    print("WORKER_OK", rank, flush=True)


# ---------------------------------------------------------------------------
# the test process's side
# ---------------------------------------------------------------------------

TIMING_KEYS = ("wall_time", "mlups", "avg_mlups", "elapsed_s")


def spawn(jobs: list, world: int, tmp: Path, timeout: float = 120.0) -> list:
    """Run ``jobs`` in ``world`` worker processes; each must exit 0.  Returns,
    per job name, every rank's output (a list in rank order)."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(tmp / "store"),
                               str(tmp / "jobs.json"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = [None] * world
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(timeout=timeout)[0].decode()
    except subprocess.TimeoutExpired:
        pass
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                outs[r] = p.communicate()[0].decode() + f"\n(killed after {timeout:g} s)"
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in o, "\n".join(
            f"rank {q} ({procs[q].returncode}):\n{outs[q][-3000:]}" for q in range(world))
    return {job["name"]: [torch.load(tmp / f"{job['name']}.rank{r}.pt", weights_only=False)
                          for r in range(world)] for job in jobs}


def joined_shards(outputs: list) -> list:
    """Every rank's per-shard states in rank order: the global positions in order."""
    return [s for out in outputs for s in out["shards"]]


def same_records(a: list, b: list) -> bool:
    """Two runs' records equal but for their wall times."""
    def norm(recs):
        return json.dumps([{k: v for k, v in r.items() if k not in TIMING_KEYS} for r in recs],
                          default=lambda o: np.asarray(o).tolist())
    return norm(a) == norm(b)


if __name__ == "__main__":
    main()
