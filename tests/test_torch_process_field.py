"""A scalar-field lattice split across processes: gloo processes on the CPU
(``tests/torch_process_worker.py``, no JAX in them) each run the halo runner
or ``runtime.run_field`` on their shards of ``distributed.global_mesh``.
Every backend runs (``torch``, and the kernel backends through their plain
versions: ``cuda`` = kernel 7, ``cuda_step`` = kernel 9, ``cuda_rdma`` =
kernel 8, a chain-only mesh on kernel 3), on 2-D lattices over two
processes (one and two shards a process, a chain axis across them) and a
4-D ring of 4 over four processes.

Tolerances: none against the port itself.  Joined in rank order, the
processes' shards (φ, every running mean, Δτ, ``lrg_vl``, the decisions),
metrics and records are the one-process run's on the same mesh shape bit
for bit.  Against the JAX package's ``xla`` halo runner on its CPU mesh,
``tests/test_torch_halo.py``'s bars (φ, Δτ, ``lrg_vl`` 2e-6, decisions
exact, means rtol 1e-5, the correlator rtol 1e-4)."""

import numpy as np
import pytest
import torch

import torch_process_worker as worker
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.parallel import make_mesh
from stochquant_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)


def _cfg(shape=(16, 16), **kw):
    base = dict(action="phi4", shape=shape, dtau=0.01, n_chains=2, loops=8, seed=77,
                mesh_axes=("x",) + (None,) * (len(shape) - 1), frames=2)
    base.update(kw)
    return FieldConfig(**base)


X2, X4, CX = [("x", 2)], [("x", 4)], [("chain", 2), ("x", 2)]
# name -> (kind, mesh, backend, cfg)
CASES_2 = {
    "torch_x2": ("halo", X2, "torch", _cfg(loops=5)),                 # odd: a tail step
    "torch_x4": ("halo", X4, "torch", _cfg(loops=5)),                 # two shards a process
    "cuda_x2": ("halo", X2, "cuda", _cfg(exchange_steps=4)),          # kernel 7
    "cuda_x4_multihop": ("halo", X4, "cuda", _cfg(exchange_steps=8)),  # H = 8 over 4-row slabs
    "cuda_pair_ring_of_one": ("halo", [("chain", 2), ("x", 1)], "cuda_pair", _cfg(
        exchange_steps=4, n_chains=4, mesh_chain_axis="chain")),       # kernel 7 on x = 1
    "cuda_step_x2": ("halo", X2, "cuda_step", _cfg(loops=5)),         # kernel 9
    "cuda_step_x2_cb": ("halo", X2, "cuda_step", _cfg(loops=4, sweep=Sweep.CHECKERBOARD)),
    "cuda_rdma_x2": ("halo", X2, "cuda_rdma", _cfg(exchange_steps=4)),  # kernel 8
    "cuda_rdma_x4": ("halo", X4, "cuda_rdma", _cfg(loops=10, exchange_steps=4)),  # + a W = 2 tail
    "cuda_rdma_chain_cb": ("halo", CX, "cuda_rdma", _cfg(
        loops=6, sweep=Sweep.CHECKERBOARD, exchange_steps=2, n_chains=4, mesh_chain_axis="chain")),
    "cuda_frame_chain": ("halo", [("chain", 2)], "cuda", _cfg(
        loops=4, n_chains=4, mesh_axes=(None, None), mesh_chain_axis="chain")),  # kernel 3
    "run_field_x2": ("field", X2, "auto", _cfg(loops=6, frames=3)),
    "run_field_chain_x2": ("field", CX, "torch", _cfg(
        loops=4, n_chains=4, mesh_chain_axis="chain", frames=2)),
}
# the 4-D ring of 4 over four processes (W = 2 for D >= 3)
CASES_4 = {
    "4d_cuda_rdma_x4": ("halo", X4, "cuda_rdma", _cfg((16, 4, 4, 4), loops=4)),
    "4d_cuda_x4": ("halo", X4, "cuda", _cfg((16, 4, 4, 4), loops=4)),
}


def _jobs(cases):
    return [{"name": n, "kind": k, "mesh": m, "backend": b, "cfg": c.to_json(),
             "frames": c.frames} for n, (k, m, b, c) in cases.items()]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return worker.spawn(_jobs(CASES_2), 2, tmp_path_factory.mktemp("field2"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return worker.spawn(_jobs(CASES_4), 4, tmp_path_factory.mktemp("field4"), timeout=180)


def _one_process(job):
    mesh = make_mesh(job["mesh"], devices=job.get("device", "cpu"))
    if job["kind"] == "field":
        return worker.run(job, mesh)
    return worker.runner(job, mesh)


def _check(job, ranks):
    want = _one_process(job)
    got = worker.joined_shards(ranks)
    assert len(got) == len(want["shards"])
    for g, w in zip(got, want["shards"]):
        for name in w:
            assert torch.equal(g[name], w[name]), name
    for r in ranks:
        if "metrics" in want:
            for key, m in want["metrics"].items():
                assert torch.equal(r["metrics"][key], m), key
        else:
            assert worker.same_records(r["records"], want["records"])


@pytest.mark.parametrize("name", list(CASES_2))
def test_two_processes_run_the_one_process_run(two, name):
    _check(_jobs({name: CASES_2[name]})[0], two[name])


@pytest.mark.parametrize("name", list(CASES_4))
def test_a_4d_ring_of_four_processes_runs_the_one_process_run(four, name):
    _check(_jobs({name: CASES_4[name]})[0], four[name])


def test_two_processes_agree_with_the_jax_xla_halo_runner(two):
    """The ``torch`` backend's run over two processes beside the JAX package's
    ``xla`` halo runner on its 2-device CPU mesh, both from the seed's state.
    (JAX is imported here: the card's machine, which runs this file's ``cuda``
    test, has none.)"""
    from stochquant_tpu.actions import phi4 as jphi4
    from stochquant_tpu.config import FieldConfig as JFieldConfig
    from stochquant_tpu.integrators import field as jfield
    from stochquant_tpu.parallel import make_mesh as jmake_mesh
    from stochquant_tpu.parallel import shard_field_state as jshard_field_state
    from stochquant_tpu.parallel.halo import make_halo_runner as jmake_halo_runner

    cfg = CASES_2["torch_x2"][3]
    jcfg = JFieldConfig.from_json(cfg.to_json())
    jmesh = jmake_mesh(X2)
    want, wm = jmake_halo_runner(jphi4.get_field(cfg.action), jcfg, jmesh, backend="xla")(
        jshard_field_state(jfield.init_field_state(jcfg), jmesh, jcfg), cfg.frames)
    mesh = make_mesh(X2, devices="cpu")
    spec = mesh_mod.field_state_spec(cfg)
    shards = [type(spec)(**s) for s in worker.joined_shards(two["torch_x2"])]
    got = mesh_mod.gather_state(shards, spec, mesh)
    for r in two["torch_x2"]:
        np.testing.assert_array_equal(r["metrics"]["stable"].numpy(), np.asarray(wm["stable"]))
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        elif name.endswith("_mean") and name != "corr_mean":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=name)
        elif name == "corr_mean":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6, err_msg=name)


def test_the_cases_cover_every_backend():
    backends = {b for _, _, b, _ in list(CASES_2.values()) + list(CASES_4.values())}
    assert {"torch", "cuda", "cuda_step", "cuda_rdma"} <= backends


# on the card: several processes share cuda:0; a neighbour's slab (kernel 8)
# and every collective go through the IPC transport
CARD = {
    "card_rdma_x2": (X2, "cuda_rdma", _cfg((64, 128), n_chains=3, loops=10)),
    "card_rdma_x4": (X4, "cuda_rdma", _cfg((64, 128), n_chains=3, loops=10)),  # 2 a process
    "card_rdma_chain_cb": (CX, "cuda_rdma", _cfg(
        (64, 128), n_chains=4, loops=6, exchange_steps=2, sweep=Sweep.CHECKERBOARD,
        mesh_chain_axis="chain")),
    "card_cuda_x2": (X2, "cuda", _cfg((64, 128), n_chains=3, loops=10)),        # kernel 7
    "card_step_x2": (X2, "cuda_step", _cfg((64, 128), n_chains=3, loops=5)),    # kernel 9
    "card_frame_chain": ([("chain", 2)], "cuda", _cfg(
        (64, 128), n_chains=4, loops=4, mesh_axes=(None, None), mesh_chain_axis="chain")),
}


@pytest.mark.cuda
def test_processes_on_the_card_run_the_one_process_run(tmp_path):
    """Two processes on cuda:0 against the one-process run on the repeated
    device, bit for bit, with the kernels' launches in each process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the IPC transport maps device memory")
    jobs = [{"name": n, "kind": "halo", "mesh": m, "backend": b, "cfg": c.to_json(),
             "frames": c.frames, "device": "cuda:0"} for n, (m, b, c) in CARD.items()]
    out = worker.spawn(jobs, 2, tmp_path, timeout=600)
    for job in jobs:
        _check(job, out[job["name"]])
        want = _one_process(job)["launches"]
        for r in out[job["name"]]:  # each process launches its shards' share
            assert r["launches"] == {k: v // 2 for k, v in want.items()}, (job["name"], r)


def test_kernel_8_takes_a_mapped_slab_only_on_the_card():
    """A neighbour's slab in another process (``ipc.Remote``) and ``out=`` are
    the card's: with CPU tensors the wrapper runs the plain version, which
    takes neither; a mapped slab of another shape raises."""
    from stochquant_tpu_torch import actions
    from stochquant_tpu_torch.kernels import field_kernel_nd as nd
    from stochquant_tpu_torch.parallel import ipc

    cfg = _cfg((16, 16), exchange_steps=4)
    act = actions.get_field(cfg.action)
    phi, dtau = torch.zeros((2, 8, 16)), torch.full((2,), 0.01)
    remote = ipc.Remote(0, phi.shape, torch.float32, phi.device)
    with pytest.raises(ValueError, match="no mapped slab"):
        nd.field_chunk_rdma_nd(phi, remote, phi, dtau, act, cfg, 4, 1, (0, 0))
    with pytest.raises(ValueError, match="no mapped slab"):
        nd.field_chunk_rdma_nd(phi, phi, phi, dtau, act, cfg, 4, 1, (0, 0), out=phi.clone())
    wrong = ipc.Remote(0, torch.Size((2, 4, 16)), torch.float32, phi.device)
    with pytest.raises(ValueError, match="differs"):
        nd.field_chunk_rdma_nd(phi, phi, wrong, dtau, act, cfg, 4, 1, (0, 0))
    # the plain version with tensors is the one-process path
    out = nd.field_chunk_rdma_nd(phi, phi, phi, dtau, act, cfg, 4, 1, (0, 0))
    assert out[0].shape == phi.shape
