"""The collectives of ``parallel.mesh`` on a mesh across processes: two gloo
processes on the CPU (``tests/torch_process_worker.py``, no JAX in them) run
``ppermute`` / ``psum`` / ``pmax`` (a NaN partial) / ``pany`` / ``pcat`` /
``pfrom`` and ``gather_metrics`` over every axis set of three meshes, one
and two shards a process.

Tolerances: none.  Joined in rank order, the processes' outputs are the
one-process list collectives' on the same mesh shape bit for bit (NaN where
they have NaN): every process reduces the gathered partials in ascending
global index, once, as one process does."""

import pytest
import torch

import torch_process_worker as worker
from stochquant_tpu_torch.parallel import distributed, ipc, make_mesh
from stochquant_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

MESHES = {
    "x2": [("x", 2)],                     # one shard a process
    "x4": [("x", 4)],                     # two a process: rings mix local and remote shards
    "chain2_x2": [("chain", 2), ("x", 2)],  # the chain axis spans the processes, x stays local
}
FAMILIES = ("ppermute", "psum", "pmax", "pany", "pcat", "pfrom", "gather_metrics")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    jobs = [{"name": n, "kind": "collectives", "mesh": m} for n, m in MESHES.items()]
    return worker.spawn(jobs, 2, tmp_path_factory.mktemp("collectives"))


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(MESHES))
def test_collectives_across_processes_are_the_one_process_ones(outputs, name, family):
    ranks = outputs[name]
    want = worker.collectives(make_mesh(MESHES[name], devices="cpu"))
    keys = [k for k in want if k.split()[0] == family]
    assert keys
    for key in keys:
        if family == "gather_metrics":  # every process gets the whole
            assert all(_bitwise(r[key][0], want[key][0]) for r in ranks), key
            continue
        got = [t for r in ranks for t in r[key]]
        assert len(got) == len(want[key])
        assert all(_bitwise(g, w) for g, w in zip(got, want[key])), key
    if family == "pmax":  # the NaN partial propagates to its group
        assert any(torch.isnan(t).any() for r in ranks for t in r[keys[0]])


def test_global_and_local_indices_of_a_mesh_across_processes(monkeypatch):
    """Rank 1 of 2 of a (2, 4) mesh holds global positions 4-7; neighbours,
    groups and owners are global."""
    monkeypatch.setattr(distributed, "rank_and_size", lambda: (1, 2))
    mesh = distributed.global_mesh([("chain", 2), ("x", 4)], devices="cpu")
    assert mesh.n_positions == 8 and mesh.size == 4
    assert [mesh.global_index(i) for i in range(4)] == [4, 5, 6, 7]
    assert [mesh.local(g) for g in (3, 4, 7, 8)] == [None, 0, 3, None]
    assert [mesh.owner(g) for g in (0, 3, 4, 7)] == [0, 0, 1, 1]
    assert mesh.neighbor(0, "x", -1) == 7 and mesh.neighbor(3, "x", +1) == 4
    assert mesh.neighbor(0, "chain", +1) == 0 and mesh.shift(1, "chain", 1) == 5
    assert mesh.groups(("chain",)) == ((0, 4), (1, 5), (2, 6), (3, 7))
    assert mesh.global_coords(6) == (1, 2) and mesh.coords(2) == (1, 2)


def test_a_cpu_collective_that_stays_in_its_process_calls_no_gloo(monkeypatch):
    """Groups that one process holds whole need nothing from the others: no
    gloo call (here: no process group at all)."""
    monkeypatch.setattr(distributed, "rank_and_size", lambda: (0, 2))
    mesh = distributed.global_mesh([("chain", 2), ("x", 2)], devices="cpu")
    xs = [torch.full((2,), float(i)) for i in range(2)]
    assert [t.tolist() for t in mesh_mod.psum(xs, mesh, ("x",))] == [[1.0, 1.0]] * 2
    assert [t.tolist() for t in mesh_mod.ppermute(xs, mesh, "x", 1)] == [[1.0] * 2, [0.0] * 2]
    with pytest.raises(ValueError, match="Default process group"):
        mesh_mod.psum(xs, mesh, ("chain",))  # this one reaches process 1


def test_a_cuda_tensor_never_goes_through_gloo(monkeypatch):
    """A cross-process collective over CUDA tensors without the runner's
    transport raises before anything moves (a meta tensor stands in for a
    CUDA one here); gloo's all_gather refuses CUDA tensors outright."""
    monkeypatch.setattr(distributed, "rank_and_size", lambda: (0, 2))
    mesh = distributed.global_mesh([("x", 2)], devices="cpu")
    xs = [torch.zeros(2, device="meta")]
    with pytest.raises(ValueError, match="never through gloo"):
        mesh_mod.ppermute(xs, mesh, "x", 1)
    with pytest.raises(ValueError, match="never goes through gloo|CPU tensors"):
        distributed.all_gather(torch.zeros(2, device="meta"))


def test_the_transport_takes_one_card_a_process():
    """Shards of one process on two cards are refused by name before any CUDA
    call: one process per card (processes may share one)."""
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    two_cards = mesh_mod.DeviceMesh(("x",), (4,), cards, 0, 2)
    with pytest.raises(ValueError, match="one process per card"):
        ipc.Transport(two_cards)
    cpu = mesh_mod.DeviceMesh(("x",), (4,), (torch.device("cpu"),) * 2, 0, 2)
    assert ipc.attach(cpu) is cpu  # CPU tensors cross through gloo: no transport


@pytest.mark.cuda
def test_a_wait_past_its_limit_raises_and_names_the_process(tmp_path):
    """Rank 1 holds back its part of a ppermute on the card: rank 0's wait
    raises past its 3 s limit, naming process 1 and the counter it waits on;
    once rank 1 goes on, both finish with each other's tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the IPC transport maps device memory")
    out = worker.spawn([{"name": "t", "kind": "cuda_timeout", "mesh": [("x", 2)]}], 2, tmp_path,
                       timeout=120)["t"]
    assert "process 1" in out[0]["message"] and "PUB" in out[0]["message"], out[0]
    assert [r["got"][0].tolist() for r in out] == [[1.0] * 4, [0.0] * 4]


@pytest.mark.cuda
def test_cuda_collectives_across_processes_on_the_card(tmp_path):
    """Two processes on the card: every collective over CUDA tensors goes
    through the IPC transport, gloo's all_gather patched to raise, and equals
    the one-process collectives on the card bit for bit (NaN payloads too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the IPC transport maps device memory")
    jobs = [{"name": n, "kind": "cuda_collectives", "mesh": m} for n, m in MESHES.items()]
    out = worker.spawn(jobs, 2, tmp_path, timeout=300)
    for name in MESHES:
        want = worker.collectives(make_mesh(MESHES[name], devices="cuda:0"), "cuda:0")
        for key, w in want.items():
            if key.startswith("gather_metrics"):
                assert all(_bitwise(r[key][0], w[0]) for r in out[name]), key
            else:
                got = [t for r in out[name] for t in r[key]]
                assert all(_bitwise(g, x) for g, x in zip(got, w)), (name, key)
