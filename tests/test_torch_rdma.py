"""The port's kernel 8 path (``backend='cuda_rdma'``, ``prefer_rdma``): the
chunk kernel that reads its dim-0 halo rows from the neighbour shards' slabs.
On the CPU ``field_chunk_rdma_nd`` runs its plain version, so a mesh of
repeated CPU devices runs the path that the card runs: it must equal the JAX
package's ``make_halo_runner(backend="pallas_rdma")`` in interpret mode on its
virtual CPU mesh (φ within 2e-6, decisions exact, means at
tests/test_torch_halo.py's bars), the unsplit plain integrator bit for bit,
and kernel 7's plain version on the extended block; the router takes it
where the JAX router takes ``pallas_rdma`` and records why where it does not."""

import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu import runtime as jruntime
from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu.parallel import make_mesh as jmake_mesh
from stochquant_tpu.parallel import shard_field_state as jshard_field_state
from stochquant_tpu.parallel.halo import make_halo_runner as jmake_halo_runner
from stochquant_tpu.parallel.halo import rdma_backend_available as jrdma_backend_available
from stochquant_tpu_torch import actions, metrics, runtime
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.kernels import field_kernel_nd as nd
from stochquant_tpu_torch.kernels.field_kernel_tiled import micro_steps
from stochquant_tpu_torch.parallel import (
    gather_field_state, make_mesh, shard_field_state, shard_state_from_numpy,
)
from stochquant_tpu_torch.parallel.halo import (
    make_halo_runner, rdma_backend_available, rdma_refusal,
)
from stochquant_tpu_torch.parallel.mesh import DeviceMesh
from test_torch_halo import MEANS, assert_same_run, run_split

torch.set_num_threads(1)

ACT = actions.get_field("phi4")


def _mk(shape, **kw):
    base = dict(action="phi4", shape=shape, dtau=0.01, n_chains=2, loops=4, seed=7,
                mesh_axes=("x",) + (None,) * (len(shape) - 1))
    base.update(kw)
    return FieldConfig(**base)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# (a) the runner against the JAX pallas_rdma runner (tests/test_halo.py:538-577)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,mesh_shape,loops,sweep", [
    ((64, 128), [("x", 4)], 8, Sweep.SYNC),
    ((16, 8, 4, 4), [("x", 4)], 4, Sweep.SYNC),
    ((16, 8, 4, 4), [("x", 2)], 4, Sweep.CHECKERBOARD),
])
def test_rdma_runner_matches_jax_pallas_rdma_runner(shape, mesh_shape, loops, sweep):
    """Both packages start from the JAX state's bits and run two frames on the
    same dim-0 ring: the port's kernel 8 plain version against the JAX kernel
    8 in interpret mode, whose remote copies the virtual mesh emulates."""
    cfg = _mk(shape, loops=loops, sweep=sweep)
    jcfg = JFieldConfig.from_json(cfg.to_json())
    jact = jphi4.get_field(cfg.action)
    s0 = jfield.init_field_state(jcfg)
    jmesh = jmake_mesh(mesh_shape)
    want, wm = jmake_halo_runner(jact, jcfg, jmesh, backend="pallas_rdma", interpret=True)(
        jshard_field_state(s0, jmesh, jcfg), 2)
    mesh = make_mesh(mesh_shape, devices="cpu")
    arrays = {name: np.asarray(leaf) for name, leaf in zip(s0._fields, s0)}
    runner = make_halo_runner(ACT, cfg, mesh, backend="cuda_rdma")
    assert runner.backend == "cuda_rdma"
    out, gm = runner(shard_state_from_numpy(arrays, mesh, cfg), 2)
    got = gather_field_state(out, mesh, cfg)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        elif name in MEANS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=name)
        elif name == "corr_mean":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6, err_msg=name)


# ---------------------------------------------------------------------------
# (b) the runner against the unsplit plain integrator, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,mesh_shape,chain_ax,kw", [
    ((16, 16), [("x", 2)], None, dict(loops=8)),
    ((16, 16), [("x", 1)], None, dict(loops=8)),                       # a ring of one
    ((16, 16), [("x", 4)], None, dict(loops=10, exchange_steps=4)),    # W = 4, then a W = 2 tail
    ((16, 16), [("chain", 2), ("x", 2)], "chain",
     dict(loops=6, sweep=Sweep.CHECKERBOARD, exchange_steps=2, n_chains=4)),
    ((16, 8, 4, 4), [("x", 4)], None, {}),
    ((12, 6, 4), [("x", 3)], None, dict(sweep=Sweep.CHECKERBOARD, rng_impl="threefry13")),
])
def test_rdma_runner_equals_the_unsplit_run(shape, mesh_shape, chain_ax, kw):
    cfg = _mk(shape, mesh_chain_axis=chain_ax, **kw)
    ref, out, mref, mout, runner = run_split(cfg, mesh_shape, "cuda_rdma")
    assert runner.backend == "cuda_rdma"
    assert_same_run(ref, out, mref, mout)


# ---------------------------------------------------------------------------
# (c) the plain version against kernel 7's on an independently extended block
# ---------------------------------------------------------------------------


def _extend(phi, H, offset, loc0):
    """Rows offset - H .. offset + loc0 + H of the periodic lattice (C, L0, ...)."""
    idx = (torch.arange(loc0 + 2 * H, device=phi.device) + offset - H) % phi.shape[1]
    return phi.index_select(1, idx).contiguous()


@pytest.mark.parametrize("shape,n,W,sweep", [
    ((16, 12), 4, 4, Sweep.SYNC),
    ((12, 6, 5), 2, 2, Sweep.CHECKERBOARD),
    ((10, 8), 1, 2, Sweep.SYNC),                 # a ring of one: all three slabs the same
])
def test_rdma_ref_equals_the_chunk_ref_on_the_extended_block(shape, n, W, sweep):
    """Random data, different on every shard, pins the halo direction: rows
    above a slab are the left neighbour's last H, rows below the right
    neighbour's first H.  The result is also the whole lattice's there."""
    cfg = _mk(shape, sweep=sweep, n_chains=3)
    phi = torch.from_numpy(np.random.default_rng(11).normal(size=(3,) + shape).astype(np.float32))
    dtau = torch.tensor([0.01, 0.013, 0.008])
    L = shape[0] // n
    slabs = [phi[:, i * L:(i + 1) * L].contiguous() for i in range(n)]
    H = nd.chunk_halos(cfg, W, (True,))[0]
    split = (True,) + (False,) * (len(shape) - 1)
    whole = micro_steps(phi, dtau, ACT, cfg, 5, W, chain_offset=4)[-1][1]
    for i in range(n):
        off = (i * L,) + (0,) * (len(shape) - 1)
        args = (slabs[i], slabs[i - 1], slabs[(i + 1) % n], dtau, ACT, cfg, W, 5, off, 4)
        before = nd.field_chunk_rdma_nd.launches
        got = nd.field_chunk_rdma_nd(*args)
        assert nd.field_chunk_rdma_nd.launches == before      # the CPU runs the plain version
        want = nd.field_chunk_nd_ref(_extend(phi, H, i * L, L), dtau, ACT, cfg, W, split, 5, off, 4)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        for x, y in zip(nd.field_chunk_rdma_nd_ref(*args), want):
            assert torch.equal(x, y)
        assert torch.equal(got[0], whole[:, i * L:(i + 1) * L])
        if n > 2:  # the neighbours swapped: another block
            swapped = nd.field_chunk_rdma_nd(slabs[i], slabs[(i + 1) % n], slabs[i - 1],
                                             *args[3:])
            assert not torch.equal(swapped[0], got[0])


# ---------------------------------------------------------------------------
# (d) routing, as the JAX package routes (tests/test_halo.py:588-640)
# ---------------------------------------------------------------------------


def _cuda_mesh(*axes):
    """A mesh of one CUDA device repeated, built without asking the machine
    for a GPU: the routing functions only read it."""
    names, sizes = tuple(n for n, _ in axes), tuple(s for _, s in axes)
    return DeviceMesh(names, sizes, (torch.device("cuda", 0),) * int(np.prod(sizes)))


@pytest.mark.parametrize("mesh_axes,mesh_shape,prefer,jax_route,want", [
    (("x", None), [("x", 2)], True, "pallas_rdma", "cuda_rdma"),
    (("x", "y"), [("x", 2), ("y", 2)], True, "pallas", "cuda"),   # a dim-1 split
    (("x", None), [("x", 2)], False, "pallas", "cuda"),           # the flag off
])
def test_prefer_rdma_routes_as_the_jax_package(mesh_axes, mesh_shape, prefer, jax_route, want):
    cfg = FieldConfig(action="phi4", shape=(256, 256), dtau=0.01, n_chains=2, loops=4,
                      mesh_axes=mesh_axes, prefer_rdma=prefer)
    jcfg = JFieldConfig.from_json(cfg.to_json())
    jmesh = jmake_mesh(mesh_shape)
    notes = []
    assert jruntime.select_field_backend(jcfg, "auto", on_tpu=True, use_halo=True, mesh=jmesh,
                                         notices=notes) == jax_route
    mesh = _cuda_mesh(*mesh_shape)
    assert rdma_backend_available(ACT, cfg, mesh) == jrdma_backend_available(
        jphi4.get_field("phi4"), jcfg, jmesh) == (jax_route == "pallas_rdma" or not prefer)
    assert runtime.select_field_backend(cfg, "auto", None, mesh) == want
    reason = runtime.split_fallback_reason(cfg, "auto", mesh)
    assert (reason is not None) == (len(notes) == 1)
    if reason:
        assert "dim-0-only" in reason and "'cuda'" in reason
    # an explicit backend ignores the flag, as in the JAX package
    assert runtime.select_field_backend(cfg, "cuda", None, mesh) == "cuda"


@pytest.fixture
def cuda_route_on_cpu(monkeypatch):
    """What the router does on a mesh of CUDA devices, run here on CPU shards
    (the kernel wrappers then run their plain versions)."""
    monkeypatch.setattr(runtime, "_mesh_on_cuda", lambda mesh: True)


def test_run_field_records_one_backend_fallback_where_kernel_8_does_not_apply(cuda_route_on_cpu):
    base = FieldConfig(action="phi4", shape=(16, 16), dtau=0.01, n_chains=2, loops=4, frames=2,
                       seed=3, prefer_rdma=True)
    want = runtime.run_field(dataclasses.replace(base, prefer_rdma=False), device="cpu",
                             backend="torch", sink=metrics.MetricsSink()).state
    for mesh_axes, mesh_shape, n_records in ((("x", "y"), [("x", 2), ("y", 2)], 1),
                                             (("x", None), [("x", 2)], 0)):
        cfg = dataclasses.replace(base, mesh_axes=mesh_axes)
        recs = []
        before = nd.field_chunk_nd.launches
        got = runtime.run_field(cfg, mesh=make_mesh(mesh_shape, devices="cpu"),
                                sink=metrics.MetricsSink(callback=recs.append)).state
        fallbacks = [r for r in recs if r["type"] == "backend_fallback"]
        assert len(fallbacks) == n_records
        if n_records:
            assert fallbacks[0]["backend"] == "cuda" and "dim-0-only" in fallbacks[0]["reason"]
            assert recs[0] is fallbacks[0]
        assert nd.field_chunk_nd.launches == before  # plain versions on the CPU: no launch
        for name in ("phi", "dtau", "lrg_vl", "runs", "stab_cnt", "step"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (mesh_axes, name)


def test_run_field_on_cuda_rdma_checkpoints_and_resumes_bitwise(cuda_route_on_cpu, tmp_path):
    cfg = FieldConfig(action="phi4", shape=(16, 8), dtau=0.01, n_chains=4, loops=6, frames=3,
                      seed=5, mesh_axes=("x", None), mesh_chain_axis="chain", exchange_steps=4)
    mesh = make_mesh([("chain", 2), ("x", 2)], devices="cpu")
    assert runtime.select_field_backend(cfg, "cuda_rdma", None, mesh) == "cuda_rdma"
    full = runtime.run_field(cfg, mesh=mesh, backend="cuda_rdma", sink=metrics.MetricsSink())
    ck = str(tmp_path / "rdma.npz")
    runtime.run_field(dataclasses.replace(cfg, frames=2), mesh=mesh, backend="cuda_rdma",
                      sink=metrics.MetricsSink(), checkpoint_out=ck)
    res = runtime.run_field(cfg, mesh=mesh, backend="cuda_rdma", sink=metrics.MetricsSink(),
                            checkpoint_in=ck, resume_progress=True)
    for name, a, b in zip(full.state._fields, res.state, full.state):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# (e) refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,kw,mesh,match", [
    ((16, 16), dict(mesh_axes=("x", "y")), [("x", 2), ("y", 2)], "dim-0-only"),
    ((16, 16), dict(mesh_axes=(None, "y")), [("y", 2)], r"mesh_axes\[0\]"),
    ((16, 16), dict(mesh_axes=(None, None), mesh_chain_axis="chain"), [("chain", 2)],
     r"mesh_axes\[0\]"),
    ((16, 16), dict(loops=8), [("x", 4)], "one hop"),                # H = 8 > 4 rows
    ((16, 16), dict(loops=5), [("x", 2)], "even cfg.loops"),
    ((16, 16), dict(exchange_steps=3), [("x", 2)], "even cfg.loops and exchange_steps"),
    ((16, 16), dict(exchange_steps=-2), [("x", 2)], "even number of steps"),
    ((16, 16), dict(rng_impl="hardware"), [("x", 2)], "counter-based"),
    ((16, 16), dict(dtype="float64"), [("x", 2)], "float32"),
    ((8, 8, 4), dict(loops=8, exchange_steps=8), [("x", 2)], "full global extent"),
])
def test_cuda_rdma_refusals(shape, kw, mesh, match):
    cfg = _mk(shape, **kw)
    mesh = make_mesh(mesh, devices="cpu")
    assert not rdma_backend_available(ACT, cfg, mesh)
    with pytest.raises(ValueError, match=match):
        make_halo_runner(ACT, cfg, mesh, backend="cuda_rdma")


def test_a_ring_on_two_devices_is_refused():
    cfg = _mk((16, 16))
    two = DeviceMesh(("x",), (2,), (torch.device("cuda", 0), torch.device("cuda", 1)))
    assert "several devices" in rdma_refusal(ACT, cfg, two)
    with pytest.raises(ValueError, match="several devices"):
        make_halo_runner(ACT, cfg, two, backend="cuda_rdma")
    # a prefer_rdma run there takes kernel 7 and says why
    pref = dataclasses.replace(cfg, prefer_rdma=True)
    assert runtime.select_field_backend(pref, "auto", None, two) == "cuda"
    assert "several devices" in runtime.split_fallback_reason(pref, "auto", two)
    # the wrapper refuses neighbours' slabs on another device than its own
    phi = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="several devices"):
        nd.field_chunk_rdma_nd(phi, torch.zeros((2, 8, 16), device="meta"), phi,
                               torch.full((2,), 0.01), ACT, cfg, 2, 1, (0, 0))


# ---------------------------------------------------------------------------
# (f) on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,W,sweep", [
    ((64, 128), 2, 8, Sweep.SYNC),
    ((16, 8, 4, 4), 4, 2, Sweep.SYNC),
    ((16, 8, 4, 4), 1, 2, Sweep.CHECKERBOARD),
    ((24, 12, 40), 3, 2, Sweep.CHECKERBOARD),
])
def test_cuda_rdma_kernel_matches_plain_version_and_kernel_7(cuda_device, shape, n, W, sweep):
    cfg = _mk(shape, sweep=sweep, n_chains=3)
    s0 = field.init_field_state(cfg, device=cuda_device)
    L = shape[0] // n
    slabs = [s0.phi[:, i * L:(i + 1) * L].contiguous() for i in range(n)]
    H = nd.chunk_halos(cfg, W, (True,))[0]
    split = (True,) + (False,) * (len(shape) - 1)
    for i in range(n):
        off = (i * L,) + (0,) * (len(shape) - 1)
        args = (slabs[i], slabs[i - 1], slabs[(i + 1) % n], s0.dtau, ACT, cfg, W, 3, off, 2)
        before = nd.field_chunk_rdma_nd.launches
        got = nd.field_chunk_rdma_nd(*args)
        want = nd.field_chunk_rdma_nd_ref(*args)
        k7 = nd.field_chunk_nd(_extend(s0.phi, H, i * L, L), s0.dtau, ACT, cfg, W, split, 3, off, 2)
        torch.cuda.synchronize()
        assert nd.field_chunk_rdma_nd.launches == before + 1
        for x, y in zip(got, k7):
            assert torch.equal(x, y)
        assert torch.equal(got[0], want[0])
        sites, per_slice = got[0][0].numel() // got[2].shape[1], got[0][0, 0].numel()
        torch.testing.assert_close(got[1] / per_slice, want[1] / per_slice, rtol=3e-5, atol=3e-6)
        maxima = [c for c in range(got[2].shape[2]) if c % 5 >= 3]
        sums = [c for c in range(got[2].shape[2]) if c % 5 < 3]
        assert torch.equal(got[2][..., maxima], want[2][..., maxima])
        torch.testing.assert_close(got[2][..., sums] / sites, want[2][..., sums] / sites,
                                   rtol=3e-5, atol=3e-6)


@pytest.mark.cuda
def test_cuda_rdma_runner_equals_the_kernel_7_runner(cuda_device):
    cfg = _mk((64, 128), n_chains=3, loops=10, mesh_chain_axis="chain")
    s0 = field.init_field_state(dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None),
                                device=cuda_device)
    mesh = make_mesh([("chain", 1), ("x", 2)], devices="cuda:0")
    out = {}
    for backend in ("cuda", "cuda_rdma"):
        nd.field_chunk_nd.launches = nd.field_chunk_rdma_nd.launches = 0
        shards, _ = make_halo_runner(ACT, cfg, mesh, backend=backend)(
            shard_field_state(s0, mesh, cfg), 2)
        torch.cuda.synchronize()
        out[backend] = gather_field_state(shards, mesh, cfg)
        k7, k8 = nd.field_chunk_nd.launches, nd.field_chunk_rdma_nd.launches
        # W = 8 and a W = 2 tail: 2 chunks a frame, 2 shards, 2 frames
        assert (k7, k8) == ((8, 0) if backend == "cuda" else (0, 8))
    for name, a, b in zip(out["cuda"]._fields, out["cuda"], out["cuda_rdma"]):
        assert torch.equal(a, b), name
