"""The port's device mesh and field halo runner on a mesh of repeated CPU
devices: a lattice that is really cut gives the unsplit plain integrator's φ
bit for bit on every backend (the kernel wrappers run their plain versions on
CPU tensors), the running means to float tolerance (sums completed across
shards), and agrees with the JAX package's ``make_halo_runner(backend="xla")``
on its 8-device CPU mesh within 2e-6 with exact decisions."""

import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu.parallel import make_mesh as jmake_mesh
from stochquant_tpu.parallel import shard_field_state as jshard_field_state
from stochquant_tpu.parallel.halo import make_halo_runner as jmake_halo_runner
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field, langevin
from stochquant_tpu_torch.integrators import gauge as gauge_mod
from stochquant_tpu_torch.kernels import field_halo_kernel, field_kernel_nd
from stochquant_tpu_torch.parallel import (
    gather_chain_state, gather_field_state, gather_gauge_state, make_mesh, shard_chain_state,
    shard_field_state, shard_gauge_state, shard_state_from_numpy,
)
from stochquant_tpu_torch.parallel import mesh as mesh_mod
from stochquant_tpu_torch.parallel.halo import (
    chunk_backend_available, halo_shifted, make_halo_runner,
)

torch.set_num_threads(1)

MEANS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean")
BITWISE = ("phi", "dtau", "lrg_vl", "runs", "stab_cnt", "step")
# tests/test_halo.py:16-24
MESHES = [
    (("x", None), [("x", 4)], None),
    (("x", "y"), [("x", 2), ("y", 2)], None),
    (("x", "y"), [("chain", 2), ("x", 2), ("y", 2)], "chain"),
]


def _mk(**kw):
    base = dict(action="phi4", shape=(16, 16), dtau=0.01, n_chains=4, loops=8, seed=77)
    base.update(kw)
    return FieldConfig(**base)


def run_split(cfg, mesh_shape, backend, frames=2, **kw):
    """(unsplit plain run, split run gathered, their metrics, the runner)."""
    act = actions.get_field(cfg.action)
    base = dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None)
    s0 = field.init_field_state(base, device="cpu")
    ref, mref = field.run_field_frames(s0, act, base, frames)
    mesh = make_mesh(mesh_shape, devices="cpu")
    runner = make_halo_runner(act, cfg, mesh, backend=backend, **kw)
    out, mout = runner(shard_field_state(s0, mesh, cfg), frames)
    return ref, gather_field_state(out, mesh, cfg), mref, mout, runner


def assert_same_run(ref, out, mref, mout):
    for name in BITWISE:
        assert torch.equal(getattr(ref, name), getattr(out, name)), name
    for key in ("stable", "dtau"):
        assert torch.equal(mref[key], mout[key]), key
    for name in MEANS:  # sums completed across shards: another summation order
        torch.testing.assert_close(getattr(out, name), getattr(ref, name), rtol=1e-5, atol=1e-7,
                                   msg=name)
    torch.testing.assert_close(out.corr_mean, ref.corr_mean, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mesh_axes,mesh_shape,chain_ax", MESHES)
@pytest.mark.parametrize("backend,kw", [("torch", {}), ("torch", dict(overlap=False)),
                                        ("cuda_step", {}), ("cuda", {})])
def test_halo_runner_matches_unsplit(mesh_axes, mesh_shape, chain_ax, backend, kw):
    # loops 5 (odd: a tail step) on the per-step backends; 'cuda' resolves to
    # the chunk kernel, which needs even loops: W = 2, four chunks a frame
    loops, W = (8, 2) if backend == "cuda" else (5, None)
    cfg = _mk(mesh_axes=mesh_axes, mesh_chain_axis=chain_ax, loops=loops, exchange_steps=W)
    ref, out, mref, mout, runner = run_split(cfg, mesh_shape, backend, frames=3, **kw)
    assert runner.backend == ("cuda_nd" if backend == "cuda" else backend)
    assert_same_run(ref, out, mref, mout)


@pytest.mark.parametrize("backend", ["torch", "cuda_step"])
def test_halo_runner_checkerboard_matches_unsplit(backend):
    cfg = _mk(dtau=0.005, n_chains=2, loops=6, seed=19, sweep=Sweep.CHECKERBOARD,
              mesh_axes=("x", "y"))
    assert_same_run(*run_split(cfg, [("x", 2), ("y", 2)], backend)[:4])


def test_halo_runner_4d():
    cfg = _mk(action="free_field", shape=(4, 4, 4, 4), dtau=0.02, n_chains=2, loops=5, seed=5,
              mesh_axes=("x", None, "y", None))
    assert_same_run(*run_split(cfg, [("x", 2), ("y", 2)], "torch")[:4])


def test_overlap_and_blocking_stencils_bitwise_equal():
    cfg = _mk(shape=(8, 8), n_chains=2, loops=6, mesh_axes=("x", "y"))
    a = run_split(cfg, [("x", 4), ("y", 2)], "torch", overlap=True)[1]
    b = run_split(cfg, [("x", 4), ("y", 2)], "torch", overlap=False)[1]
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("shape,mesh_axes,mesh_shape,loops,W,sweep", [
    ((32, 64), ("x", "y"), [("x", 2), ("y", 4)], 8, None, Sweep.SYNC),      # 2-D, both dims, W = 8
    ((16, 16), ("x", "y"), [("x", 2), ("y", 2)], 6, 4, Sweep.CHECKERBOARD),  # W = 4 and a W = 2 tail
    ((16, 8, 4, 4), ("x", None, None, None), [("x", 8)], 8, 4, Sweep.SYNC),  # slabs of 2 < halo 4
    ((8, 8, 4), ("x", "y", None), [("x", 4), ("y", 2)], 4, 4, Sweep.SYNC),   # 3-D, multi-hop on x
    ((16, 64), (None, "y"), [("y", 4)], 8, None, Sweep.SYNC),                # dim 1 only
])
def test_halo_chunk_backend_on_multi_dim_splits_and_thin_slabs(shape, mesh_axes, mesh_shape,
                                                               loops, W, sweep):
    cfg = _mk(shape=shape, n_chains=2, loops=loops, seed=7, mesh_axes=mesh_axes, sweep=sweep,
              exchange_steps=W)
    mesh = make_mesh(mesh_shape, devices="cpu")
    assert chunk_backend_available(actions.get_field(cfg.action), cfg, mesh)
    ref, out, mref, mout, runner = run_split(cfg, mesh_shape, "cuda")
    assert runner.backend == "cuda_nd"
    assert_same_run(ref, out, mref, mout)


def test_halo_cuda_backend_resolution():
    """'cuda' resolves as the JAX package's 'pallas': whole-frame kernels per
    shard on a chain-only mesh (bitwise the unsplit kernel path, every leaf),
    the chunk kernel where the geometry admits it, else in 2-D kernel 9;
    'cuda_pair' forces the chunk kernel, a ring of one included."""
    cfg = _mk(loops=4, seed=5, mesh_axes=(None, None), mesh_chain_axis="chain")
    ref, out, mref, mout, runner = run_split(cfg, [("chain", 4)], "cuda")
    assert runner.backend == "cuda_frame"
    for name, x, y in zip(ref._fields, ref, out):
        assert torch.equal(x, y), name
    cfg3 = _mk(shape=(8, 4, 4), loops=4, seed=5, mesh_axes=(None, None, None),
               mesh_chain_axis="chain")
    ref, out, mref, mout, runner = run_split(cfg3, [("chain", 2)], "cuda")
    assert runner.backend == "cuda_frame"
    assert_same_run(ref, out, mref, mout)
    odd = _mk(loops=5, mesh_axes=("x", None))  # odd loops: no chunk kernel, so kernel 9
    ref, out, mref, mout, runner = run_split(odd, [("x", 2)], "cuda")
    assert runner.backend == "cuda_step"
    assert_same_run(ref, out, mref, mout)
    ring = _mk(n_chains=2, loops=4, seed=5, mesh_axes=("x", None))
    ref, out, mref, mout, runner = run_split(ring, [("x", 1)], "cuda_pair")
    assert runner.backend == "cuda_nd"
    assert_same_run(ref, out, mref, mout)


def test_halo_runner_takes_replacement_kernel_wrappers():
    """``step=`` / ``chunk=`` swap the wrapper (the ``_ref`` functions force
    the plain versions): the runner calls it once per micro-step / chunk and
    shard, kernel 9 with the halo slices of the split dims."""
    calls = {"step": 0, "chunk": 0}

    def step(*a, halos):
        calls["step"] += 1
        assert set(halos) == {0} and all(h.shape == (4, 1, 16) for h in halos[0])
        return field_halo_kernel.field_halo_step_ref(*a, halos=halos)

    def chunk(*a):
        calls["chunk"] += 1
        return field_kernel_nd.field_chunk_nd_ref(*a)

    cfg = _mk(loops=6, mesh_axes=("x", None))
    ref, out, mref, mout, _ = run_split(cfg, [("x", 2)], "cuda_step", frames=1, step=step)
    assert calls["step"] == 6 * 2
    assert_same_run(ref, out, mref, mout)
    cb = dataclasses.replace(cfg, sweep=Sweep.CHECKERBOARD)
    run_split(cb, [("x", 2)], "cuda_step", frames=1, step=step)
    assert calls["step"] == 12 + 2 * 6 * 2  # two half-sweeps a micro-step
    ref, out, mref, mout, _ = run_split(dataclasses.replace(cfg, exchange_steps=4), [("x", 2)],
                                        "cuda", frames=1, chunk=chunk)
    assert calls["chunk"] == 2 * 2  # a W = 4 chunk and a W = 2 tail per shard
    assert_same_run(ref, out, mref, mout)


@pytest.mark.parametrize("mesh_axes,mesh_shape,chain_ax", MESHES)
def test_halo_runner_matches_jax_xla_halo_runner(mesh_axes, mesh_shape, chain_ax):
    """Both packages start from the JAX state's bits (``shard_state_from_numpy``)
    and run three frames on the same mesh: φ, Δτ, lrg_vl within 2e-6, the
    decisions exact, the means at tests/test_halo.py's bars."""
    cfg = _mk(mesh_axes=mesh_axes, mesh_chain_axis=chain_ax)
    jcfg = JFieldConfig.from_json(cfg.to_json())
    jact = jphi4.get_field(cfg.action)
    s0 = jfield.init_field_state(jcfg)
    jmesh = jmake_mesh(mesh_shape)
    want, wm = jmake_halo_runner(jact, jcfg, jmesh, backend="xla")(
        jshard_field_state(s0, jmesh, jcfg), 3)
    mesh = make_mesh(mesh_shape, devices="cpu")
    arrays = {name: np.asarray(leaf) for name, leaf in zip(s0._fields, s0)}
    for backend in ("torch", "cuda_step"):
        out, gm = make_halo_runner(actions.get_field(cfg.action), cfg, mesh, backend=backend)(
            shard_state_from_numpy(arrays, mesh, cfg), 3)
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


@pytest.mark.parametrize("cfg_kw,mesh_shape,backend,match", [
    # kernel 8 runs dim-0-only splits, one hop deep (tests/test_torch_rdma.py runs it)
    (dict(mesh_axes=("x", "y")), [("x", 2), ("y", 2)], "cuda_rdma", "dim-0-only"),
    (dict(mesh_axes=("x", None)), [("x", 4)], "cuda_rdma", "one hop"),
    (dict(mesh_axes=None), [("x", 2)], "torch", "mesh_axes required"),
    (dict(mesh_axes=("x", None)), [("x", 2)], "pallas", "unknown halo backend"),
    (dict(mesh_axes=("x",)), [("x", 2)], "torch", "one entry per lattice dim"),
    (dict(mesh_axes=("x", None), shape=(6, 8)), [("x", 4)], "torch", "not divisible"),
    (dict(mesh_axes=("x", None), mesh_chain_axis="chain", n_chains=3),
     [("chain", 2), ("x", 2)], "torch", "n_chains 3 not divisible"),
    (dict(mesh_axes=("x", None), rng_impl="hardware"), [("x", 2)], "cuda_step", "hardware"),
    (dict(mesh_axes=("x", None), dtype="float64"), [("x", 2)], "cuda_step", "float32-only"),
    (dict(mesh_axes=("x", None, None), shape=(8, 8, 8)), [("x", 2)], "cuda_step", "2-D"),
    (dict(mesh_axes=("x", None, None), shape=(8, 8, 8), loops=5), [("x", 2)], "cuda",
     "not admissible"),
    (dict(mesh_axes=(None, None, None), shape=(8, 8, 8), loops=5, mesh_chain_axis="chain"),
     [("chain", 2)], "cuda", "even cfg.loops"),
    (dict(mesh_axes=(None, None)), [("x", 2)], "cuda_pair", "split lattice dim"),
    (dict(mesh_axes=("x", None), loops=5), [("x", 2)], "cuda_pair", "even cfg.loops"),
    (dict(mesh_axes=("x", None), exchange_steps=3), [("x", 2)], "cuda_pair", "even"),
    (dict(mesh_axes=("x", None), exchange_steps=-2), [("x", 2)], "cuda_pair", "even"),
    (dict(mesh_axes=("x", None), exchange_steps=16, loops=16), [("x", 2)], "cuda_pair",
     "full global extent"),
])
def test_halo_runner_refusals(cfg_kw, mesh_shape, backend, match):
    cfg = _mk(**cfg_kw)
    mesh = make_mesh(mesh_shape, devices="cpu")
    with pytest.raises(ValueError, match=match):
        make_halo_runner(actions.get_field(cfg.action), cfg, mesh, backend=backend)


def test_halo_shifted_wraps_across_the_ring():
    mesh = make_mesh([("x", 4)], devices="cpu")
    whole = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    xs = [whole[:, 2 * i:2 * i + 2].clone() for i in range(4)]
    ups, downs = halo_shifted(xs, 1, mesh, "x")
    assert torch.equal(torch.cat(ups, dim=1), torch.roll(whole, -1, 1))
    assert torch.equal(torch.cat(downs, dim=1), torch.roll(whole, 1, 1))
    ups, downs = halo_shifted(xs, 2, mesh, None)  # an unsplit axis: a local roll
    assert torch.equal(torch.cat(ups, dim=1), torch.roll(whole, -1, 2))


# ---------------------------------------------------------------------------
# the mesh: placement and collectives
# ---------------------------------------------------------------------------


def test_make_mesh_and_its_refusals():
    mesh = make_mesh([("chain", 2), ("x", 3)], devices="cpu")
    assert mesh.size == 6 and mesh.axis_size("x") == 3 and mesh.axis_size(None) == 1
    assert [mesh.coords(i) for i in (0, 1, 3, 5)] == [(0, 0), (0, 1), (1, 0), (1, 2)]
    assert mesh.neighbor(2, "x", +1) == 0 and mesh.neighbor(3, "x", -1) == 5
    assert mesh.groups(("x",)) == ((0, 1, 2), (3, 4, 5))
    assert mesh.groups(("chain",)) == ((0, 3), (1, 4), (2, 5))
    assert make_mesh([("x", 2)], devices=["cpu", "cpu", "cpu"]).size == 2
    for axes, devices, err, match in [
        ([("x", 2), ("x", 2)], "cpu", ValueError, "distinct names"),
        ([("x", 0)], "cpu", ValueError, "sizes >= 1"),
        ([("x", 4)], ["cpu"] * 3, ValueError, "needs 4 devices, have 3"),
        ([("x", 2)], None, ValueError, "needs 2 devices"),  # this machine has no GPU
        ([("x", 2)], "cuda:0", RuntimeError, "no CUDA device"),
        ([("x", 2)], "meta", ValueError, "unsupported mesh device"),
    ]:
        if devices is None and torch.cuda.device_count() >= 2:
            continue
        if devices == "cuda:0" and torch.cuda.is_available():
            continue
        with pytest.raises(err, match=match):
            make_mesh(axes, devices=devices)


def test_collectives_reduce_once_in_ascending_mesh_index():
    mesh = make_mesh([("c", 2), ("x", 3)], devices="cpu")
    xs = [torch.tensor([float(i), 10.0 * i]) for i in range(6)]
    out = mesh_mod.psum(xs, mesh, ("x",))
    assert [o.tolist() for o in out] == [[3.0, 30.0]] * 3 + [[12.0, 120.0]] * 3
    assert out[0] is out[1] is out[2]  # the replicas of a reduced value cannot part
    assert [o.tolist() for o in mesh_mod.psum(xs, mesh, ("c", "x"))] == [[15.0, 150.0]] * 6
    assert mesh_mod.psum(xs, mesh, ()) == xs and mesh_mod.pmax(xs, mesh, (None,)) == xs
    nan = [torch.tensor([1.0]), torch.tensor([float("nan")]), torch.tensor([3.0])] * 2
    got = mesh_mod.pmax(nan, mesh, ("x",))
    assert all(torch.isnan(g).all() for g in got)  # NaN propagates, as torch.maximum
    flags = [torch.tensor([i == 4]) for i in range(6)]
    assert [bool(f) for f in mesh_mod.pany(flags, mesh, ("x",))] == [False] * 3 + [True] * 3
    moved = mesh_mod.ppermute(xs, mesh, "x", +1)
    assert [int(m[0]) for m in moved] == [1, 2, 0, 4, 5, 3]
    cat = mesh_mod.pcat([x[None] for x in xs], mesh, ("x",), dim=0)
    assert cat[4].shape == (3, 2) and cat[4][:, 0].tolist() == [3.0, 4.0, 5.0]
    # float sums in mesh order: ((a + b) + c), not another association
    a, b, c = (torch.tensor([v], dtype=torch.float32) for v in (1e8, -1e8, 1.0))
    ring = make_mesh([("x", 3)], devices="cpu")
    assert mesh_mod.psum([a, b, c], ring, ("x",))[0].item() == 1.0
    assert mesh_mod.psum([a, c, b], ring, ("x",))[0].item() == 0.0


@pytest.mark.parametrize("mesh_axes,mesh_shape,chain_ax", MESHES + [
    ((None, None), [("chain", 4)], "chain"),
])
def test_shard_then_gather_is_the_identity_for_a_field_state(mesh_axes, mesh_shape, chain_ax):
    cfg = _mk(mesh_axes=mesh_axes, mesh_chain_axis=chain_ax)
    act = actions.get_field(cfg.action)
    base = dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None)
    whole, _ = field.run_field_frames(field.init_field_state(base, device="cpu"), act, base, 1)
    mesh = make_mesh(mesh_shape, devices="cpu")
    shards = shard_field_state(whole, mesh, cfg)
    assert len(shards) == mesh.size
    n_c = mesh.axis_size(chain_ax)
    loc = tuple(n // mesh.axis_size(ax) for n, ax in zip(cfg.shape, mesh_axes))
    last = shards[-1]
    assert last.phi.shape == (cfg.n_chains // n_c,) + loc and last.phi.is_contiguous()
    assert last.corr_mean.shape == (cfg.n_chains // n_c, loc[0])  # follows lattice dim 0
    assert torch.equal(last.phi, whole.phi[(slice(-last.phi.shape[0], None),)
                                           + tuple(slice(-n, None) for n in loc)])
    back = gather_field_state(shards, mesh, cfg)
    for name, x, y in zip(whole._fields, whole, back):
        assert torch.equal(x, y), name
    some = mesh_mod.gather_scalars(shards, mesh_mod.field_state_spec(cfg), mesh, ("dtau",))
    assert some.phi is None and torch.equal(some.dtau, whole.dtau)


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
def test_shard_then_gather_is_the_identity_for_a_gauge_state(group):
    cfg = gauge_mod.GaugeConfig(group=group, shape=(8, 4), n_chains=4, hot_start=True, seed=3,
                                mesh_axes=("x", "y"), mesh_chain_axis="chain")
    act = gauge_mod.resolve_gauge_action(cfg)
    whole = gauge_mod.init_gauge_state(cfg, act, device="cpu")
    mesh = make_mesh([("chain", 2), ("x", 2), ("y", 2)], devices="cpu")
    shards = shard_gauge_state(whole, act, mesh, cfg)
    want = list(whole.links.shape)
    want[0] //= 2
    for axis in act.lattice_axes(2):
        want[axis] //= 2
    assert list(shards[3].links.shape) == want and shards[3].runs.shape == (2, 2)
    back = gather_gauge_state(shards, act, mesh, cfg)
    for name, x, y in zip(whole._fields, whole, back):
        assert torch.equal(x, y), name


def test_shard_then_gather_is_the_identity_for_a_chain_state():
    from stochquant_tpu_torch import actions as chain_actions
    from stochquant_tpu_torch.config import ChainConfig

    cfg = ChainConfig(action="harmonic", n_sites=16, n_chains=6, loops=4, seed=2)
    whole = langevin.init_chain_state(cfg, chain_actions.get(cfg.action), device="cpu")
    mesh = make_mesh([("chain", 3)], devices="cpu")
    shards = shard_chain_state(whole, mesh)
    assert shards[1].f.shape == (2, 16)
    back = gather_chain_state(shards, mesh)
    for name, x, y in zip(whole._fields, whole, back):
        assert torch.equal(x, y), name
    with pytest.raises(ValueError, match="not divisible"):
        shard_chain_state(whole, make_mesh([("chain", 4)], devices="cpu"))
