"""The port's strip-tiled field kernel (kernel 5): on the CPU ``field_pair``
runs its plain version, and the tiled frame must match the JAX package's
tiled Pallas path (interpret mode, as tests/test_field_kernel_tiled.py runs
it) — φ, Δτ and lrg_vl within 2e-6, site means within rtol 3e-5 / atol
3e-6, decisions, runs and step exactly — and, inside the port, equal the
whole-lattice plain integrator bitwise in φ whatever ``tile_rows``."""

import numpy as np
import pytest
import torch

from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu.kernels import field_kernel_tiled as jft
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import field_kernel_tiled as ft

torch.set_num_threads(1)

EXACT = ("runs", "stab_cnt", "step")
MEANS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean",
         "corr_mean")
TRAJECTORY = ("phi", "dtau", "lrg_vl")


def _mk(sweep=Sweep.SYNC, **kw):
    kw.setdefault("shape", (16, 16))
    kw.setdefault("n_chains", 3)
    kw.setdefault("dtau", 5e-3)
    kw.setdefault("loops", 6)
    kw.setdefault("seed", 9)
    return FieldConfig(action="phi4", sweep=sweep, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _jax_start(cfg):
    jcfg = JFieldConfig.from_json(cfg.to_json())
    s0 = jfield.init_field_state(jcfg)
    port = checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(s0._fields, s0)}, "cpu"
    )
    return jcfg, jphi4.get_field(cfg.action), s0, port


def _assert_close(got, want, means_tol=dict(rtol=3e-5, atol=3e-6), traj_tol=2e-6):
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in EXACT:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        elif name in MEANS:
            np.testing.assert_allclose(g, w, err_msg=name, **means_tol)
        else:
            np.testing.assert_allclose(g, w, rtol=traj_tol, atol=traj_tol, err_msg=name)


@pytest.mark.parametrize("cfg,n_frames", [
    (_mk(Sweep.SYNC), 2),
    (_mk(Sweep.CHECKERBOARD, rng_impl="threefry13"), 2),
    (_mk(Sweep.SYNC, dtau=50.0, loops=4), 1),  # wildly unstable: the rollback
])
def test_tiled_plain_matches_pallas_interpret(cfg, n_frames):
    jcfg, jact, s0, port = _jax_start(cfg)
    want, wm = jft.run_field_frames_tiled(s0, jact, jcfg, n_frames, tile_rows=8, interpret=True)
    got, gm = ft.run_field_frames_tiled(port, actions.get_field(cfg.action), cfg, n_frames,
                                        tile_rows=8)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    _assert_close(got, want)
    if cfg.dtau == 50.0:
        assert not gm["stable"].all(), "case must trip the detector"


@pytest.mark.parametrize("sweep", [Sweep.SYNC, Sweep.CHECKERBOARD])
def test_tiled_equals_whole_lattice_and_is_invariant_under_tile_rows(sweep):
    cfg = _mk(sweep, shape=(16, 24))
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device="cpu")
    whole, wm = field.run_field_frames(s0, act, cfg, 2)
    for tile_rows in (2, 4, 8, 16):
        got, gm = ft.run_field_frames_tiled(s0, act, cfg, 2, tile_rows=tile_rows)
        assert torch.equal(gm["stable"], wm["stable"])
        for name in TRAJECTORY + EXACT:
            assert torch.equal(getattr(got, name), getattr(whole, name)), (tile_rows, name)
        _assert_close(got, whole)


def test_cpu_pair_runs_the_plain_version_without_launching():
    cfg = _mk(Sweep.CHECKERBOARD)
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device="cpu")
    before = ft.field_pair.launches
    got = ft.field_pair(s0.phi, s0.dtau, act, cfg, 1, 8)
    want = ft.field_pair_ref(s0.phi, s0.dtau, act, cfg, 1, 8)
    assert ft.field_pair.launches == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    phi2, sl0, sl1, stats = got
    assert phi2.shape == (3, 16, 16) and sl0.shape == sl1.shape == (3, 16)
    assert stats.shape == (3, 2, 10)
    # per-strip Σφ of the first micro-step adds up to the lattice's
    torch.testing.assert_close(stats[:, :, 0].sum(1), s0.phi.sum((1, 2)), rtol=1e-5, atol=1e-6)


def test_odd_loops_end_in_kernel_6_tail_and_match_jax_xla():
    """2-D (64, 96) with tile_rows and loops 7: three pairs of kernel 5 and one
    launch of kernel 6's code at one step per frame, against the JAX XLA
    frame at the same odd loops and the port's plain integrator bit for bit."""
    from stochquant_tpu_torch.kernels import field_kernel_nd as nd

    cfg = _mk(shape=(64, 96), n_chains=2, loops=7, tile_rows=16, dtau=0.01)
    jcfg, jact, s0, port = _jax_start(cfg)
    act = actions.get_field(cfg.action)
    pairs, tails = ft.field_pair.launches, nd.field_step_nd.launches
    got, gm = ft.run_field_frames_tiled(port, act, cfg, 2)
    assert (ft.field_pair.launches, nd.field_step_nd.launches) == (pairs, tails)  # CPU: plain
    want, wm = jfield.run_field_frames(s0, jact, jcfg, 2)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    _assert_close(got, want)
    whole, _ = field.run_field_frames(port, act, cfg, 2)
    for name in TRAJECTORY + EXACT:
        assert torch.equal(getattr(got, name), getattr(whole, name)), name


def test_default_tile_rows_fit_shared_memory():
    assert ft.resolve_tile_rows(_mk(shape=(1024, 1024))) == 8
    assert ft.resolve_tile_rows(_mk(Sweep.CHECKERBOARD, shape=(1024, 1024))) == 16
    assert ft.resolve_tile_rows(_mk(shape=(256, 256))) == 8
    assert ft.resolve_tile_rows(_mk(shape=(16, 16))) == 16
    assert ft.resolve_tile_rows(_mk(shape=(16, 16), tile_rows=4)) == 4
    assert ft.resolve_tile_rows(_mk(shape=(16, 16), tile_rows=4), 8) == 8
    for t0 in (ft.resolve_tile_rows(_mk(shape=(1024, 1024))), 64):
        assert ft.strip_bytes(t0, _mk(shape=(1024, 256))) <= ft.SMEM_BUDGET


def test_tiled_validation_errors():
    act = actions.get_field("phi4")
    s0 = field.init_field_state(_mk(), device="cpu")
    for cfg, tile_rows, match in (
        (_mk(dtype="float64"), 8, "float32"),
        (_mk(), 6, "divide"),
        (_mk(rng_impl="hardware"), 8, "counter-based"),
        (_mk(shape=(16, 8192)), 16, "shared memory"),
    ):
        with pytest.raises(ValueError, match=match):
            ft.field_frame_tiled(s0, act, cfg, tile_rows=tile_rows)
    with pytest.raises(ValueError, match="no tile_rows fits"):
        ft.resolve_tile_rows(_mk(Sweep.CHECKERBOARD, shape=(8, 8192)))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    _mk(Sweep.SYNC, shape=(64, 96), n_chains=2),
    _mk(Sweep.CHECKERBOARD, shape=(48, 128), rng_impl="threefry13"),
    _mk(Sweep.SYNC, dtau=50.0, loops=4),
])
def test_cuda_pair_kernel_matches_plain_version(cuda_device, cfg):
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device=cuda_device)
    plain, pm = ft.run_field_frames_tiled(s0, act, cfg, 2, tile_rows=8, pair=ft.field_pair_ref)
    before = ft.field_pair.launches
    for tile_rows in (8, 16):
        got, gm = ft.run_field_frames_tiled(s0, act, cfg, 2, tile_rows=tile_rows)
        torch.cuda.synchronize()
        assert torch.equal(gm["stable"], pm["stable"])
        for name, x, y in zip(got._fields, got, plain):
            if name in EXACT + TRAJECTORY:
                assert torch.equal(x.cpu(), y.cpu()), (tile_rows, name)
            else:
                torch.testing.assert_close(x, y, rtol=3e-5, atol=3e-6, msg=name)
    assert ft.field_pair.launches == before + 2 * cfg.loops
