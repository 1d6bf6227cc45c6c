"""The port's D ≥ 3 chunk path (kernel 7): on the CPU ``field_chunk_nd`` runs
its plain version, which must match the JAX package's W-step chunk kernel
(interpret mode) launch for launch and frame for frame, and give the
trajectory of the port's own pair path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu.kernels import field_kernel_nd as jnd
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import Sweep
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.kernels import field_kernel_nd as nd
from test_torch_field_kernel_nd import (
    EXACT, MEANS, TRAJECTORY, _mk, assert_state_close, cuda_device, jax_start,  # noqa: F401
)

torch.set_num_threads(1)

SITE_SUM = dict(rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("shape,loops,sweep", [
    ((8, 8, 4, 4), 4, Sweep.SYNC),            # one W = 4 chunk
    ((8, 8, 4, 4), 6, Sweep.SYNC),            # a W = 4 chunk and a W = 2 tail
    ((16, 8, 4, 4), 6, Sweep.CHECKERBOARD),   # halo 8, then 4
    ((8, 8, 16), 8, Sweep.SYNC),              # two chunks, 3-D
])
def test_nd_chunk_path_matches_pallas_interpret_and_the_pair_path(shape, loops, sweep):
    cfg = _mk(shape=shape, loops=loops, sweep=sweep, exchange_steps=4)
    jcfg, jact, s0, port = jax_start(cfg)
    act = actions.get_field(cfg.action)
    got, gm = nd.run_field_frames_nd(port, act, cfg, 2, tile_rows=4)
    want, wm = jnd.run_field_frames_nd(s0, jact, jcfg, 2, tile_rows=4, interpret=True)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    assert_state_close(got, want)
    pair, pm = nd.run_field_frames_nd(port, act, dataclasses.replace(cfg, exchange_steps=None),
                                      2, tile_rows=4)
    assert torch.equal(gm["stable"], pm["stable"])
    for name in TRAJECTORY + EXACT:
        assert torch.equal(getattr(got, name), getattr(pair, name)), name
    for name in MEANS + ("corr_mean",):
        torch.testing.assert_close(getattr(got, name), getattr(pair, name), rtol=1e-5, atol=1e-7,
                                   msg=name)


def _extend(phi, halos, offsets, loc):
    """The block at ``offsets`` of the periodic lattice ``phi`` (C, *shape),
    extended by ``halos[d]`` sites per side."""
    out = phi
    for d, (h, o, n) in enumerate(zip(halos, offsets, loc)):
        idx = (np.arange(n + 2 * h) + o - h) % phi.shape[d + 1]
        out = np.take(out, idx, axis=d + 1)
    return np.ascontiguousarray(out)


@pytest.mark.parametrize("shape,sweep,W,split,loc,offsets,tile", [
    ((8, 8, 4, 4), Sweep.SYNC, 4, (True, False, False, False), (4, 8, 4, 4), (4, 0, 0, 0), 2),
    ((8, 8, 4, 4), Sweep.CHECKERBOARD, 2, (True, False, False, False), (8, 8, 4, 4),
     (0, 0, 0, 0), 4),
    # split on dims (0, 1) of a 3-D lattice, the block away from the origin
    ((8, 8, 16), Sweep.SYNC, 2, (True, True, False), (4, 4, 16), (4, 4, 0), 2),
    ((12, 16, 8), Sweep.CHECKERBOARD, 2, (True, True, False), (6, 8, 8), (6, 8, 0), 3),
])
def test_chunk_ref_matches_one_pallas_chunk_call(shape, sweep, W, split, loc, offsets, tile):
    cfg = _mk(shape=shape, sweep=sweep)
    jcfg, jact, s0, port = jax_start(cfg)
    C = cfg.n_chains
    step, halos = jnd.make_sharded_chunk_step_md(jact, jcfg, C, loc, W, split, tile_rows=tile,
                                                 interpret=True)
    assert halos == nd.chunk_halos(cfg, W, split)  # no alignment padding in these cases
    ext = _extend(np.asarray(s0.phi), halos, offsets, loc)
    dtau = np.array([0.01, 0.013], np.float32)
    want_phi, want_sl, want_stats = step(jnp.asarray(ext), jnp.asarray(dtau), 7,
                                         (3,) + tuple(offsets))
    phi_out, sl, stats = nd.field_chunk_nd_ref(
        torch.from_numpy(ext), torch.from_numpy(dtau), actions.get_field("phi4"), cfg, W, split,
        7, offsets, 3, tile)
    assert phi_out.shape == (C,) + loc and sl.shape == (C, W, loc[0])
    # the JAX kernel returns the extended extent in dims >= 1: cut the owned block
    want_phi = np.asarray(want_phi).reshape((C, loc[0]) + ext.shape[2:])
    own = (slice(None), slice(None)) + tuple(slice(h, h + n) for h, n in zip(halos[1:], loc[1:]))
    np.testing.assert_allclose(phi_out.numpy(), want_phi[own], rtol=2e-6, atol=2e-6)
    n_slice = float(np.prod(loc[1:]))
    np.testing.assert_allclose(sl.numpy() / n_slice, np.asarray(want_sl) / n_slice, **SITE_SUM)
    # the two packages cut the owned block differently: compare the totals
    want_stats, sites = np.asarray(want_stats), float(np.prod(loc))
    for w in range(W):
        for col in (0, 1, 2):
            np.testing.assert_allclose(stats[:, :, 5 * w + col].sum(1).numpy() / sites,
                                       want_stats[:, :, 5 * w + col].sum(1) / sites, **SITE_SUM)
        for col in (3, 4):
            np.testing.assert_allclose(stats[:, :, 5 * w + col].amax(1).numpy(),
                                       want_stats[:, :, 5 * w + col].max(1), rtol=2e-6, atol=2e-6)


def test_chunk_of_a_split_block_equals_the_whole_lattice_there():
    """Noise and parity come from global coordinates: a block of the lattice
    advanced alone gives the values the whole lattice has in that block."""
    cfg = _mk(shape=(8, 12, 6), sweep=Sweep.CHECKERBOARD, loops=2)
    act = actions.get_field("phi4")
    s0 = field.init_field_state(cfg, device="cpu")
    whole = nd.field_pair_nd_ref(s0.phi, s0.dtau, act, cfg, 3, None, 1)[0]
    split, loc, off = (True, True, False), (4, 6, 6), (4, 6, 0)
    ext = torch.from_numpy(_extend(s0.phi.numpy(), nd.chunk_halos(cfg, 2, split), off, loc))
    block, sl, stats = nd.field_chunk_nd(ext, s0.dtau, act, cfg, 2, split, 3, off, 1)
    assert torch.equal(block, whole[:, 4:8, 6:12])
    assert stats.shape[2] == 10 and sl.shape == (2, 2, 4)
    torch.testing.assert_close(sl[:, 0], s0.phi[:, 4:8, 6:12].sum((2, 3)), rtol=1e-5, atol=1e-6)


def test_cpu_chunk_runs_the_plain_version_without_launching():
    cfg = _mk()
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device="cpu")
    split = (True, False, False, False)
    ext = torch.cat([s0.phi[:, 4:], s0.phi, s0.phi[:, :4]], dim=1)
    before = nd.field_chunk_nd.launches
    got = nd.field_chunk_nd(ext, s0.dtau, act, cfg, 4, split, 1)
    want = nd.field_chunk_nd_ref(ext, s0.dtau, act, cfg, 4, split, 1)
    assert nd.field_chunk_nd.launches == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert got[0].shape == (2, 8, 8, 4, 4) and got[1].shape == (2, 4, 8)
    assert got[2].shape == (2, nd._chunk_geometry(ext, cfg, 4, split, None, None).n_blocks, 20)


@pytest.mark.parametrize("W,split,ext_shape,match", [
    (3, (True, False, False, False), (2, 14, 8, 4, 4), "even number of steps"),
    (0, (True, False, False, False), (2, 8, 8, 4, 4), "even number of steps"),
    (8, (True, False, False, False), (2, 24, 8, 4, 4), "full global extent"),
    (2, (True, False, False), (2, 12, 8, 4, 4), "dims"),
    (2, (True, False, False, False), (2, 12, 6, 4, 4), "whole"),
    (2, (True, True, False, False), (2, 4, 4, 4, 4), "thinner"),
])
def test_chunk_validation_errors(W, split, ext_shape, match):
    cfg = _mk()
    with pytest.raises(ValueError, match=match):
        nd.field_chunk_nd(torch.zeros(ext_shape), torch.full((2,), 0.01),
                          actions.get_field("phi4"), cfg, W, split, 1)


def test_chunk_frame_refuses_an_odd_exchange_steps():
    cfg = _mk(exchange_steps=3)
    s0 = field.init_field_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="even exchange_steps"):
        nd.run_field_frames_nd(s0, actions.get_field("phi4"), cfg, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sweep,W,split,loc,offsets,tile", [
    ((16, 8, 4, 4), Sweep.SYNC, 4, (True, False, False, False), (16, 8, 4, 4), (0, 0, 0, 0), None),
    ((16, 8, 4, 4), Sweep.CHECKERBOARD, 2, (True, False, False, False), (8, 8, 4, 4),
     (8, 0, 0, 0), 2),
    ((16, 12, 40), Sweep.CHECKERBOARD, 2, (True, True, False), (8, 6, 40), (8, 6, 0), None),
    ((24, 16), Sweep.SYNC, 6, (True, True), (12, 8), (12, 0), 4),
])
def test_cuda_chunk_nd_kernel_matches_plain_version(cuda_device, shape, sweep, W, split, loc,
                                                    offsets, tile):
    cfg = _mk(shape=shape, sweep=sweep, n_chains=3)
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device="cpu")
    ext = torch.from_numpy(_extend(s0.phi.numpy(), nd.chunk_halos(cfg, W, split), offsets, loc))
    ext, dtau = ext.to(cuda_device), s0.dtau.to(cuda_device)
    before = nd.field_chunk_nd.launches
    got = nd.field_chunk_nd(ext, dtau, act, cfg, W, split, 5, offsets, 2, tile)
    want = nd.field_chunk_nd_ref(ext, dtau, act, cfg, W, split, 5, offsets, 2, tile)
    torch.cuda.synchronize()
    assert nd.field_chunk_nd.launches == before + 1
    assert torch.equal(got[0], want[0])
    n_slice = float(np.prod(loc[1:]))
    torch.testing.assert_close(got[1] / n_slice, want[1] / n_slice, **SITE_SUM)
    sites = got[0][0].numel() // got[2].shape[1]
    maxima = [5 * w + c for w in range(W) for c in (3, 4)]
    sums = [5 * w + c for w in range(W) for c in (0, 1, 2)]
    assert torch.equal(got[2][..., maxima], want[2][..., maxima])
    torch.testing.assert_close(got[2][..., sums] / sites, want[2][..., sums] / sites, **SITE_SUM)
