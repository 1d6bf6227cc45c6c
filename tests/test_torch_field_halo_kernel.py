"""The port's per-micro-step halo kernel (kernel 9): on the CPU
``field_halo_step`` runs its plain version, which must give the eight outputs
of the JAX package's ``make_local_step`` (Pallas interpret mode) on the same
block: new φ and the interior maxima within 2e-6, the interior count of
non-finite updates exactly, the site sums within rtol 3e-5 (held as means:
another summation order)."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.kernels import field_halo_kernel as jfh
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.kernels import field_halo_kernel as fh

torch.set_num_threads(1)

SITE_SUM = dict(rtol=3e-5, atol=3e-6)
ELEMENT = dict(rtol=2e-6, atol=2e-6)
NAMES = ("phi", "mag", "phi2", "act", "slice", "max_det", "n_bad", "max_new")


def _mk(**kw):
    base = dict(action="phi4", shape=(16, 32), dtau=0.01, n_chains=2, loops=4, seed=17)
    base.update(kw)
    return FieldConfig(**base)


def _block(cfg, loc, seed=0, nan=None):
    """A local block (C, *loc) and per-chain Δτ from a seed, with numpy."""
    r = np.random.default_rng(seed)
    phi = r.normal(0.0, 0.6, size=(cfg.n_chains,) + tuple(loc)).astype(np.float32)
    if nan is not None:
        phi[nan] = np.nan
    dtau = (0.01 * (1.0 + 0.3 * np.arange(cfg.n_chains))).astype(np.float32)
    return phi, dtau


def assert_outputs_close(got, want, loc):
    sites = float(np.prod(loc))
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w).reshape(g.shape)
        if name == "n_bad":
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in ("mag", "phi2", "act"):
            np.testing.assert_allclose(g / sites, w / sites, err_msg=name, **SITE_SUM)
        elif name == "slice":
            np.testing.assert_allclose(g / loc[1], w / loc[1], err_msg=name, **SITE_SUM)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **ELEMENT)


@pytest.mark.parametrize("sharded", [(True, False), (False, True), (True, True), (False, False)])
@pytest.mark.parametrize("sweep,parity,half", [
    (Sweep.SYNC, 0, 0), (Sweep.SYNC, 1, 0), (Sweep.CHECKERBOARD, 0, 0),
    (Sweep.CHECKERBOARD, 1, 1),
])
def test_halo_step_ref_matches_pallas_interpret(sharded, sweep, parity, half):
    cfg = _mk(sweep=sweep)
    loc = tuple(n // 2 if s else n for n, s in zip(cfg.shape, sharded))
    offs = (3,) + tuple(n - m for n, m in zip(cfg.shape, loc))  # the last block of each split dim
    phi, dtau = _block(cfg, loc, seed=parity + 2 * half)
    jcfg = JFieldConfig.from_json(cfg.to_json())
    step = jfh.make_local_step(jphi4.get_field(cfg.action), jcfg, loc, cfg.n_chains, sharded,
                               interpret=True)
    want = step(jnp.asarray(phi), jnp.asarray(dtau), 7, parity, half, offs)
    got = fh.field_halo_step_ref(torch.from_numpy(phi), torch.from_numpy(dtau),
                                 actions.get_field(cfg.action), cfg, 7, parity, half, offs, sharded)
    assert got[0].shape == (cfg.n_chains,) + loc and got[4].shape == (cfg.n_chains, loc[0])
    assert_outputs_close(got, want, loc)


@pytest.mark.parametrize("nan,counted", [((1, 3, 5), True), ((0, 0, 9), False)])
def test_halo_step_nan_is_counted_on_interior_sites_only(nan, counted):
    """A NaN on an interior site shows in its chain's count and maxima; one on
    the first slice of a split dim is the runner's edge fixup's to catch, and
    only reaches the count through the interior sites that read it."""
    cfg = _mk(rng_impl="threefry13")
    loc, sharded, offs = (8, 32), (True, False), (0, 8, 0)
    phi, dtau = _block(cfg, loc, seed=5, nan=nan)
    jcfg = JFieldConfig.from_json(cfg.to_json())
    step = jfh.make_local_step(jphi4.get_field(cfg.action), jcfg, loc, cfg.n_chains, sharded,
                               interpret=True)
    want = step(jnp.asarray(phi), jnp.asarray(dtau), 2, 0, 0, offs)
    got = fh.field_halo_step_ref(torch.from_numpy(phi), torch.from_numpy(dtau),
                                 actions.get_field(cfg.action), cfg, 2, 0, 0, offs, sharded)
    assert_outputs_close(got, want, loc)
    n_bad = got[6].numpy()
    assert n_bad[1 - nan[0]] == 0
    # the site itself and its four neighbours, or the one interior site below the edge
    assert n_bad[nan[0]] == (5 if counted else 1)
    assert np.isnan(got[5].numpy()[nan[0]])


def _cut(lattice, offs, loc, sharded):
    """The block at ``offs`` (chain, row, column) of a periodic lattice (C, L0,
    L1) and its halo slices {dim: (low, high)} for the split dims."""
    C, L0, L1 = lattice.shape
    r, c = offs[1], offs[2]
    rows, cols = slice(r, r + loc[0]), slice(c, c + loc[1])
    halos = {}
    if sharded[0]:
        halos[0] = tuple(lattice[:, [(r - 1) % L0, (r + loc[0]) % L0][k:k + 1], cols].contiguous()
                         for k in (0, 1))
    if sharded[1]:
        halos[1] = tuple(lattice[:, rows, [(c - 1) % L1, (c + loc[1]) % L1][k:k + 1]].contiguous()
                         for k in (0, 1))
    return lattice[:, rows, cols].contiguous(), halos


HALO_CASES = [(Sweep.SYNC, 0, 0), (Sweep.SYNC, 1, 0), (Sweep.CHECKERBOARD, 0, 0),
              (Sweep.CHECKERBOARD, 1, 1)]


@pytest.mark.parametrize("sharded", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("sweep,parity,half", HALO_CASES)
def test_halo_step_with_halos_is_the_unsplit_step_on_the_block(sharded, sweep, parity, half):
    """With the halo slices of its split dims a block's micro-step is the
    whole lattice's on that block bit for bit (the last block, whose halos
    above wrap, and a middle one): new φ; the detector over every site equals
    the no-halo mode's interior on the block extended by its halo slices (the
    corners from the lattice); the action sum takes the true forward
    difference (the whole lattice's action density on the block, within the
    sum bar)."""
    cfg = _mk(shape=(16, 24), sweep=sweep)
    act = actions.get_field(cfg.action)
    lattice, dtau = (torch.from_numpy(a) for a in _block(cfg, cfg.shape, seed=3 + parity))
    loc = tuple(n // 2 if sp else n for n, sp in zip(cfg.shape, sharded))
    whole = fh.field_halo_step_ref(lattice, dtau, act, cfg, 7, parity, half, (3, 0, 0),
                                   (False, False))
    for offs in ((3,) + tuple(n - m for n, m in zip(cfg.shape, loc)),
                 (3,) + tuple(n // 4 if sp else 0 for n, sp in zip(cfg.shape, sharded))):
        block, halos = _cut(lattice, offs, loc, sharded)
        got = fh.field_halo_step_ref(block, dtau, act, cfg, 7, parity, half, offs, sharded,
                                     halos)
        r, c = offs[1], offs[2]
        assert torch.equal(got[0], whole[0][:, r:r + loc[0], c:c + loc[1]])
    # the middle block extended by one site a side along its split dims, without halos
    ext_loc = tuple(n + 2 if sp else n for n, sp in zip(loc, sharded))
    ext_offs = (3,) + tuple(o - 1 if sp else o for o, sp in zip(offs[1:], sharded))
    idx = [torch.arange(o, o + n) % L for o, n, L in zip(ext_offs[1:], ext_loc, cfg.shape)]
    ext = lattice[:, idx[0]][:, :, idx[1]].contiguous()
    ref = fh.field_halo_step_ref(ext, dtau, act, cfg, 7, parity, half, ext_offs, sharded)
    inner = tuple(slice(1, -1) if sp else slice(None) for sp in sharded)
    assert torch.equal(got[0], ref[0][(slice(None),) + inner])
    for i in (5, 6, 7):  # max|det|, the count, max|φ_new|: every site of the block
        assert torch.equal(got[i], ref[i]), NAMES[i]
    sites = float(np.prod(loc))
    dens = act.action_density(lattice, cfg.spacing, 2)[:, r:r + loc[0], c:c + loc[1]]
    torch.testing.assert_close(got[3] / sites, dens.sum(dim=(1, 2)) / sites, **SITE_SUM)
    torch.testing.assert_close(got[1], block.sum(dim=(1, 2)), rtol=0, atol=0)
    assert torch.equal(got[4], block.sum(dim=2))


def test_halo_step_counts_a_nan_in_a_halo_row():
    """A NaN in a halo slice reaches the one edge site that reads it: its
    update is not finite (counted, φ clamped), the chain's max|det| NaN; the
    other chain is untouched."""
    cfg = _mk(shape=(16, 24))
    act = actions.get_field(cfg.action)
    lattice, dtau = (torch.from_numpy(a) for a in _block(cfg, cfg.shape, seed=11))
    sharded, offs, loc = (True, False), (0, 8, 0), (8, 24)
    block, halos = _cut(lattice, offs, loc, sharded)
    clean = fh.field_halo_step_ref(block, dtau, act, cfg, 4, 0, 0, offs, sharded, halos)
    below = halos[0][0].clone()
    below[1, 0, 5] = float("nan")
    got = fh.field_halo_step_ref(block, dtau, act, cfg, 4, 0, 0, offs, sharded,
                                 {0: (below, halos[0][1])})
    assert got[6].tolist() == [0.0, 1.0] and clean[6].tolist() == [0.0, 0.0]
    assert torch.isnan(got[5][1]) and not torch.isnan(got[5][0])
    assert float(got[0][1, 0, 5]) == float(np.float32(cfg.clamp))
    changed = got[0] != clean[0]
    assert changed.sum() == 1 and bool(changed[1, 0, 5])


@pytest.mark.parametrize("halos,match", [
    ({}, "every split dim"),
    ({0: (torch.zeros(2, 1, 32), torch.zeros(2, 1, 32)), 1: None}, "every split dim"),
    ({0: (torch.zeros(2, 1, 31), torch.zeros(2, 1, 32))}, "shape"),
    ({0: (torch.zeros(2, 1, 32, dtype=torch.float64), torch.zeros(2, 1, 32))}, "float32"),
])
def test_halo_step_refuses_halos_that_do_not_fit(halos, match):
    with pytest.raises(ValueError, match=match):
        fh.field_halo_step(torch.zeros((2, 8, 32)), torch.full((2,), 0.01),
                           actions.get_field("phi4"), _mk(), 1, 0, 0, (0, 8, 0), (True, False),
                           halos)


def test_make_local_step_runs_the_plain_version_on_the_cpu_without_launching():
    cfg = _mk(sweep=Sweep.CHECKERBOARD)
    act = actions.get_field(cfg.action)
    loc, sharded, offs = (8, 16), (True, True), (0, 8, 16)
    phi, dtau = (torch.from_numpy(a) for a in _block(cfg, loc, seed=1))
    step = fh.make_local_step(act, cfg, loc, cfg.n_chains, sharded)
    before = fh.field_halo_step.launches
    got = step(phi, dtau, 4, 1, 1, offs)
    want = fh.field_halo_step_ref(phi, dtau, act, cfg, 4, 1, 1, offs, sharded)
    assert fh.field_halo_step.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="local block"):
        step(phi[:, :4], dtau, 4, 1, 1, offs)
    halos = {0: (phi[:, :1], phi[:, -1:]), 1: (phi[:, :, :1], phi[:, :, -1:])}
    got = step(phi, dtau, 4, 1, 1, offs, halos=halos)
    want = fh.field_halo_step_ref(phi, dtau, act, cfg, 4, 1, 1, offs, sharded, halos)
    assert fh.field_halo_step.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("change,args,match", [
    (dict(rng_impl="hardware"), {}, "hardware"),
    (dict(shape=(8, 8, 8)), {}, "2-D"),
    (dict(dtype="float64"), {}, "float32"),
    ({}, dict(offs=(0, 12, 0)), "leaves dim 0"),
    ({}, dict(offs=(0, 0)), "offs"),
    ({}, dict(dtau=torch.full((3,), 0.01)), "dtau"),
])
def test_halo_step_refuses_what_the_kernel_does_not_take(change, args, match):
    cfg = _mk(**change)
    kw = dict(phi=torch.zeros((2, 8, 32)), dtau=torch.full((2,), 0.01), offs=(0, 8, 0))
    kw.update(args)
    with pytest.raises(ValueError, match=match):
        fh.field_halo_step(kw["phi"], kw["dtau"], actions.get_field("phi4"), cfg, 1, 0, 0,
                           kw["offs"], (True, False))


def test_halo_params_mirror_the_cuda_struct():
    """FieldHaloParams is the 2-D kernels' FieldParams followed by ten 4-byte
    integers, in the order of csrc/field_halo_kernel.cu."""
    assert ctypes.sizeof(_build.FieldHaloParams) == ctypes.sizeof(_build.FieldParams) + 10 * 4
    src = (_build._CSRC / "field_halo_kernel.cu").read_text()
    start = src.index("struct FieldHaloParams {")
    body = src[start:src.index("};", start)]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [n.strip() for n in decl.split(None, 1)[1].split(",")]
    assert names == [f for f, _ in _build.FieldHaloParams._fields_]
    assert "field_halo_kernel.cu" in _build._SOURCES


@pytest.mark.parametrize("L0,C,rows", [(128, 16, 8), (20, 64, 4), (8, 2, 1), (256, 1, 1),
                                       (1000, 8, 31)])
def test_strip_rows_cuts_a_chain_into_enough_blocks(L0, C, rows):
    assert fh.strip_rows(L0, C) == rows
    strips = -(-L0 // rows)
    assert (strips - 1) * rows < L0 <= strips * rows


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sweep,parity,half,sharded,loc,offs", [
    (Sweep.SYNC, 0, 0, (True, False), (24, 40), (3, 24, 0)),
    (Sweep.SYNC, 1, 0, (True, True), (25, 35), (0, 25, 35)),
    (Sweep.CHECKERBOARD, 1, 1, (True, True), (25, 35), (1, 25, 35)),
    (Sweep.SYNC, 0, 0, (False, False), (50, 70), (0, 0, 0)),
])
def test_cuda_halo_step_kernel_matches_plain_version(cuda_device, sweep, parity, half, sharded,
                                                     loc, offs):
    cfg = _mk(shape=(50, 70), n_chains=3, sweep=sweep)
    act = actions.get_field(cfg.action)
    phi, dtau = (torch.from_numpy(a).to(cuda_device) for a in _block(cfg, loc, seed=9))
    before = fh.field_halo_step.launches
    got = fh.field_halo_step(phi, dtau, act, cfg, 6, parity, half, offs, sharded)
    want = fh.field_halo_step_ref(phi, dtau, act, cfg, 6, parity, half, offs, sharded)
    torch.cuda.synchronize()
    assert fh.field_halo_step.launches == before + 1
    for i in (0, 5, 6, 7):
        assert torch.equal(got[i], want[i]), NAMES[i]
    assert_outputs_close([g.cpu() for g in got], [w.cpu().numpy() for w in want], loc)
    with pytest.raises(ValueError, match="contiguous|stride"):
        fh.field_halo_step(phi.transpose(1, 2).contiguous().transpose(1, 2), dtau, act,
                           dataclasses.replace(cfg), 6, parity, half, offs, sharded)


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("sweep,parity,half", HALO_CASES)
def test_cuda_halo_step_kernel_with_halos_matches_plain_version(cuda_device, sharded, sweep,
                                                                parity, half):
    cfg = _mk(shape=(50, 70), n_chains=3, sweep=sweep)
    act = actions.get_field(cfg.action)
    lattice, dtau = (torch.from_numpy(a).to(cuda_device) for a in _block(cfg, cfg.shape, seed=9))
    lattice[1, 24, 3] = float("nan")  # an edge site of the dim-0 split's block
    loc = tuple(n // 2 if sp else n for n, sp in zip(cfg.shape, sharded))
    offs = (1,) + tuple(n - m for n, m in zip(cfg.shape, loc))
    block, halos = _cut(lattice, offs, loc, sharded)
    # strided views, as the runner's narrowed slices of a neighbour's block are
    views = {d: tuple(torch.cat([h, h], dim=2 - d).narrow(2 - d, 0, h.shape[2 - d]) for h in pair)
             for d, pair in halos.items()}
    assert not any(h.is_contiguous() for pair in views.values() for h in pair)
    got = fh.field_halo_step(block, dtau, act, cfg, 6, parity, half, offs, sharded, views)
    want = fh.field_halo_step_ref(block, dtau, act, cfg, 6, parity, half, offs, sharded, halos)
    torch.cuda.synchronize()
    for i in (0, 5, 6, 7):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=0, equal_nan=True,
                                   msg=NAMES[i])
    assert_outputs_close([g.cpu() for g in got], [w.cpu().numpy() for w in want], loc)
