"""The port's D ≥ 3 field pair path (kernel 6): on the CPU ``field_pair_nd``
runs its plain version, and the frames must match the JAX package's D-dim
Pallas path (interpret mode, as tests/test_field_kernel_nd.py runs it) and
its XLA integrator — φ, Δτ and lrg_vl within 2e-6, ``stable``, ``runs``,
``stab_cnt`` and ``step`` exactly, the running means at the JAX test's own
bars — and must not depend on the tiles."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu.kernels import field_kernel_nd as jnd
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import field_kernel_nd as nd

torch.set_num_threads(1)

EXACT = ("runs", "stab_cnt", "step")
MEANS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean")
TRAJECTORY = ("phi", "dtau", "lrg_vl")
# the four cases of tests/test_field_kernel_nd.py
CASES = [
    ((8, 8, 4, 4), 8, Sweep.SYNC),          # a block spans dim 0: periodic inside the tile
    ((8, 8, 4, 4), 2, Sweep.SYNC),          # tiles with a recomputed halo
    ((8, 8, 4, 4), 4, Sweep.CHECKERBOARD),
    ((8, 8, 16), 4, Sweep.SYNC),            # 3-D
]


def _mk(**kw):
    base = dict(action="phi4", shape=(8, 8, 4, 4), dtau=0.01, n_chains=2, loops=4, seed=9)
    base.update(kw)
    return FieldConfig(**base)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def jax_start(cfg):
    """(JAX config, JAX action, JAX initial state, the same state in the port)."""
    jcfg = JFieldConfig.from_json(cfg.to_json())
    s0 = jfield.init_field_state(jcfg)
    port = checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(s0._fields, s0)}, "cpu"
    )
    return jcfg, jphi4.get_field(cfg.action), s0, port


def assert_state_close(got, want):
    """The port's state against a JAX state: trajectory ≤ 2e-6, counters
    exact, means at tests/test_field_kernel_nd.py's bars."""
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in EXACT:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        elif name in MEANS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=name)
        elif name == "corr_mean":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("shape,tile,sweep", CASES)
def test_nd_pair_path_matches_pallas_interpret_and_xla(shape, tile, sweep):
    cfg = _mk(shape=shape, sweep=sweep)
    jcfg, jact, s0, port = jax_start(cfg)
    got, gm = nd.run_field_frames_nd(port, actions.get_field(cfg.action), cfg, 2, tile_rows=tile)
    pallas, pm = jnd.run_field_frames_nd(s0, jact, jcfg, 2, tile_rows=tile, interpret=True)
    xla, xm = jfield.run_field_frames(s0, jact, jcfg, 2)
    for want, wm in ((pallas, pm), (xla, xm)):
        np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
        assert_state_close(got, want)


@pytest.mark.parametrize("shape,tile,sweep", [CASES[1], CASES[2]])
def test_pair_ref_matches_one_pallas_pair_call(shape, tile, sweep):
    cfg = _mk(shape=shape, sweep=sweep, rng_impl="threefry13")
    jcfg, jact, s0, port = jax_start(cfg)
    C, L0, L1 = cfg.n_chains, shape[0], shape[1]
    dtau = np.array([0.01, 0.013], np.float32)
    call = jnd._pair_call(jact, jcfg, tile, True)
    flat = s0.phi.reshape(C, L0, L1, -1)
    scalars = jnp.array([cfg.seed, 5, 0], jnp.uint32)
    want_phi, want_sl0, want_sl1, want_stats = call(scalars, flat, flat, flat,
                                                    jnp.asarray(dtau)[:, None])
    phi2, sl0, sl1, stats = nd.field_pair_nd_ref(port.phi, torch.from_numpy(dtau),
                                                 actions.get_field("phi4"), cfg, 5, tile)
    np.testing.assert_allclose(phi2.numpy(), np.asarray(want_phi).reshape(phi2.shape),
                               rtol=2e-6, atol=2e-6)
    site_sum = dict(rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(sl0.numpy(), np.asarray(want_sl0), **site_sum)
    np.testing.assert_allclose(sl1.numpy(), np.asarray(want_sl1), **site_sum)
    # the two packages cut the lattice differently: compare the totals
    want_stats = np.asarray(want_stats)[:, :, :10]
    sites = float(np.prod(shape))
    for col in (0, 1, 2, 5, 6, 7):
        np.testing.assert_allclose(stats[:, :, col].sum(1).numpy() / sites,
                                   want_stats[:, :, col].sum(1) / sites, **site_sum)
    for col in (3, 4, 8, 9):
        np.testing.assert_allclose(stats[:, :, col].amax(1).numpy(),
                                   want_stats[:, :, col].max(1), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("sweep", [Sweep.SYNC, Sweep.CHECKERBOARD])
def test_nd_equals_plain_integrator_and_is_invariant_under_tiles(sweep):
    cfg = _mk(sweep=sweep, loops=6)
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device="cpu")
    whole, wm = field.run_field_frames(s0, act, cfg, 2)
    for tile_rows in (8, 4, 2, 1):
        got, gm = nd.run_field_frames_nd(s0, act, cfg, 2, tile_rows=tile_rows)
        assert torch.equal(gm["stable"], wm["stable"])
        for name in TRAJECTORY + EXACT:
            assert torch.equal(getattr(got, name), getattr(whole, name)), (tile_rows, name)
        for name in MEANS + ("corr_mean",):
            # per-block partial sums regroup with the tiles
            torch.testing.assert_close(getattr(got, name), getattr(whole, name),
                                       rtol=1e-5, atol=1e-7, msg=name)


def test_a_tripped_chain_is_rolled_back_as_in_pallas():
    cfg = _mk(dtau=50.0)  # wildly unstable: every frame is rejected
    jcfg, jact, s0, port = jax_start(cfg)
    got, gm = nd.run_field_frames_nd(port, actions.get_field("phi4"), cfg, 2, tile_rows=2)
    want, wm = jnd.run_field_frames_nd(s0, jact, jcfg, 2, tile_rows=2, interpret=True)
    assert not gm["stable"].any()
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    assert_state_close(got, want)


def test_cpu_pair_runs_the_plain_version_without_launching():
    cfg = _mk(sweep=Sweep.CHECKERBOARD)
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device="cpu")
    before = nd.field_pair_nd.launches
    got = nd.field_pair_nd(s0.phi, s0.dtau, act, cfg, 1, 4)
    want = nd.field_pair_nd_ref(s0.phi, s0.dtau, act, cfg, 1, 4)
    assert nd.field_pair_nd.launches == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    phi2, sl0, sl1, stats = got
    tiles = nd.resolve_tiles(cfg, cfg.shape, 2, 4)
    assert tiles == (4, 2, 2, 2) and stats.shape == (2, 2 * 4 * 2 * 2, 10)
    assert phi2.shape == (2, 8, 8, 4, 4) and sl0.shape == sl1.shape == (2, 8)
    # per-block Σφ of the first micro-step adds up to the lattice's
    torch.testing.assert_close(stats[:, :, 0].sum(1), s0.phi.sum((1, 2, 3, 4)),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sl0, s0.phi.mean((2, 3, 4)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape,chains,tile_rows,want", [
    ((32, 32, 32, 32), 1, None, (4, 8, 8, 8)),      # halved until 512 blocks
    ((32, 32, 32, 32), 8, None, (8, 8, 8, 16)),
    ((32, 32, 32, 32), 256, None, (8, 8, 8, 16)),   # enough chains: the box must fit
    ((32, 32, 32, 32), 1, 8, (8, 4, 8, 8)),         # tile_rows fixes dim 0
    ((8, 8, 4, 4), 2, None, (2, 2, 2, 2)),          # never below 2
    ((6, 10, 4), 1, None, (3, 5, 2)),               # an odd extent is not halved
    ((16, 256), 16, None, (8, 256)),                # a long last dim stays whole, a row a warp
])
def test_default_tiles(shape, chains, tile_rows, want):
    cfg = _mk(shape=shape, n_chains=chains)
    assert nd.resolve_tiles(cfg, shape, chains, tile_rows) == want
    assert nd.default_tile_rows(dataclasses.replace(cfg, tile_rows=tile_rows)) == want[0]
    geo = nd.Geometry(shape, shape, (0,) * len(shape), (0,) * len(shape), want, 2)
    assert geo.tile_halos == tuple(0 if t == n else 1 for t, n in zip(want, shape))
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape((1,) + shape)
    blocks = geo.blocks(x)
    assert blocks.shape == (1, geo.n_blocks, int(np.prod(want)))
    assert blocks[0, 0, 0] == 0 and blocks[0, -1, -1] == x.max()
    assert blocks[0, 0, -1] == x[(0,) + tuple(t - 1 for t in want)]


@pytest.mark.parametrize("change,kwargs,match", [
    (dict(exchange_steps=3), {}, "even exchange_steps"),
    (dict(rng_impl="hardware"), {}, "counter-based"),
    (dict(shape=(8, 8)), {}, "D >= 3"),
    (dict(), dict(tile_rows=3), "divide"),
    (dict(), dict(tile_rows=-2), "divide"),
    (dict(dtype="float64"), {}, "float32"),
    (dict(shape=(4, 4, 2, 2, 2, 2)), {}, "lattice dims"),
    (dict(exchange_steps=4, shape=(4, 8, 4)), {}, "full global extent"),
])
def test_nd_validation_errors(change, kwargs, match):
    act = actions.get_field("phi4")
    s0 = field.init_field_state(_mk(**{k: v for k, v in change.items() if k == "shape"}),
                                device="cpu")
    with pytest.raises(ValueError, match=match):
        nd.run_field_frames_nd(s0, act, _mk(**change), 1, **kwargs)


@pytest.mark.parametrize("route", ["frames", "pair", "chunk"])
@pytest.mark.parametrize("shape,loops,sweep", [
    ((8, 8, 8), 5, Sweep.SYNC),
    ((6, 4, 4, 4), 3, Sweep.CHECKERBOARD),
])
def test_odd_loops_end_in_the_one_step_tail_and_match_jax_xla(route, shape, loops, sweep):
    """An odd ``loops`` on every D >= 3 route: pairs (or W = 4 chunks) and one
    launch of kernel 6's code at one step, whose noise is the first output of
    the pair drawn at counter step0 + loops - 1, as in the JAX XLA frame."""
    cfg = _mk(shape=shape, loops=loops, sweep=sweep)
    jcfg, jact, s0, port = jax_start(cfg)
    act = actions.get_field(cfg.action)
    tails = []

    def tail(*a):
        tails.append(a[4])
        return nd.field_step_nd(*a)

    if route == "frames":
        got, gm = nd.run_field_frames_nd(port, act, cfg, 2, tile_rows=2, tail=tail)
    else:
        frames, state = [], port
        for _ in range(2):
            if route == "pair":
                state, m = nd.field_frame_nd(state, act, cfg, tile_rows=2, tail=tail)
            else:
                state, m = nd.field_frame_nd_chunk(state, act, cfg, 4, tile_rows=2, tail=tail)
            frames.append(m)
        got, gm = state, {k: torch.stack([m[k] for m in frames]) for k in frames[0]}
    assert tails == [1 + loops - 1, 1 + 2 * loops - 1]
    want, wm = jfield.run_field_frames(s0, jact, jcfg, 2)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    assert_state_close(got, want)
    whole, _ = field.run_field_frames(port, act, cfg, 2)
    for name in TRAJECTORY + EXACT:
        assert torch.equal(getattr(got, name), getattr(whole, name)), name


def test_step_ref_is_the_first_step_of_the_pair():
    cfg = _mk(shape=(8, 6, 4), sweep=Sweep.CHECKERBOARD)
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device="cpu")
    before = nd.field_step_nd.launches
    phi1, sl, stats = nd.field_step_nd(s0.phi, s0.dtau, act, cfg, 7, 4)
    assert nd.field_step_nd.launches == before
    pair = nd.field_pair_nd_ref(s0.phi, s0.dtau, act, cfg, 7, 4)
    assert torch.equal(sl, pair[1]) and stats.shape == (2, pair[3].shape[1], 5)
    # the pair's first step, taken alone: the first Box-Muller output at counter 7
    first = nd.field_step_nd_ref(s0.phi, s0.dtau, act, cfg, 7, 4)[0]
    assert torch.equal(phi1, first)
    assert torch.equal(stats[..., 0], pair[3][..., 0]) and torch.equal(stats[..., 3], pair[3][..., 3])


def test_nd_frame_refuses_a_state_of_another_lattice():
    s0 = field.init_field_state(_mk(shape=(8, 8, 4, 2)), device="cpu")
    with pytest.raises(ValueError, match="lattice"):
        nd.field_frame_nd(s0, actions.get_field("phi4"), _mk())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile,sweep,rng_impl,dtau", [
    ((8, 8, 4, 4), 8, Sweep.SYNC, "threefry", 0.01),
    ((8, 8, 4, 4), 2, Sweep.SYNC, "threefry13", 0.01),
    ((16, 12, 8, 8), None, Sweep.CHECKERBOARD, "threefry", 0.01),
    ((8, 12, 40), 4, Sweep.SYNC, "threefry", 0.01),
    ((8, 8, 4, 4), 2, Sweep.SYNC, "threefry", 50.0),
])
def test_cuda_pair_nd_kernel_matches_plain_version(cuda_device, shape, tile, sweep, rng_impl, dtau):
    cfg = _mk(shape=shape, sweep=sweep, rng_impl=rng_impl, dtau=dtau, n_chains=3)
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device=cuda_device)
    before = nd.field_pair_nd.launches
    got = nd.field_pair_nd(s0.phi, s0.dtau, act, cfg, 7, tile)
    want = nd.field_pair_nd_ref(s0.phi, s0.dtau, act, cfg, 7, tile)
    torch.cuda.synchronize()
    assert nd.field_pair_nd.launches == before + 1
    assert torch.equal(got[0], want[0])
    sites = got[0][0].numel() // got[3].shape[1]
    for k in (1, 2):
        torch.testing.assert_close(got[k], want[k], rtol=3e-5, atol=3e-6)
    assert torch.equal(got[3][..., [3, 4, 8, 9]], want[3][..., [3, 4, 8, 9]])
    sums = [0, 1, 2, 5, 6, 7]
    torch.testing.assert_close(got[3][..., sums] / sites, want[3][..., sums] / sites,
                               rtol=3e-5, atol=3e-6)
    plain, pm = nd.run_field_frames_nd(s0, act, cfg, 2, tile_rows=tile, pair=nd.field_pair_nd_ref)
    kern, km = nd.run_field_frames_nd(s0, act, cfg, 2, tile_rows=tile)
    assert torch.equal(km["stable"], pm["stable"])
    for name, x, y in zip(kern._fields, kern, plain):
        if name in EXACT + TRAJECTORY:
            assert torch.equal(x.cpu(), y.cpu()), name
        else:
            torch.testing.assert_close(x, y, rtol=3e-5, atol=3e-6, msg=name)
