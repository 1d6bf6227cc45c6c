"""The port's chain-kernel module: on the CPU its wrappers run the plain
versions, which must match the JAX package's Pallas kernels (interpret mode,
as tests/test_chain_kernel.py runs them).  The CUDA kernels themselves are
compared with the plain versions on the card (tests marked ``cuda``, and
``chip_smoke.py``)."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jact
from stochquant_tpu.config import ChainConfig as JChainConfig
from stochquant_tpu.integrators import langevin as jl
from stochquant_tpu.kernels import chain_kernel as jck
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.actions.base import QMAction
from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, Formulation, Scheme
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.kernels import chain_kernel as ck

torch.set_num_threads(1)

CFG = ChainConfig(action="double_well", n_sites=128, dt=0.05, dtau=0.001, n_chains=8,
                  loops=10, seed=11)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _jax_start(cfg):
    jcfg = JChainConfig.from_json(cfg.to_json())
    act = jact.get(cfg.action)
    s0 = jl.init_chain_state(jcfg, act)
    port = checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(s0._fields, s0)}, "cpu"
    )
    return jcfg, act, s0, port


def _assert_states_equal(a, b, label=""):
    for name, x, y in zip(a._fields, a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f"{label}:{name}")


@pytest.mark.parametrize("fpl", [1, 2])
def test_plain_kernels_match_pallas_interpret(fpl):
    """frames_per_launch=1 (kernel 1 + epilogue) and K=2 with a remainder
    frame (kernel 2 once, then kernel 1) against run_frames_pallas."""
    jcfg, jact_, s0, port = _jax_start(CFG)
    want, wm = jck.run_frames_pallas(s0, jact_, jcfg, 3, block_chains=4, interpret=True,
                                     frames_per_launch=fpl)
    got, gm = ck.run_frames_kernel(port, actions.get(CFG.action), CFG, 3,
                                   frames_per_launch=fpl, block_chains=4)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=2e-6, err_msg=name)


def test_chain_blocking_does_not_change_results():
    """block_chains is accepted for checkpoint compatibility and ignored,
    its autotune value 0 (the launch's own layout) as well."""
    act = actions.get(CFG.action)
    s0 = langevin.init_chain_state(CFG, act, device="cpu")
    for fpl in (1, 2):
        ref, rm = ck.run_frames_kernel(s0, act, CFG, 3, frames_per_launch=fpl)
        for block in (0, 2, 3, 4):
            got, gm = ck.run_frames_kernel(s0, act, CFG, 3, frames_per_launch=fpl,
                                           block_chains=block)
            _assert_states_equal(got, ref, f"fpl={fpl} block={block}")
            for key in rm:
                torch.testing.assert_close(gm[key], rm[key], rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_versions_without_launching():
    act = actions.get(CFG.action)
    s0 = langevin.init_chain_state(CFG, act, device="cpu")
    before = (ck.chain_frame.launches, ck.chain_frames_multi.launches)
    sums = ck.chain_frame(s0, act, CFG, chain_offset=8)
    ref = ck.chain_frame_ref(s0, act, CFG, chain_offset=8)
    for name, x, y in zip(sums._fields, sums, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    multi, mm = ck.chain_frames_multi(s0, act, CFG, 2)
    multi_ref, mr = ck.chain_frames_multi_ref(s0, act, CFG, 2)
    _assert_states_equal(multi, multi_ref, "multi")
    assert mm["stable"].shape == (2, CFG.n_chains)
    assert (ck.chain_frame.launches, ck.chain_frames_multi.launches) == before
    # K frames of kernel 2 == K launches of kernel 1 + the PyTorch epilogue
    single, _ = ck.run_frames_kernel(s0, act, CFG, 2, frames_per_launch=1)
    _assert_states_equal(multi, single, "multi vs single")


@pytest.mark.parametrize("n_sites,n_chains,want", [
    (2, 1, (1, 1, 1)), (20, 530, (1, 1, 4)), (32, 8, (1, 2, 1)), (40, 600, (1, 2, 4)),
    (96, 65536, (2, 2, 1)), (100, 300, (2, 2, 1)),
    (200, 65536, (4, 2, 1)), (200, 256, (4, 2, 1)), (200, 16, (4, 2, 1)),
    (1024, 256, (11, 3, 1)), (1024, 8, (17, 2, 1)), (2000, 8, (32, 2, 1)),
    (4096, 1, (19, 7, 1)), (4096, 65536, (19, 7, 1)), (4097, 1, None), (1, 8, None),
])
def test_launch_geometry(n_sites, n_chains, want):
    """(G warps a chain, S sites a lane, chains a block); 32 G S >= N + 1 leaves
    slot N (the collective coordinate's noise) to a lane without a full share."""
    if want is None:
        with pytest.raises(ValueError, match="limit"):
            ck.launch_geometry(n_sites, n_chains)
        return
    G, S, cpb = ck.launch_geometry(n_sites, n_chains)
    assert (G, S, cpb) == want
    assert 32 * G * S >= n_sites + 1 and 32 * (G - 1) * S < n_sites + 1
    assert 1 <= S <= ck.MAX_SITES_PER_LANE and 1 <= G <= ck.MAX_WARPS
    assert G == 1 or cpb == 1
    assert 32 * G * cpb <= ck.max_threads(S)  # the kernel's register budget


def _kernel_partners(N, G, S, periodic):
    """Python mirror of ``partners`` + ``drift`` in csrc/chain_kernel.cu: for
    every site, the (site or ghost, route) the kernel reads as its lower and
    upper neighbour.  Routes: 'lane' (the same thread's registers),
    'shuffle' (another lane of the warp), 'shared' (the exchange buffer,
    G > 1 only), 'ghost'."""
    out = {}
    for i in range(N):
        t, k = divmod(i, S)
        lane, w = t % 32, t // 32
        if k > 0:
            down = (i - 1, "lane")
        elif t == 0:
            down = (N - 1, "shuffle" if G == 1 else "shared") if periodic else ("gl", "ghost")
        elif lane > 0:  # __shfl_up_sync of v[S - 1]
            down = ((t - 1) * S + S - 1, "shuffle")
        else:  # hi[w - 1]: lane 31 of warp w - 1, slot S - 1
            down = ((32 * w - 1) * S + S - 1, "shared")
        if i == N - 1:  # right_end
            up = (0, "shuffle" if G == 1 else "shared") if periodic else ("gr", "ghost")
        elif k < S - 1:
            up = (i + 1, "lane")
        elif lane < 31:  # __shfl_down_sync of v[0]
            up = ((t + 1) * S, "shuffle")
        elif w + 1 < G:  # lo[w + 1]
            up = (32 * (w + 1) * S, "shared")
        else:
            up = (None, "none")
        out[i] = (down, up)
    return out


@pytest.mark.parametrize("bc", list(BoundaryCondition))
def test_layout_reaches_every_site_and_neighbour(bc):
    """For every N the kernels take: each site is held by exactly one
    (warp, lane, slot), contiguous per lane; every neighbour pair is read
    through a route the kernel has (the same lane, a shuffle within the warp,
    shared memory only at G > 1); the collective coordinate's noise (slot N)
    falls to a lane with fewer than S sites, inside the chain's threads."""
    periodic = bc == BoundaryCondition.PERIODIC
    detailed = set(range(2, 300)) | {511, 512, 1023, 1024, 1025, 1500, 2047, 2048, 4095, 4096}
    for N in range(2, ck.MAX_SITES + 1):
        G, S, cpb = ck.launch_geometry(N, 1)
        threads = 32 * G
        sites = np.arange(N)
        owner = sites // S
        assert owner.max() < threads
        assert np.all(np.bincount(owner, minlength=threads)[: owner.max()] == S)  # full lanes
        assert np.all(np.diff(owner) >= 0)  # contiguous per lane, in order
        t_om, j_om = divmod(N, S)
        assert t_om < threads and np.count_nonzero(owner == t_om) == j_om < S
        if N not in detailed and N % 97:
            continue
        for i, (down, up) in _kernel_partners(N, G, S, periodic).items():
            want_down = i - 1 if i else (N - 1 if periodic else "gl")
            want_up = i + 1 if i < N - 1 else (0 if periodic else "gr")
            for (got, route), want in ((down, want_down), (up, want_up)):
                assert got == want, (N, i, got, want)
                if route == "lane":
                    assert owner[got] == owner[i]
                elif route == "shuffle":
                    assert owner[got] // 32 == owner[i] // 32 and owner[got] != owner[i]
                elif route == "shared":
                    assert G > 1
                else:
                    assert route == "ghost" and not periodic


def test_kernel_parameters_mirror_the_cuda_struct():
    # 19 four-byte integer fields and 19 floats, in the order of csrc/chain_kernel.cu
    assert ctypes.sizeof(_build.ChainParams) == 38 * 4
    src = (_build._CSRC / "chain_kernel.cu").read_text()
    body = src[src.index("struct ChainParams {"):src.index("};", src.index("struct ChainParams {"))]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [n.strip() for n in decl.split(None, 1)[1].split(",")]
    assert names == [f for f, _ in _build.ChainParams._fields_]

    act = actions.get("double_well")
    s0 = langevin.init_chain_state(CFG, act, device="cpu")
    p = ck._params(s0, act, CFG, chain_offset=2**32 + 3, n_frames=4)
    assert (p.n_chains, p.n_sites, p.warps_per_chain, p.sites_per_lane,
            p.chains_per_block) == (8, 128, 3, 2, 1)
    assert (p.rounds, p.philox, p.loops, p.n_frames, p.step0, p.chain0) == (20, 0, 10, 4, 2, 3)
    hw = ck._params(s0, act, dataclasses.replace(CFG, rng_impl="hardware"), 0, 1)
    assert (hw.rounds, hw.philox) == (20, 1)
    assert (p.bc, p.background, p.has_zm, p.heun, p.action) == (1, 1, 1, 0, 1)
    assert p.dt == np.float32(0.05) and p.p1 == 24.0 and p.xcl_w == 2.5
    assert p.t_right == np.float32(128 * 0.05)


def test_unsupported_inputs_raise():
    act = actions.get(CFG.action)
    s0 = langevin.init_chain_state(CFG, act, device="cpu")

    @dataclasses.dataclass(frozen=True)
    class Custom(QMAction):
        def V(self, x):
            return x * x

    with pytest.raises(ValueError, match="Custom"):
        ck._action_constants(Custom())
    # the plain-path features stay refused by the kernels, as the Pallas ones refuse them
    for change, match in ((dict(scheme=Scheme.LM), "LM"), (dict(scheme=Scheme.EXACT), "EXACT"),
                          (dict(accumulate_spectrum=True), "spectrum")):
        bad = dataclasses.replace(CFG, **change)
        with pytest.raises(ValueError, match=match):
            ck.chain_frame(s0, act, bad)
        with pytest.raises(ValueError, match=match):
            ck.chain_frames_multi(s0, act, bad, 2)
        with pytest.raises(ValueError, match=match):
            ck.chain_frame_ref(s0, act, bad)
        with pytest.raises(ValueError, match=match):
            ck.run_frames_kernel(s0, act, bad, 1)
    # rng_impl='hardware' is the kernels' Philox variant: it runs, on another stream
    hw = dataclasses.replace(CFG, rng_impl="hardware")
    assert not torch.equal(ck.chain_frame(s0, act, hw).f, ck.chain_frame(s0, act, CFG).f)
    meta = langevin.ChainState(*(t if n == "step" else t.to("meta")
                                 for n, t in zip(s0._fields, s0)))
    with pytest.raises(ValueError, match="cuda"):
        ck.chain_frame(meta, act, CFG)


_DW = dict(action="double_well", dt=0.05, dtau=1e-3, loops=20, seed=21)
_ANH = dict(action="anharmonic", dt=0.25, dtau=0.01, loops=20, seed=22,
            bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,tripped,nan", [
    ("double_well_fixed_bg", dataclasses.replace(CFG, n_chains=32, loops=40), None, None),
    ("anharmonic_periodic_tf13", ChainConfig(
        action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=8, loops=20, seed=3,
        bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT,
        rng_impl="threefry13"), None, None),
    ("harmonic_dirichlet_heun", ChainConfig(
        action="harmonic", n_sites=96, dt=0.2, dtau=0.005, n_chains=8, loops=11, seed=4,
        bc=BoundaryCondition.DIRICHLET, formulation=Formulation.DIRECT, scheme=Scheme.HEUN),
     None, None),
    # the layout's edges: fewer sites than a warp, blocks of 4 one-warp chains with the
    # last part-filled; N no multiple of 32 S; the periodic wrap across warps; Heun
    # across warps; one chain tripping in a block whose others go on, one starting
    # with lrg_vl NaN
    ("layout_n20_part_filled_block", ChainConfig(**_DW, n_sites=20, n_chains=530), None, None),
    ("layout_n230_periodic", ChainConfig(**_ANH, n_sites=230, n_chains=16), None, None),
    ("layout_n1500_periodic_warps", ChainConfig(**_ANH, n_sites=1500, n_chains=8), None, None),
    ("layout_n700_heun_warps", ChainConfig(**_DW, n_sites=700, n_chains=8, scheme=Scheme.HEUN),
     None, None),
    ("layout_trip_and_nan_lrg_in_block", ChainConfig(**_DW, n_sites=40, n_chains=600), 3, 5),
])
def test_cuda_kernels_match_plain_versions(cuda_device, name, cfg, tripped, nan):
    """Kernel 1 + the PyTorch epilogue and kernel 2 against the plain version,
    with its own generator, the other Threefry variant and Philox."""
    others = {"threefry": "threefry13", "threefry13": "threefry"}
    for rng in (cfg.rng_impl, others[cfg.rng_impl], "hardware"):
        c = dataclasses.replace(cfg, rng_impl=rng)
        act = actions.get(c.action)
        s0 = langevin.init_chain_state(c, act, device=cuda_device)
        if tripped is not None:
            s0.lrg_vl[tripped] = 1e-6
            s0.lrg_vl[nan] = float("nan")
        plain, pm = ck.chain_frames_multi_ref(s0, act, c, 2)
        if tripped is not None:
            assert not pm["stable"][:, tripped].any() and pm["stable"].all(dim=0).sum() > 1
            assert torch.isnan(plain.lrg_vl[nan])
        before = (ck.chain_frame.launches, ck.chain_frames_multi.launches)
        k1, m1 = ck.run_frames_kernel(s0, act, c, 2)
        k2, m2 = ck.chain_frames_multi(s0, act, c, 2)
        torch.cuda.synchronize()
        assert ck.chain_frame.launches == before[0] + 2
        assert ck.chain_frames_multi.launches == before[1] + 1
        for got, gm in ((k1, m1), (k2, m2)):
            leaves = [*zip(got._fields, got, plain), *((k, gm[k], pm[k]) for k in pm)]
            for leaf, x, y in leaves:
                if leaf in ("runs", "stab_cnt", "step", "stable"):
                    assert torch.equal(x.cpu(), y.cpu()), (rng, leaf)
                elif x is not None:
                    torch.testing.assert_close(x, y, rtol=0, atol=2e-6, equal_nan=True,
                                               msg=f"{rng}:{leaf}")
        for x, y in zip((*k1, *m1.values()), (*k2, *m2.values())):  # bitwise
            if torch.is_tensor(x):
                torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
